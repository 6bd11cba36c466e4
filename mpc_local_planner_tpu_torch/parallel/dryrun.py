"""The multi-shard dry run and one rank of the multi-process run (the port's
counterpart of ``__graft_entry__.py::dryrun_multichip`` and of the JAX
package's two-process worker).

``dryrun_multichip(mesh, device)`` runs one sharded flagship solve over the
mesh and its ensemble summary, then three checks that sharding is
numerically transparent; it raises ``AssertionError`` at the first that
fails and returns what it measured.

One rank of a cluster::

    python -m mpc_local_planner_tpu_torch.parallel.dryrun --rank R \\
        --world-size W --coordinator HOST:PORT --device {cpu,cuda} \\
        [--batch 4096] [--N 30] [--slots 8] [--ensemble FILE.npz]

joins the process group (gloo on the CPU; on the card as
``distributed.initialize`` chooses), solves its ``process_local_batch`` of
the global flagship ensemble (``random_ensemble`` of seed 0, or the
scenarios of ``--ensemble``, an ``.npz`` whose keys are the ``Scenario``
field names, ``obstacles.<field>`` for the obstacle set's; its dtype is the
solve's) at ``CHECK_SETTINGS`` over its own mesh entries, all-reduces
``ensemble_summary`` over the group and prints one line
``RESULT rank=R {...}`` whose JSON (the summary, this rank's K1 and fused
launches, the world size and the backend) is the same on every rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time, random_ensemble
from mpc_local_planner_tpu_torch.convert import from_numpy
from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.parallel.sharding import (
    ensemble_summary,
    gather,
    make_sharded_solver,
    shard_batch,
)
from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings, default_init, make_solver
from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

# the cross-shard checks' bound on |Δxs| and |Δus| (dryrun_multichip's)
PRIMAL_TOL = 1e-4
# The budgets of the checks and of a rank's solve: the fleet cycle's rescue
# budget (4×4, ρ0 120, reg0 1, 1e-3 tolerances) and the early-exit
# composition at a 4×3 cap. ``__graft_entry__.py`` checks at 2×2 with the
# default tolerances and 4×2 early exit, at which no flagship lane converges
# from the straight-line seed, so that its flag checks compare false with
# false; at these about half the lanes converge.
CHECK_SETTINGS = SolverSettings(n_al=4, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3,
                                tol_ineq=1e-3)
EARLY_EXIT_SETTINGS = dataclasses.replace(CHECK_SETTINGS, n_sqp=3, early_exit=True)


def _ensemble(spec, batch, seed, device):
    scen = random_ensemble(spec, batch, torch.Generator().manual_seed(seed), device=device)
    return (scen, *default_init(spec, CHECK_SETTINGS, scen))


def _per_block(fn, n, *trees):
    """``fn`` on each of ``n`` contiguous lane blocks of ``trees``, the results
    concatenated."""
    lanes = trees[0].x0.shape[0]
    per = lanes // n
    outs = [fn(*(tree_map(lambda a, i=i: a[i * per:(i + 1) * per], t) for t in trees))
            for i in range(n)]
    return tree_map(lambda *a: torch.cat(a, dim=0), *outs)


def _flags_agree(tag, got, want):
    bad = int((got.cpu() != want.cpu()).sum())
    if bad:
        raise AssertionError(f"{tag}: conv flags differ on {bad}/{want.numel()} lanes")
    return int(want.sum())


def dryrun_multichip(mesh, device, spec=None, lanes_per_shard: int = 256,
                     check_lanes_per_shard: int = 32) -> dict:
    """Compile-and-run check of the sharded ensemble solve on ``mesh``.

    1. the flagship (``spec``, default N=30 with 8 circle slots) at a 1×1
       budget, ``lanes_per_shard`` lanes a shard, sharded, and its
       ``ensemble_summary``;
    2. at ``CHECK_SETTINGS`` on ``check_lanes_per_shard`` lanes a shard:
       the sharded solve against the unsharded one on ``device``, conv
       flags equal lane for lane and |Δxs|, |Δus| ≤ 1e-4;
    3. the per-shard rescue (a shard's block as its slots) against the
       unsharded solve followed by ``make_rescue`` on each block: flags equal;
    4. the early-exit serving composition (``EARLY_EXIT_SETTINGS``, the
       per-shard rescue) against its per-block reference: flags equal. A shard's
       early-exit loop stops at its own straggler count, so the primals may
       differ; the flags are the contract.
    """
    spec = spec or config3_carlike_min_time(N=30, obstacle_cap=8)
    device = torch.device(device)
    n = len(mesh.local_devices())
    out = {"mesh": mesh.shape, "shards": n}

    t0 = time.perf_counter()
    settings1 = SolverSettings(n_al=1, n_sqp=1)
    batch = lanes_per_shard * n
    scen, init, duals = _ensemble(spec, batch, 1, device)
    result = make_sharded_solver(spec, settings1, mesh)(*(shard_batch(t, mesh)
                                                          for t in (scen, init, duals)))
    out["summary"] = ensemble_summary(result)._asdict()
    if sum(r.primal.us.shape[0] for r in result.blocks) != batch:
        raise AssertionError("the sharded solve lost lanes")
    out["flagship_1x1_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    b2 = check_lanes_per_shard * n
    scen2, init2, duals2 = _ensemble(spec, b2, 2, device)
    sharded = gather(make_sharded_solver(spec, CHECK_SETTINGS, mesh)(scen2, init2, duals2),
                     device)
    plain = make_solver(spec, CHECK_SETTINGS, device)(scen2, init2, duals2)
    out["cross_shard_converged"] = _flags_agree("cross-shard", sharded.converged,
                                                plain.converged)
    for name in ("xs", "us"):
        err = float((getattr(sharded.primal, name) - getattr(plain.primal, name)).abs().max())
        out[f"cross_shard_max_abs_d{name}"] = err
        if not err <= PRIMAL_TOL:
            raise AssertionError(f"cross-shard {name} mismatch: max|diff|={err:.3e}")

    per_shard = b2 // n
    resc_sharded = gather(make_sharded_solver(spec, CHECK_SETTINGS, mesh,
                                              rescue_slots=per_shard)(scen2, init2, duals2),
                          device)
    resc = make_rescue(spec, CHECK_SETTINGS, per_shard, device=device)
    ref = _per_block(resc, n, scen2, plain)
    out["rescue_converged"] = _flags_agree("per-shard rescue", resc_sharded.converged,
                                           ref.converged)

    ee_sharded = gather(make_sharded_solver(spec, EARLY_EXIT_SETTINGS, mesh,
                                            rescue_slots=per_shard)(scen2, init2, duals2),
                        device)
    ee_plain = make_solver(spec, EARLY_EXIT_SETTINGS, device)(scen2, init2, duals2)
    resc_ee = make_rescue(spec, EARLY_EXIT_SETTINGS, per_shard, device=device)
    ee_ref = _per_block(resc_ee, n, scen2, ee_plain)
    out["early_exit_converged"] = _flags_agree("sharded early-exit composition",
                                               ee_sharded.converged, ee_ref.converged)
    out["checks_lanes"] = b2
    out["checks_s"] = time.perf_counter() - t0
    return out


def load_ensemble(path, device) -> Scenario:
    """The ``Scenario`` of an ``.npz`` keyed by field name
    (``obstacles.<field>`` for the obstacle set's)."""
    tree = {}
    with np.load(path) as data:
        for key in data.files:
            *outer, leaf = key.split(".")
            node = tree
            for part in outer:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return from_numpy(Scenario, tree, device)


def main(argv=None):
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda, riccati_cuda
    from mpc_local_planner_tpu_torch.parallel import distributed

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--coordinator", required=True, help="HOST:PORT of rank 0's rendezvous")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--batch", type=int, default=4096, help="the global batch")
    ap.add_argument("--N", type=int, default=30)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--ensemble", help=".npz of the global batch's scenarios")
    args = ap.parse_args(argv)

    backend = distributed.initialize(args.coordinator, args.world_size, args.rank,
                                     backend="gloo" if args.device == "cpu" else None)
    try:
        if args.device == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            device = torch.device("cpu")
        spec = config3_carlike_min_time(N=args.N, obstacle_cap=args.slots)
        if args.ensemble:
            scen = load_ensemble(args.ensemble, device)
        else:
            scen = random_ensemble(spec, args.batch, torch.Generator().manual_seed(0),
                                   device=device)
        init, duals = default_init(spec, CHECK_SETTINGS, scen, dtype=scen.x0.dtype)
        global_batch = scen.x0.shape[0]
        sl = distributed.process_local_batch(global_batch)
        local = [tree_map(lambda a: a[sl], t) for t in (scen, init, duals)]
        mesh = distributed.global_mesh(local_devices=[device])
        riccati_cuda.lqr_solve_cuda.launches = 0
        fused_al_sqp_cuda.fused_solve_cuda.launches = 0
        result = make_sharded_solver(spec, CHECK_SETTINGS, mesh)(*local)
        summary = ensemble_summary(result)
        line = {**summary._asdict(), "k1_launches": riccati_cuda.lqr_solve_cuda.launches,
                "fused_launches": fused_al_sqp_cuda.fused_solve_cuda.launches,
                "world_size": args.world_size, "global_batch": global_batch,
                "backend": backend}
        print(f"RESULT rank={args.rank} {json.dumps(line, sort_keys=True)}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
