#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mpc_local_planner_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):
  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA versions
  2. build   — nvcc builds kernel K1 (csrc/riccati_sweep.cu) and each
               group of the fused kernel's instantiations that the smoke
               launches (csrc/fused_al_sqp.cu: one library per working type,
               model, objective family, grid and collocation family, five
               instantiations each; 16 of the 96) into _build/, all at
               once; each build's seconds and the phase's wall time
  3. kernel  — K1 against its plain PyTorch version on the Riccati inputs of
               one real flagship SQP iteration (B=4096 and 1024, N=30, and
               B=4096 at N=96, past the cap K1 once had), in float64 and
               float32; kernel, plain and bound times (the kernel timed
               around the wrapper's call and on the device alone, behind a
               busy-wait), its launch geometry held to the library's and
               its blocks per SM
  4. main    — the flagship warm fleet cycle on the un-fused path
               (fused="off"), as bench.py::main drives it: config3 (N=30, 8
               circle slots), 4096 lanes, cold 16×15 solve, 2 settle + 8
               timed warm cycles (3×4, 3 candidates) with the 1024-slot 4×4
               rescue (8 candidates), then the cold oracle; K1 must carry
               every SQP iteration (760 launches)
  5. gate    — the warm solve with K1 against the same solve with the plain
               KKT solve, on 256 lanes of the live warm state
  6. trace   — one un-fused warm cycle under torch.profiler: device kernel
               time, K1's share, the device's busy share
  7. K2a     — K2a against its plain version on the live warm state: 4096
               lanes at 3×4 (3 candidates) and 1024 lanes at 4×4 (8
               candidates), float64 at every prefix of the schedule and
               float32; kernel, plain and bound times
  8. fused   — the same main path with fused="auto" from the same cold solve:
               the warm solve and the rescue run as one K2a launch each (20
               launches), K1 only for the oracle (240)
  9. gate    — the fused warm solve (K2a) against the un-fused one (AD
               derivatives + K1) on 256 lanes of the live warm state
 10. trace   — one fused warm cycle under torch.profiler
 11. K1      — K1 against its plain version without the free δτ
               (free_tau=False), on BASELINE config #2's Riccati inputs
               (B=4096), float64 and float32
 12. config2 — the warm fleet cycle of BASELINE config #2 (unicycle, disc
               r=0.2, 10 circle slots, quadratic form with Qf, terminal
               ball, fixed dt 0.3, N=30) with fused="auto": cold 8×10 solve
               (un-fused, K1), 2 settle + 8 timed warm cycles (3×4) with the
               1024-slot 4×4 rescue, the cold oracle; the fused kernel must
               carry the warm solve and the rescue (20 launches), K1 the
               cold solve and the oracle (160)
 13. kernel  — the fused kernel against its plain version on config #2's
               live warm state, as phase 7 does for the flagship
 14. family  — the kernel against its plain version (float64 at every
               prefix, float32) at B=1024 for the flagship with the
               front-wheel car and with the kinematic bicycle, and for
               config #1 (no obstacle slot, integral left-sum), each from
               its own cold solve (the fused kernel's, at the cold preset)
               and two fused fleet cycles; run last, with phase 23
 15. gate    — config #2's fused warm solve against the un-fused one, 256
               lanes of its live warm state
 16. trace   — one config #2 warm cycle under torch.profiler
 17. path A  — the reference's car-like config (family_spec
               "canonical_carlike": the simple car with the two-disc
               footprint, 8 circle slots, minimum time) on the fused path as
               bench.py's families mode runs it: cold 16×15 (un-fused, K1),
               2 settle + 8 timed warm cycles (3×4) with the 1024-slot 4×4
               rescue, the cold oracle; 20 fused launches, 480 of K1, none
               in the warm cycles
 18. kernel  — the fused kernel against its plain version on path A's live
               warm state (4096 lanes at 3×4, 1024 at 4×4)
 19. gate    — path A's fused warm solve against the un-fused one; trace
 20. path B  — the wall world (family_spec "converter_lines": the flagship
               disc, 6 line slots from the wall sampler) at the family's
               shipping defaults but the straight-line seed: warm 4×4, the
               2048-slot 4×4 rescue chained twice per cycle, stuck_restart=2;
               30 fused launches (3 per cycle), 480 of K1
 21. kernel  — the fused kernel against its plain version on path B's live
               warm state (4096 lanes at 4×4, the 2048-slot rescue)
 22. gate    — path B's fused warm solve against the un-fused one; trace
 23. K2c     — the kernel against its plain version at B=1024 (float64 at
               every prefix, float32; kernel, plain and bound times) on
               polygon slots with a varying vertex count, dynamic circle and
               line slots, all four families with the two-disc footprint and
               dynamic obstacles, the kinematic bicycle with the two-disc
               footprint, and all four families moving with a line footprint
               and with a polygon footprint; and (K2d, the caps lifted)
               ordered via points with an orientation weight and masked
               slots, path A's spec with 30 obstacle slots (the example
               configs' capacity, 8 obstacles in them) and the flagship at
               N=80; and (K2f) the non-uniform grid under config #2's
               integral trapezoidal form and under the mixed-dynamic case;
               and (K2b, K2e) the flagship with midpoint differences, on
               the shooting_rk4 grid and on the shooting_rk7_2 grid (rk7's
               11 stages at 2 substeps, the most the kernel takes);
               each from its own cold solve (the fused kernel's, at the
               cold preset: one launch where the un-fused solve is host-bound
               for tens of seconds) and two fused fleet cycles. The
               seventeen cases of phases 14 and 23 run in the last phase,
               each in a process of its own (``chip_smoke.py
               --family-case NAME``); then each is timed alone
 24. path C  — the polygon-footprint family (family_spec "polygon_footprint":
               the simple car with a 0.5 × 0.3 m rectangle, 8 circle slots,
               minimum time) as bench.py's families mode runs it: cold 16×15
               (un-fused, K1), 2 settle + 8 timed warm cycles (3×4) with the
               1024-slot 4×4 rescue, the cold oracle; 20 fused launches, 480
               of K1, none in the warm cycles; run after path B
 25. kernel  — the fused kernel against its plain version on path C's live
               warm state (4096 lanes at 3×4, 1024 at 4×4)
 26. gate    — path C's fused warm solve against the un-fused one; trace
 27. path D  — the via-points family (family_spec "via_points": the flagship
               with 4 corridor via points, position weight 2, unordered,
               8 circle slots) as bench.py's families mode runs it: cold
               16×15 (un-fused, K1), 2 settle + 8 timed warm cycles (3×4)
               with the 1024-slot 4×4 rescue, the cold oracle; 20 fused
               launches, 480 of K1, none in the warm cycles; run after path C
 28. kernel  — the fused kernel against its plain version on path D's live
               warm state (4096 lanes at 3×4, 1024 at 4×4)
 29. gate    — path D's fused warm solve against the un-fused one; trace
 30. path E  — the non-uniform family (family_spec "nonuniform": the
               flagship with a per-stage dt, the kernel's K2f branch) as
               bench.py's families mode runs it: cold 16×15 and the cold
               oracle un-fused, their KKT solves the plain lqr_solve (δdt_k
               a third control column: no K1 launch), 2 settle + 8 timed
               warm cycles (3×4) with the 1024-slot 4×4 rescue; 20 fused
               launches, 0 of K1; run after path D
 31. kernel  — the fused kernel against its plain version on path E's live
               warm state (4096 lanes at 3×4, 1024 at 4×4)
 32. gate    — path E's fused warm solve against the un-fused one; trace
 33. path F  — the Crank–Nicolson flagship (the flagship's spec with
               ``collocation="crank_nicolson_differences"``: the kernel's
               K2b branch, the −E⁻¹ fold) as the flagship runs: cold 16×15
               (un-fused, K1), 2 settle + 8 timed warm cycles (3×4) with the
               1024-slot 4×4 rescue, the cold oracle; 20 fused launches, 480
               of K1, none in the warm cycles; run after path E
 34. kernel  — the fused kernel against its plain version on path F's live
               warm state (4096 lanes at 3×4, 1024 at 4×4)
 35. gate    — path F's fused warm solve against the un-fused one; trace
 last    — the float64 checks of phases 7, 13, 18, 21, 25, 28, 31 and
               34 at every prefix of the schedule (each of those phases
               saves its warm inputs and runs the float32 check and the
               times at once) and the B=1024 cases of phases 14 and 23:
               33 processes, at most 17 at once (``last_phase``)
 36. summary — the seconds of the build, of each path and of the last
               phase (``smoke_split_s``), the kernels line, the card line,
               then the result line

Needs a CUDA card; without one (or without the package beside it) it exits
non-zero before printing any result.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import resource
import statistics
import subprocess
import sys
import time

BATCH = 4096
RESCUE_SLOTS = 1024
LINES_RESCUE_SLOTS = 2048  # the wall world's rescue (bench.py families mode)
GATE_LANES = 256
SETTLE_CYCLES = 2
TIMED_CYCLES = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# Errors are max |kernel − plain| over the step, relative to the step's
# largest entry. f64: the two versions do the same arithmetic in another
# order, so they agree to a few ulps (1e-15 measured on an H100).
K1_RTOL_F64 = 1e-9
# f32: the 30-stage backward recursion amplifies f32 rounding (6e-8); both
# versions sit about 1e-6 from the f64 answer on these inputs (H100).
K1_RTOL_F32 = 1e-4
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
# The fused kernel against its plain version in float64
# (solvers/agreement.py): conv flags identical on every lane; max relative
# |Δ| over xs, us, dt and the duals within 1e-8 on 99.5% of the lanes both
# converged with no tie shown; and on every lane at most 100 times the plain
# version's own change under rounding. A lane that the plain version
# leaves elsewhere when it takes its near-ties of the line search, the
# growth test and the clip of a dt within rounding of its bound the other
# way (a tie shown) is held to 100 times the larger of the two changes, its
# ρ to one growth factor. The check
# runs at every prefix of the solve's schedule (1×1, 1×2, then whole AL
# phases), so a lane is held tight before its rounding can grow; a lane
# whose own change passes 1e-6 (a chaotic lane) is counted and left out of
# it, but at 1×1 every lane is held, and none beyond 1e-4
# (agreement.EVERY_LANE_CAP). The plain version's own change is its largest
# under a one-ulp change of its states and under one ulp on each entry of
# its per-iteration KKT inputs, the rounding by which the kernel's
# derivatives differ from it.


def _fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# the fused kernel's launches by collocation rule, summed over the main paths'
# runs (``reset_counts`` before each, ``rule_counts`` after it)
RULE_LAUNCHES = collections.Counter()


def reset_counts():
    """Set every kernel's launch counts to 0, just before a main path."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    riccati_cuda.lqr_solve_cuda.launches = 0
    k2a.fused_solve_cuda.launches = 0
    k2a.fused_solve_cuda.launches_by_rule.clear()


def rule_counts():
    """The fused kernel's launches by collocation rule since ``reset_counts``,
    just after a main path; added to RULE_LAUNCHES."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a

    counts = dict(k2a.fused_solve_cuda.launches_by_rule)
    RULE_LAUNCHES.update(counts)
    return counts


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def flagship(N=30, obstacle_cap=8):
    """The flagship problem and bench.py::main's solver settings."""
    from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time

    return fleet_settings(config3_carlike_min_time(N=N, obstacle_cap=obstacle_cap))


K1_LONG_N = 96  # phase 3's horizon past K1's old cap of 64


def fleet_settings(spec):
    """``spec`` with bench.py::main's settings: the cold preset, the warm
    3×4 solve (fused="off") and the 4×4 rescue with 8 candidates."""
    from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings

    cold = SolverSettings.for_spec(spec)
    warm = SolverSettings(
        n_al=3, n_sqp=4, rho0=120.0, rho_growth=5.0, reg0=1.0,
        tol_eq=1e-3, tol_ineq=1e-3, alphas=(1.0, 0.5, 0.22), fused="off",
    )
    rescue = dataclasses.replace(
        warm, n_al=4, n_sqp=4,
        alphas=(1.0, 0.7, 0.5, 0.35, 0.22, 0.14, 0.08, 0.03),
    )
    return spec, cold, warm, rescue


def config2():
    """BASELINE config #2 at its full width and depth (N=30, 10 circle
    slots)."""
    from mpc_local_planner_tpu_torch.benchmarks import config2_diffdrive_obstacles

    return config2_diffdrive_obstacles(N=30, obstacle_cap=10)


def ensemble(spec, batch, device, seed=0, family=None):
    """``random_ensemble``, or ``family_ensemble`` of a named family."""
    import torch

    from mpc_local_planner_tpu_torch.benchmarks import family_ensemble, random_ensemble

    gen = torch.Generator().manual_seed(seed)
    if family is not None:
        return family_ensemble(family, spec, batch, gen, dtype=torch.float32, device=device)
    return random_ensemble(spec, batch, gen, dtype=torch.float32, device=device)


def riccati_inputs(spec, settings, scen):
    """The K1 inputs of the first SQP iteration from the straight-line seed
    (the state of a reset lane) under ``settings``."""
    import torch

    from mpc_local_planner_tpu_torch.solvers import al_sqp

    init, duals = al_sqp.default_init(spec, settings, scen)
    obs_k = al_sqp._stage_obstacles(spec, scen, init.dt, spec.N + 1)
    kkt = al_sqp._kkt_system(
        spec, al_sqp._make_stage_fns(spec), al_sqp._make_terminal_fns(spec),
        init, scen, duals, obs_k,
    )
    reg = torch.full_like(init.dt, settings.reg0)
    return kkt + (reg,)


def _cuda_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps=20, rounds=5):
    """The device time of one call of ``fn``, the host's share hidden: each
    round queues ``reps`` calls behind a busy-wait kernel on the stream and
    times them between CUDA events recorded after the wait, so that the
    device runs them back to back; the median of ``rounds`` rounds. The wait
    is lengthened until it outlasts the queueing (``fused_probe.py`` has the
    same function, for trees without this one)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles, per = 2_000_000, []
    while len(per) < rounds:
        gate = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        gate.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        hidden = not gate.query()  # still waiting when the last call was queued
        torch.cuda.synchronize()
        if hidden:
            per.append(start.elapsed_time(end) / reps)
        elif cycles > 2_000_000_000:
            _fail("the host did not queue the timed calls within the wait")
        else:
            cycles *= 4
    return statistics.median(per)


def _max_rel_err(a, b):
    """max |a − b| over the step, relative to the step's largest entry."""
    import torch

    errs, scale = [], []
    for x, y in zip(a, b):
        errs.append(torch.max(torch.abs(x.double() - y.double())).item())
        scale.append(torch.max(torch.abs(y.double())).item())
    return max(errs), max(errs) / max(max(scale), 1e-30)


def kernel_phase(spec, warm, device, batches=(BATCH, RESCUE_SLOTS), tag="K1"):
    """K1 against the plain lqr_solve at ``batches``, on the inputs of a
    warm-settings SQP iteration (reg = 1), with the free δτ where ``spec``
    has a variable dt. The cold solve's first iteration (reg = 1e-6 at the
    seed) overflows float32 in both versions alike, which the solver's NaN
    quarantine absorbs."""
    import torch

    from mpc_local_planner_tpu_torch.ops import riccati_cuda
    from mpc_local_planner_tpu_torch.solvers.riccati import lqr_solve

    report = {}
    for batch in batches:
        args32 = riccati_inputs(spec, warm, ensemble(spec, batch, device))
        kw = dict(nx=spec.nx, free_tau=spec.variable_dt)
        row = {}
        for name, args in (("f64", tuple(a.double() for a in args32)), ("f32", args32)):
            out_k = riccati_cuda.lqr_solve_cuda(*args, **kw)
            out_p = lqr_solve(*args, **kw)
            torch.cuda.synchronize()
            abs_err, rel_err = _max_rel_err(out_k, out_p)
            tol = K1_RTOL_F64 if name == "f64" else K1_RTOL_F32
            finite = all(bool(torch.isfinite(t).all()) for t in out_k)
            print(
                f"{tag} {name} B={batch} free_tau={kw['free_tau']}: max_abs_err={abs_err:.3e} "
                f"rel_err={rel_err:.3e} (tol {tol:g}) finite={finite}"
            )
            if not finite or not rel_err <= tol:
                _fail(f"K1 disagrees with its plain version ({name}, B={batch})")
            row[f"max_abs_err_{name}"] = abs_err
            row[f"rel_err_{name}"] = rel_err
        nbytes = sum(a.numel() * a.element_size() for a in args32)
        nbytes += sum(t.numel() * t.element_size() for t in out_k)
        row["bytes"] = nbytes
        row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        row["ms"] = _cuda_ms(lambda: riccati_cuda.lqr_solve_cuda(*args32, **kw), 25)
        row["device_ms"] = _device_ms(lambda: riccati_cuda.lqr_solve_cuda(*args32, **kw))
        row["plain_ms"] = _cuda_ms(lambda: lqr_solve(*args32, **kw), 5)
        N = spec.N
        geo = riccati_cuda.library_geometry(riccati_cuda._load(), N, torch.float32)
        if geo != riccati_cuda.launch_geometry(N, torch.float32, riccati_cuda.DESIGN):
            _fail(f"K1's library geometry {geo} differs from launch_geometry at N={N}")
        row["geometry"] = geo._asdict()
        row["blocks_per_sm"] = riccati_cuda.occupancy(riccati_cuda._load(), N, torch.float32)
        print(
            f"{tag} f32 B={batch}: kernel {row['ms']:.4f} ms (the wrapper's call), "
            f"{row['device_ms']:.4f} ms (device), plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({nbytes} B at {HBM_BYTES_PER_S:.3g} B/s); "
            f"{json.dumps(row['geometry'])}, {row['blocks_per_sm']} blocks per SM"
        )
        report[batch] = row
    return report


def main_path(spec, cold, warm, rescue_set, device, cold_start=None, batch=BATCH,
              slots=RESCUE_SLOTS, family=None, chain=1, stuck_restart=0):
    """bench.py::main on the port (families mode for a named ``family``:
    its ensemble, the rescue chained ``chain`` times per cycle, the
    stuck-lane restart). ``cold_start`` = (scenarios, cold result) skips
    the cold solve. Returns (extra, settled state, seconds, one cycle from
    the settled state, the cold start, K1's launch count after the timed
    cycles)."""
    import torch

    from mpc_local_planner_tpu_torch.ocp.grid import initial_primal
    from mpc_local_planner_tpu_torch.ops import riccati_cuda
    from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle
    from mpc_local_planner_tpu_torch.solvers.al_sqp import init_duals, make_solver
    from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    duals0 = init_duals(spec, cold, dtype=torch.float32, device=device, batch=(batch,))
    cold_solve = make_solver(spec, cold, device)
    rescue1 = make_rescue(spec, warm, slots, rescue_settings=rescue_set, device=device)

    def rescue(scen, r):
        for _ in range(chain):
            r = rescue1(scen, r)
        return r

    cycle = make_fleet_cycle(spec, warm, duals0, rescue=rescue, device=device,
                             stuck_restart=stuck_restart)
    stuck = torch.zeros((batch,), dtype=torch.int32, device=device)

    def run(scen, r):
        nonlocal stuck
        if not stuck_restart:
            return cycle(scen, r)
        scen, r, stuck = cycle(scen, r, stuck)
        return scen, r

    secs = {}
    if cold_start is None:
        scen = ensemble(spec, batch, device, family=family)
        t0 = time.perf_counter()
        r = cold_solve(scen, initial_primal(spec, scen), duals0)
        sync()
        secs["cold_solve_s"] = time.perf_counter() - t0
        cold_start = (scen, r)
    scen, r = cold_start
    for _ in range(SETTLE_CYCLES):
        scen, r = run(scen, r)
    sync()
    settled = (scen, r)
    stuck_settled = stuck

    def one_cycle(scen_, r_):
        """One cycle from the settled state's stuck counts."""
        if not stuck_restart:
            return cycle(scen_, r_)
        return cycle(scen_, r_, stuck_settled)[:2]

    t0 = time.perf_counter()
    for _ in range(TIMED_CYCLES):
        scen, r = run(scen, r)
    n_conv = int(torch.sum(r.converged))  # host fetch ends the chain
    dt = (time.perf_counter() - t0) / TIMED_CYCLES
    k1_after_cycles = riccati_cuda.lqr_solve_cuda.launches
    t0 = time.perf_counter()
    oracle = cold_solve(scen, initial_primal(spec, scen), duals0)
    feas = oracle.converged
    sync()
    secs["oracle_s"] = time.perf_counter() - t0
    n_feas = int(torch.sum(feas))
    extra = {
        "batch": batch,
        "cycle_ms": dt * 1e3,
        "total_solves_per_s": batch / dt,
        "warm_iterations": warm.n_al * warm.n_sqp,
        "converged_frac": n_conv / batch,
        "feasible_frac_cold_oracle": n_feas / batch,
        "conv_on_feasible": int(torch.sum(r.converged & feas)) / max(n_feas, 1),
    }
    return extra, settled, secs, one_cycle, cold_start, k1_after_cycles


def warm_inputs(spec, warm, settled, n):
    """The next warm solve's inputs (advanced scenarios, resampled primal,
    shifted duals) for the first ``n`` lanes of a live warm state, as
    bench.py's gate builds them."""
    import torch

    from mpc_local_planner_tpu_torch.core.tree import tree_map
    from mpc_local_planner_tpu_torch.ocp.grid import warm_start_resample
    from mpc_local_planner_tpu_torch.solvers.al_sqp import shift_duals

    scen, r = settled
    take = lambda t: tree_map(lambda a: a[:n].contiguous(), t)  # noqa: E731
    x0n = torch.where(r.converged[:, None], r.primal.xs[:, 1, :], scen.x0)
    return (
        dataclasses.replace(take(scen), x0=x0n[:n]),
        take(warm_start_resample(r.primal, x0n, steps=1, spec=spec)),
        take(shift_duals(r.duals, warm, steps=1)),
    )


def gate_phase(spec, reference, candidate, settled, n=GATE_LANES):
    """bench.py's kernel-vs-reference gate on the live warm state: the warm
    solve under ``candidate`` settings against the same solve under
    ``reference``."""
    from mpc_local_planner_tpu_torch.solvers import agreement
    from mpc_local_planner_tpu_torch.solvers.al_sqp import make_solver

    scen_g, init_g, dn_g = warm_inputs(spec, reference, settled, n)
    dev = scen_g.x0.device
    out_k = make_solver(spec, candidate, dev)(scen_g, init_g, dn_g)
    out_p = make_solver(spec, reference, dev)(scen_g, init_g, dn_g)
    return agreement.gate(out_k, out_p, candidate.n_al * candidate.n_sqp)


def schedule_prefixes(st):
    """Budgets (n_al, n_sqp) that run the first iterations of ``st``'s
    schedule: one SQP iteration, two, then each whole AL phase; the last is
    ``st``'s own."""
    prefixes = [(1, 1), (1, 2)] + [(a, st.n_sqp) for a in range(1, st.n_al + 1)]
    return sorted(set(prefixes), key=lambda b: (b[0], b[1]))


def k2a_f64_phase(spec, st, args64, tag, floor=0.25):
    """K2a against its plain version in float64 at every prefix of ``st``'s
    schedule (``agreement.f64_agreement``, every lane at 1×1, at least
    ``floor`` of the lanes converged on both after the whole schedule);
    prints one line per prefix and the error of the lane that ends furthest
    apart at each prefix."""
    import torch

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.solvers import agreement

    scen, init, duals = args64
    rows = []
    prefixes = schedule_prefixes(st)
    for n_al, n_sqp in prefixes:
        sp = dataclasses.replace(st, n_al=n_al, n_sqp=n_sqp)
        last, first = (n_al, n_sqp) == (st.n_al, st.n_sqp), (n_al, n_sqp) == (1, 1)
        out_k = k2a.fused_solve_cuda(spec, sp, scen, init, duals)
        out_p = k2a.fused_solve_plain(spec, sp, scen, init, duals)
        plain = lambda i, **kw: k2a.fused_solve_plain(spec, sp, scen, i, duals, **kw)  # noqa: E731,B023
        outs_q, outs_r, outs_t = agreement.plain_runs(plain, init)
        outs_s = agreement.spread_runs(plain, init) if first else ()
        torch.cuda.synchronize()
        respread = agreement.lane_spread(
            lambda s, i, d, **kw: k2a.fused_solve_plain(spec, sp, s, i, d, **kw),  # noqa: B023
            scen, init, duals)
        info, passed, err, sens = agreement.f64_agreement(
            out_k, out_p, outs_q, outs_t, sp.rho_growth,
            min_converged_frac=floor if last else 0.0, every_lane=first,
            outs_r=outs_r, outs_spread=outs_s, respread=respread,
        )
        print(f"{tag} f64 at {n_al}x{n_sqp}: {json.dumps(info)} passed={passed}")
        if not passed:
            _fail(f"the fused kernel disagrees with its plain version in float64 "
                  f"({tag} at {n_al}x{n_sqp})")
        rows.append(((n_al, n_sqp), err, sens))
    worst = int(torch.argmax(rows[-1][1]))
    trail = ", ".join(f"{a}x{s} {float(e[worst]):.3e} ({float(q[worst]):.3e})"
                      for (a, s), e, q in rows)
    print(f"{tag} f64 lane {worst}, its error at each prefix (plain version's "
          f"one-ulp sensitivity): {trail}")


def _double(args32):
    from mpc_local_planner_tpu_torch.core.tree import tree_map

    return tuple(
        tree_map(lambda a: a.double() if a.is_floating_point() else a, t) for t in args32
    )


def k2a_check(spec, st, args32, tag, floor=0.25):
    """The fused kernel against its plain version on one set of warm inputs:
    float64 at every prefix of the schedule, then float32 at bench-gate
    semantics, each with at least ``floor`` of the lanes converged on both
    after the whole schedule. Returns the gate's info."""
    k2a_f64_phase(spec, st, _double(args32), tag, floor)
    return k2a_f32_check(spec, st, args32, tag, floor)


def k2a_f32_check(spec, st, args32, tag, floor=0.25):
    """``k2a_check``'s float32 part: bench.py's gate. Returns its info."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.solvers import agreement

    out_k = k2a.fused_solve_cuda(spec, st, *args32)
    out_p = k2a.fused_solve_plain(spec, st, *args32)
    info, passed = agreement.gate(out_k, out_p, st.n_al * st.n_sqp, floor)
    print(f"{tag} f32: {json.dumps(info)} passed={passed}")
    if not passed:
        _fail(f"the fused kernel disagrees with its plain version in float32 ({tag})")
    return info


def k2a_times(spec, st, args32, info, tag):
    """The fused kernel's float32 times on ``args32`` (CUDA events, median
    of 25 launches; the plain version's of 3 calls) beside its bound (the
    bytes it moves over the memory rate, its operations, ``k2a_flops`` on
    this run's slot families and polygon edges, over the float32 peak);
    prints them and returns the row."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a

    batch = args32[0].x0.shape[0]
    ins, outs = k2a.kernel_io(spec, *args32)
    nbytes = sum(a.numel() * a.element_size() for a in ins + outs)
    flops = batch * k2a.k2a_flops(spec, st.n_al, st.n_sqp, len(st.alphas), args32[0].obstacles,
                                  args32[0].via_mask)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    row = {
        "max_abs_err": info["max_dxs_on_converged"],
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "ms": _cuda_ms(lambda: k2a.fused_solve_cuda(spec, st, *args32), 25),
        "plain_ms": _cuda_ms(lambda: k2a.fused_solve_plain(spec, st, *args32), 3),
    }
    print(
        f"{tag} f32: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({nbytes} B, {flops} FLOP)"
    )
    return row


class F64Checks:
    """The main paths' float64 checks (``k2a_f64_phase``), their warm inputs
    saved as each path makes them and run at the end, each in a process of
    its own beside the B=1024 cases (``last_phase``): host-bound, they
    would run one after the other here; the host has cores to spare."""

    def __init__(self):
        import tempfile

        self.dir = tempfile.TemporaryDirectory()
        self.jobs = []

    def add(self, spec, st, args32, tag, floor=0.25):
        import torch

        path = f"{self.dir.name}/f64_{len(self.jobs)}.pt"
        torch.save({"spec": spec, "st": st, "args": args32, "tag": tag, "floor": floor}, path)
        self.jobs.append((tag, [sys.executable, __file__, "--f64-check", path]))


def k2a_phase(spec, warm, rescue_set, settled, checks, name="K2a", slots=RESCUE_SLOTS):
    """The fused kernel against its plain version on the live warm state:
    the next warm solve's inputs at 4096 lanes under ``warm`` and at
    ``slots`` lanes with the rescue's settings, in float32 here, in float64
    at every prefix of the schedule with ``checks`` at the end; kernel,
    plain and bound times (``k2a_times``)."""
    report = {}
    for batch, st in ((BATCH, warm), (slots, rescue_set)):
        args32 = warm_inputs(spec, st, settled, batch)
        tag = f"{name} B={batch} {st.n_al}x{st.n_sqp}"
        checks.add(spec, st, args32, tag)
        report[batch] = k2a_times(spec, st, args32, k2a_f32_check(spec, st, args32, tag), tag)
    return report


def model_cases():
    """Phase 14's specs: the flagship with the front-wheel car and with the
    kinematic bicycle, and config #1 (no obstacle slot, point footprint,
    integral left-sum)."""
    from mpc_local_planner_tpu_torch.benchmarks import (
        config1_unicycle_quadratic,
        config3_carlike_min_time,
    )
    from mpc_local_planner_tpu_torch.systems.models import (
        KinematicBicycleModelVelocityInput,
        SimpleCarFrontWheelDrivingModel,
    )

    car = config3_carlike_min_time(N=30, obstacle_cap=8)
    return (
        ("front-wheel", dataclasses.replace(car, model=SimpleCarFrontWheelDrivingModel(0.5)), None),
        ("bicycle", dataclasses.replace(car, model=KinematicBicycleModelVelocityInput(0.3, 0.2)),
         None),
        ("config1", dataclasses.replace(config1_unicycle_quadratic(N=20), integral_form=True),
         None),
    )


def k2c_cases():
    """Phase 23's specs and slot mixes (``benchmarks.mixed_obstacles``, as
    the JAX package's tests/test_fused_solver.py draws them): polygon slots
    with a varying vertex count, dynamic circle and line slots, all four
    families with the canonical two-disc footprint and dynamic obstacles,
    the kinematic bicycle with the two-disc footprint (8 circle slots,
    ``random_ensemble``), and all four families moving with the JAX tests'
    line footprint and with the polygon-footprint family's rectangle."""
    from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time, family_spec
    from mpc_local_planner_tpu_torch.geometry.footprints import (
        CircularFootprint,
        LineFootprint,
    )
    from mpc_local_planner_tpu_torch.systems.models import KinematicBicycleModelVelocityInput

    def car(footprint, dynamic=False, **slots):
        M = sum(slots.get(k, 0) for k in ("mp", "mc", "ml", "mg"))
        spec = dataclasses.replace(config3_carlike_min_time(N=30, obstacle_cap=M),
                                   footprint=footprint, enable_dynamic_obstacles=dynamic)
        return spec, dict(slots, dynamic=dynamic)

    two = family_spec("canonical_carlike", N=30).footprint
    return (
        ("polygons", *car(CircularFootprint(0.15), mc=1, mg=2, V=5, vary_nv=True)),
        ("lines-dynamic", *car(CircularFootprint(0.2), True, mc=2, ml=3)),
        ("mixed-dynamic", *car(two, True, mp=1, mc=2, ml=2, mg=1, V=4)),
        ("bicycle-two-circles", dataclasses.replace(
            family_spec("canonical_carlike", N=30),
            model=KinematicBicycleModelVelocityInput(0.3, 0.2)), None),
        ("line-footprint-mixed-dynamic", *car(LineFootprint((-0.1, 0.0), (0.35, 0.0)), True,
                                              mp=1, mc=2, ml=2, mg=1, V=4)),
        ("polygon-footprint-mixed-dynamic", *car(family_spec("polygon_footprint").footprint,
                                                 True, mp=1, mc=2, ml=2, mg=1, V=4)),
    )


def family_case(name, save=None, batch=RESCUE_SLOTS):
    """One case of phases 14 and 23: the fused kernel against its plain
    version on ``family_state``'s warm inputs (at least a quarter of the
    lanes converged on both, or the case's ``CONVERGED_FLOOR``); with
    ``save``, the inputs and the float32 check's info go to that file for
    ``last_phase`` to time."""
    import torch

    spec, warm, args32 = family_state(name, batch)
    info = k2a_check(spec, warm, args32, f"{name} B={batch} {warm.n_al}x{warm.n_sqp}",
                     CONVERGED_FLOOR.get(name, 0.25))
    if save is not None:
        torch.save({"args": args32, "info": info}, save)


def k2d_cases():
    """The B=1024 cases of via points and of the caps lifted (K2d, F1, F3):
    the JAX package's fused-kernel via ensemble (``tests/test_fused_solver.py``:
    3 slots uniform in [0.2, 2]³, about 30% masked) ordered with an
    orientation weight, path A's spec with 30 obstacle slots, as every
    ``examples/cfg/*.yaml`` sets ``obstacle_capacity: 30`` (its 8 obstacles
    in them, the rest masked), and the flagship at N=80."""
    from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time, family_spec

    via = dataclasses.replace(
        config3_carlike_min_time(N=30, obstacle_cap=8), objective="minimum_time_via_points",
        via_cap=3, via_position_weight=2.0, via_orientation_weight=0.5, via_points_ordered=True)
    return (
        ("via-ordered-orientation", via, "random_via"),
        ("carlike-30-slots", dataclasses.replace(family_spec("canonical_carlike", N=30),
                                                 obstacle_cap=30), "8_obstacles"),
        ("flagship-N80", config3_carlike_min_time(N=80, obstacle_cap=8), None),
    )


def k2f_cases():
    """The B=1024 cases of the non-uniform grid (K2f): config #2 with the
    integral trapezoidal form, hybrid weight 0.4 and a variable per-stage dt
    in [1e-3, 0.5] (the spec of the JAX package's
    ``tests/test_fused_solver.py::test_fused_nonuniform_trapezoidal_quadratic_matches_xla``
    at N=30: the dt_{k-1} coupling row), and ``mixed-dynamic`` on the grid
    (the cumulative prediction times under ``GEO_ALL``)."""
    from mpc_local_planner_tpu_torch.benchmarks import config2_diffdrive_obstacles

    trap = dataclasses.replace(
        config2_diffdrive_obstacles(N=30, obstacle_cap=10), integral_form=True,
        cost_integration="trapezoidal", hybrid_time_weight=0.4, variable_dt=True,
        nonuniform_dt=True, dt_min=1e-3, dt_max=0.5)
    mixed, slots = {n: (s, m) for n, s, m in k2c_cases()}["mixed-dynamic"]
    return (
        ("nonuniform-trapezoidal-quadratic", trap, None),
        ("nonuniform-mixed-dynamic", dataclasses.replace(mixed, nonuniform_dt=True), slots),
    )


def colloc_cases():
    """The B=1024 cases of the other collocation rules (K2b, K2e): the
    flagship with midpoint differences (the fold at the kernel's SE(2)
    midpoint), on the shooting_rk4 grid, and on the shooting_rk7_2 grid
    (11 stages at 2 substeps: 22 evaluations per stage of the grid, the
    largest the kernel takes)."""
    from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time

    flag = config3_carlike_min_time(N=30, obstacle_cap=8)
    return tuple((name, dataclasses.replace(flag, collocation=rule), None) for name, rule in (
        ("midpoint-flagship", "midpoint_differences"),
        ("shooting-rk4-flagship", "shooting_rk4"),
        ("shooting-rk7-2-flagship", "shooting_rk7_2"),
    ))


def crank_nicolson_flagship():
    """Path F's spec: the flagship with Crank–Nicolson differences."""
    return dataclasses.replace(flagship()[0], collocation="crank_nicolson_differences")


# The least share of the lanes converged on both versions after the whole
# schedule, where a case's form converges fewer than the rule's quarter.
# The trapezoidal form converges 91 of 1024 lanes at the warm 3×4 on the
# card (JAX converges as few on the CPU: tests/test_torch_nonuniform_solves.py);
# it is held to 64 lanes, the count the gate asks of its 256.
CONVERGED_FLOOR = {"nonuniform-trapezoidal-quadratic": 1 / 16}


def all_cases():
    return model_cases() + k2c_cases() + k2d_cases() + k2f_cases() + colloc_cases()


def case_spec(name):
    """(spec, slot mix) of a case of ``model_cases``, ``k2c_cases``,
    ``k2d_cases``, ``k2f_cases`` or ``colloc_cases``."""
    return {n: (s, m) for n, s, m in all_cases()}[name]


def family_state(name, batch=RESCUE_SLOTS, case=None):
    """One case of ``all_cases``, or
    ``case`` under ``name`` (a spec, and a slot mix for
    ``benchmarks.mixed_obstacles``, None for ``random_ensemble``'s circles,
    or a kind of ``benchmarks.case_ensemble``) at ``batch`` lanes: its own
    cold solve and two fleet cycles (fused, the flagship's warm settings).
    The cold solve is the fused kernel's at the spec's cold preset: the
    same algorithm as the un-fused solve the main paths run (the plain
    version, which the kernel is held to, drives the port's own ``solve``),
    in one launch, where the un-fused one is host-bound for tens of seconds
    and seventeen of them at once crowd the host. Returns (spec, the warm
    settings, the fleet cycle's next warm inputs)."""
    import torch

    from mpc_local_planner_tpu_torch.benchmarks import case_ensemble, mixed_obstacles
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle
    from mpc_local_planner_tpu_torch.solvers.al_sqp import (
        SolverSettings,
        default_init,
        init_duals,
    )

    device = torch.device("cuda", 0)
    spec, slots = case or case_spec(name)
    warm = dataclasses.replace(flagship()[2], fused="auto")
    t0 = time.perf_counter()
    cold = SolverSettings.for_spec(spec)
    if slots is None:
        scen = ensemble(spec, batch, device)
    elif isinstance(slots, str):
        scen = case_ensemble(slots, spec, batch, torch.Generator().manual_seed(0), device=device)
    else:
        scen = ensemble(dataclasses.replace(spec, obstacle_cap=0), batch, device)
        gen = torch.Generator().manual_seed(1)
        scen = dataclasses.replace(scen, obstacles=mixed_obstacles(
            batch, gen, dtype=torch.float32, device=device, **slots))
    init, duals = default_init(spec, cold, scen)
    r = k2a.fused_solve_cuda(spec, cold, scen, init, duals)
    duals0 = init_duals(spec, warm, dtype=torch.float32, device=device, batch=(batch,))
    cycle = make_fleet_cycle(spec, warm, duals0, device=device)
    for _ in range(SETTLE_CYCLES):
        scen, r = cycle(scen, r)
    torch.cuda.synchronize()
    print(f"{name}: cold {cold.n_al}x{cold.n_sqp} solve and {SETTLE_CYCLES} cycles at "
          f"B={batch} in {time.perf_counter() - t0:.2f} s, converged "
          f"{int(torch.sum(r.converged))}")
    return spec, warm, warm_inputs(spec, warm, (scen, r), batch)


# processes at once in the last phase: as many as the B=1024 cases that ran
# at once before the paths' float64 checks joined them, and the only count
# measured (33 jobs in 142.58-148.29 s on an H100 host of 8 cores, 96 GiB);
# the phase prints the host's cores and each job its peak resident memory,
# the limits a larger count would meet
MAX_PROCS = 17


def run_processes(jobs, tmp):
    """Run ``jobs`` ((label, argv) pairs), each in a process of its own, at
    most MAX_PROCS at once, each one's output into a file under ``tmp``;
    print the outputs in the order of ``jobs``; return the labels of the
    jobs that failed. Every process is waited for, and killed if this one
    stops early."""
    pending, running, codes = list(enumerate(jobs)), {}, {}
    try:
        while pending or running:
            while pending and len(running) < MAX_PROCS:
                i, (_, argv) = pending.pop(0)
                log = open(f"{tmp}/job_{i}.log", "w")
                running[i] = (subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT), log)
            for i, (proc, log) in list(running.items()):
                if proc.poll() is not None:
                    log.close()
                    codes[i] = proc.returncode
                    del running[i]
            time.sleep(0.2)
    finally:
        for proc, log in running.values():
            proc.kill()
            proc.wait()
            log.close()
    failed = []
    for i, (label, _) in enumerate(jobs):
        with open(f"{tmp}/job_{i}.log") as log:
            print(log.read(), end="", flush=True)
        if codes[i] != 0:
            failed.append(label)
    return failed


def last_phase(checks, names):
    """The main paths' float64 checks (``checks``) and phases 14 and 23, each
    ``family_case`` in a process of its own, all at once (host-bound work
    that leaves the card idle, so they share the card and the host's
    cores); prints each one's lines in order and fails if any failed. Then
    each case's kernel, plain and bound times (``k2a_times``), one case
    after the other in this process, so that no other process shares the
    card while a case is timed; one JSON row per case. Returns each case's
    row."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        saved = {name: f"{tmp}/{name}.pt" for name in names}
        jobs = checks.jobs + [
            (name, [sys.executable, __file__, "--family-case", name, saved[name]])
            for name in names
        ]
        failed = run_processes(jobs, tmp)
        if failed:
            _fail(f"the fused kernel disagrees with its plain version on {', '.join(failed)}")
        print(f"checks and cases: {len(jobs)} processes, at most {MAX_PROCS} at once, done in "
              f"{time.perf_counter() - t0:.2f} s on {os.cpu_count()} host cores")
        warm = dataclasses.replace(flagship()[2], fused="auto")
        rows = {}
        for name in names:
            case = torch.load(saved[name], map_location="cuda:0", weights_only=False)
            args32, batch = case["args"], case["args"][0].x0.shape[0]
            tag = f"{name} B={batch} {warm.n_al}x{warm.n_sqp}"
            row = k2a_times(case_spec(name)[0], warm, args32, case["info"], tag)
            print(json.dumps({"family_case": name, "batch": batch, **row}))
            rows[name] = row
    return rows


def fused_path(tag, spec, cold, warm_f, rescue_f, device, card, floor, **kw):
    """A warm fleet cycle on the fused path (``main_path``'s keywords pass
    through): the fused kernel must carry every warm solve and rescue pass
    (1 + chain launches per cycle), K1 the cold solve and the oracle (on the
    non-uniform grid none: their KKT solve is the plain lqr_solve) and
    nothing in the warm cycles, and converged_frac reach ``floor``. Prints
    the path's line; returns (extra, settled state, one cycle, fused
    launches)."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    reset_counts()
    t0 = time.perf_counter()
    extra, settled, secs, cycle, _, k1_before_oracle = main_path(
        spec, cold, warm_f, rescue_f, device, **kw
    )
    fused = k2a.fused_solve_cuda.launches
    k1 = riccati_cuda.lqr_solve_cuda.launches
    by_rule = rule_counts()
    cold_iters = 0 if spec.nonuniform_dt else cold.n_al * cold.n_sqp  # K1 per cold solve
    print(json.dumps({**extra, "path": tag, "fused_launches": fused,
                      "fused_launches_by_rule": by_rule, "k1_launches": k1,
                      "k1_launches_in_warm_cycles": k1_before_oracle - cold_iters,
                      "device": card, **secs, "main_path_s": time.perf_counter() - t0}))
    expected = (1 + kw.get("chain", 1)) * (SETTLE_CYCLES + TIMED_CYCLES)
    if fused != expected:
        _fail(f"the fused kernel launched {fused} times on the {tag} path, expected {expected}")
    if k1 != 2 * cold_iters or k1_before_oracle != cold_iters:
        _fail(f"K1 launched {k1} times on the {tag} path ({k1_before_oracle} before the "
              f"oracle), expected {2 * cold_iters} (the cold solve and the oracle)")
    if not extra["converged_frac"] >= floor:
        _fail(f"{tag} converged_frac {extra['converged_frac']} below the {floor} floor")
    return extra, settled, cycle, fused


def gate_and_trace(tag, spec, warm, warm_f, settled, cycle, cycle_ms):
    """The fused warm solve against the un-fused one on 256 lanes of the
    live warm state, then one warm cycle under torch.profiler."""
    gate, passed = gate_phase(spec, warm, warm_f, settled)
    print(json.dumps({f"{tag}_fused_vs_unfused_gate": gate, "passed": passed}))
    if not passed:
        _fail(f"{tag} fused-vs-un-fused gate failed: {gate}")
    print(json.dumps({f"trace_{tag}": trace_phase(cycle, settled, cycle_ms)}))


def trace_phase(cycle, settled, cycle_ms):
    """One warm cycle (solve + rescue) from the settled state under
    torch.profiler: the device's kernel time per cycle, K1's and K2a's parts
    of it, and the device's busy share against the unprofiled cycle time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scen, r = settled
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cycle(scen, r)
        torch.cuda.synchronize()
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out = {
        "device_kernel_ms_per_cycle": device_ms,
        "kernel_launches_per_cycle": sum(e.count for e in kernels),
        "device_busy_frac": device_ms / cycle_ms,
    }
    for tag, key in (("k1", "riccati_sweep_kernel"), ("k2a", "k2a_kernel")):
        mine = [e for e in kernels if key in e.key]
        out[f"{tag}_ms_per_cycle"] = sum(e.self_device_time_total for e in mine) / 1e3
        out[f"{tag}_launches_per_cycle"] = sum(e.count for e in mine)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    out["top_kernels_ms"] = {e.key[:60]: e.self_device_time_total / 1e3 for e in top}
    return out


PATH_FAMILIES = ("canonical_carlike", "converter_lines", "polygon_footprint", "via_points",
                 "nonuniform")  # paths A-E


def fused_groups():
    """The fused kernel's library groups that the smoke launches: those of
    the flagship, config #2, paths A-F and every case of phases 14 and 23,
    in float32 and float64."""
    import torch

    from mpc_local_planner_tpu_torch.benchmarks import family_spec
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a

    specs = [flagship()[0], config2(), crank_nicolson_flagship()]
    specs += [family_spec(f, N=30) for f in PATH_FAMILIES]
    specs += [spec for _, spec, _ in all_cases()]
    return sorted({k2a.group(s, d) for s in specs for d in (torch.float32, torch.float64)})


def build_phase():
    """Build K1 and the fused kernel's groups the smoke launches, all at once
    (one nvcc each); print each build's seconds, the phase's wall time and
    ptxas' registers, stack frames and spills for every instantiation."""
    from concurrent.futures import ThreadPoolExecutor

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda, riccati_cuda

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        k1 = pool.submit(riccati_cuda.build)
        fused = pool.submit(fused_al_sqp_cuda.build, fused_groups())
        builds = [k1.result(), *fused.result()]
    wall = time.perf_counter() - t0
    for built in builds:
        print(f"build: {built['path']} in {built['seconds']:.2f} s")
        for name, usage in ptxas_rows(built["ptxas"]):
            print(f"  ptxas: {name}: {usage}")
    print(f"build: phase 2 wall {wall:.2f} s")
    return wall


def ptxas_rows(report):
    """(kernel, 'R registers, S B stack, spills st/ld B') per entry function
    of ptxas' report; the fused kernel's name as its template arguments."""
    import re

    rows, name, usage = [], None, {}
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            args = re.search(r"k2a_kernelI([fd])Li(\d)ELi(\d)ELi(\d+)ELb([01])ELi(\d)E", name)
            if args:
                t, model, obj, geo, nonu, colloc = args.groups()
                objective = {"0": "minimum time", "1": "quadratic", "2": "via points"}[obj]
                rule = {"0": "", "1": ", midpoint / Crank-Nicolson / shooting"}[colloc]
                name = (f"k2a_kernel<{'float' if t == 'f' else 'double'}, model {model}, "
                        f"{objective}, GEO {geo}{', NONU' if nonu == '1' else ''}{rule}>")
            usage = {}
        for key, pat in (("stack", r"(\d+) bytes stack frame"), ("st", r"(\d+) bytes spill stores"),
                         ("ld", r"(\d+) bytes spill loads"), ("reg", r"Used (\d+) registers")):
            found = re.search(pat, line)
            if found:
                usage[key] = found.group(1)
        if name and "reg" in usage:
            rows.append((name, f"{usage['reg']} registers, {usage.get('stack', '?')} B stack, "
                               f"spills {usage.get('st', '?')}/{usage.get('ld', '?')} B"))
            name = None
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a  # fails outside the repo
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    # ---- 1. device ------------------------------------------------------ #
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)

    # ---- 2. build ------------------------------------------------------- #
    t_start = time.perf_counter()
    build_s = build_phase()
    laps, t_lap = {}, [time.perf_counter()]

    def lap(tag):
        """The seconds since the last lap, under ``tag`` in ``smoke_split_s``."""
        now = time.perf_counter()
        laps[tag] = now - t_lap[0]
        t_lap[0] = now

    # ---- 3. K1 against its plain version --------------------------------- #
    spec, cold, warm, rescue_set = flagship()
    k1 = kernel_phase(spec, warm, device)
    kernel_phase(flagship(N=K1_LONG_N)[0], warm, device, batches=(BATCH,),
                 tag=f"K1 N={K1_LONG_N}")
    lap("3_k1")

    # ---- 4. main path, un-fused ------------------------------------------ #
    reset_counts()
    t0 = time.perf_counter()
    extra, settled, secs, cycle, cold_start, _ = main_path(spec, cold, warm, rescue_set, device)
    launches = riccati_cuda.lqr_solve_cuda.launches
    main_s = time.perf_counter() - t0
    expected = (
        2 * cold.n_al * cold.n_sqp
        + (SETTLE_CYCLES + TIMED_CYCLES)
        * (warm.n_al * warm.n_sqp + rescue_set.n_al * rescue_set.n_sqp)
    )
    print(json.dumps({**extra, "path": "unfused", "k1_launches": launches,
                      "k2a_launches": k2a.fused_solve_cuda.launches, "device": card, **secs,
                      "main_path_s": main_s}))
    if launches != expected or k2a.fused_solve_cuda.launches != 0:
        _fail(f"K1 launched {launches} times on the un-fused path, expected {expected}")
    if not extra["converged_frac"] >= 0.5:
        _fail(f"converged_frac {extra['converged_frac']} below the 0.5 floor")

    # ---- 5. K1-vs-plain gate on the live warm state ------------------------ #
    gate, passed = gate_phase(spec, dataclasses.replace(warm, kkt="scan"), warm, settled)
    print(json.dumps({"k1_vs_plain_gate": gate, "passed": passed}))
    if not passed:
        _fail(f"K1-vs-plain gate failed: {gate}")

    # ---- 6. where one un-fused warm cycle's device time goes -------------- #
    print(json.dumps({"trace": trace_phase(cycle, settled, extra["cycle_ms"])}))
    lap("4_6_unfused")

    # ---- 7. K2a against its plain version --------------------------------- #
    checks = F64Checks()
    warm_f = dataclasses.replace(warm, fused="auto")
    rescue_f = dataclasses.replace(rescue_set, fused="auto")
    k2a_rows = k2a_phase(spec, warm_f, rescue_f, settled, checks)
    lap("7_k2a")

    # ---- 8. main path, fused, from the same cold solve --------------------- #
    reset_counts()
    t0 = time.perf_counter()
    extra_f, settled_f, secs_f, cycle_f, _, k1_in_cycles = main_path(
        spec, cold, warm_f, rescue_f, device, cold_start=cold_start
    )
    k2a_launches = k2a.fused_solve_cuda.launches
    k1_fused = riccati_cuda.lqr_solve_cuda.launches
    by_rule = rule_counts()
    main_f_s = time.perf_counter() - t0
    print(json.dumps({**extra_f, "path": "fused", "k2a_launches": k2a_launches,
                      "fused_launches_by_rule": by_rule,
                      "k1_launches": k1_fused, "k1_launches_in_warm_cycles": k1_in_cycles,
                      "device": card, **secs_f, "main_path_s": main_f_s}))
    if k2a_launches != 2 * (SETTLE_CYCLES + TIMED_CYCLES):
        _fail(f"K2a launched {k2a_launches} times on the fused path, expected "
              f"{2 * (SETTLE_CYCLES + TIMED_CYCLES)}")
    if k1_in_cycles != 0 or k1_fused != cold.n_al * cold.n_sqp:
        _fail(f"K1 launched {k1_in_cycles} times in the fused warm cycles and {k1_fused} "
              f"in all, expected 0 and {cold.n_al * cold.n_sqp} (the oracle)")
    if not extra_f["converged_frac"] >= 0.5:
        _fail(f"fused converged_frac {extra_f['converged_frac']} below the 0.5 floor")

    # ---- 9. fused-vs-un-fused gate on the live warm state ------------------- #
    gate_f, passed = gate_phase(spec, warm, warm_f, settled_f)
    print(json.dumps({"k2a_vs_unfused_gate": gate_f, "passed": passed}))
    if not passed:
        _fail(f"fused-vs-un-fused gate failed: {gate_f}")

    # ---- 10. where one fused warm cycle's device time goes ----------------- #
    print(json.dumps({"trace_fused": trace_phase(cycle_f, settled_f, extra_f["cycle_ms"])}))
    lap("8_10_fused")

    # ---- 11. K1 without the free δτ (config #2, fixed dt) ------------------- #
    spec2, cold2, warm2, rescue2 = fleet_settings(config2())
    kernel_phase(spec2, warm2, device, batches=(BATCH,), tag="K1 config2")

    # ---- 12. config #2 main path, fused ------------------------------------- #
    warm2_f = dataclasses.replace(warm2, fused="auto")
    rescue2_f = dataclasses.replace(rescue2, fused="auto")
    extra2, settled2, cycle2, fused2 = fused_path(
        "config2_fused", spec2, cold2, warm2_f, rescue2_f, device, card, 0.25
    )

    # ---- 13. the kernel against its plain version on config #2 -------------- #
    k2_rows = k2a_phase(spec2, warm2_f, rescue2_f, settled2, checks, name="config2")

    # ---- 15-16. config #2 fused-vs-un-fused gate, trace ---------------------- #
    gate_and_trace("config2", spec2, warm2, warm2_f, settled2, cycle2, extra2["cycle_ms"])
    lap("11_16_config2")

    # ---- 17-19. path A: the reference's car-like config (two discs) --------- #
    from mpc_local_planner_tpu_torch.benchmarks import family_spec

    specA, coldA, warmA, rescueA = fleet_settings(family_spec("canonical_carlike", N=30))
    warmA_f = dataclasses.replace(warmA, fused="auto")
    rescueA_f = dataclasses.replace(rescueA, fused="auto")
    extraA, settledA, cycleA, fusedA = fused_path(
        "canonical_carlike_fused", specA, coldA, warmA_f, rescueA_f, device, card, 0.5,
        family="canonical_carlike",
    )
    rows_a = k2a_phase(specA, warmA_f, rescueA_f, settledA, checks, name="pathA")
    gate_and_trace("canonical_carlike", specA, warmA, warmA_f, settledA, cycleA,
                   extraA["cycle_ms"])
    lap("17_19_path_a")

    # ---- 20-22. path B: the wall world (line slots), warm 4x4, chained ------ #
    specB, coldB, warmB, _ = fleet_settings(family_spec("converter_lines", N=30))
    warmB = dataclasses.replace(warmB, n_al=4)
    warmB_f = dataclasses.replace(warmB, fused="auto")
    rescueB_f = dataclasses.replace(warmB_f, alphas=rescue_set.alphas)
    extraB, settledB, cycleB, fusedB = fused_path(
        "converter_lines_fused", specB, coldB, warmB_f, rescueB_f, device, card, 0.25,
        family="converter_lines", slots=LINES_RESCUE_SLOTS, chain=2, stuck_restart=2,
    )
    rows_b = k2a_phase(specB, warmB_f, rescueB_f, settledB, checks, name="pathB",
                       slots=LINES_RESCUE_SLOTS)
    gate_and_trace("converter_lines", specB, warmB, warmB_f, settledB, cycleB,
                   extraB["cycle_ms"])
    lap("20_22_path_b")

    # ---- 24-26. path C: the polygon-footprint family (a moving rectangle) -- #
    specC, coldC, warmC, rescueC = fleet_settings(family_spec("polygon_footprint", N=30))
    warmC_f = dataclasses.replace(warmC, fused="auto")
    rescueC_f = dataclasses.replace(rescueC, fused="auto")
    extraC, settledC, cycleC, fusedC = fused_path(
        "polygon_footprint_fused", specC, coldC, warmC_f, rescueC_f, device, card, 0.5,
        family="polygon_footprint",
    )
    rows_c = k2a_phase(specC, warmC_f, rescueC_f, settledC, checks, name="pathC")
    gate_and_trace("polygon_footprint", specC, warmC, warmC_f, settledC, cycleC,
                   extraC["cycle_ms"])
    lap("24_26_path_c")

    # ---- 27-29. path D: the via-points family (K2d) ------------------------ #
    specD, coldD, warmD, rescueD = fleet_settings(family_spec("via_points", N=30))
    warmD_f = dataclasses.replace(warmD, fused="auto")
    rescueD_f = dataclasses.replace(rescueD, fused="auto")
    extraD, settledD, cycleD, fusedD = fused_path(
        "via_points_fused", specD, coldD, warmD_f, rescueD_f, device, card, 0.5,
        family="via_points",
    )
    rows_d = k2a_phase(specD, warmD_f, rescueD_f, settledD, checks, name="pathD")
    gate_and_trace("via_points", specD, warmD, warmD_f, settledD, cycleD, extraD["cycle_ms"])
    lap("27_29_path_d")

    # ---- 30-32. path E: the non-uniform grid (K2f) ------------------------ #
    specE, coldE, warmE, rescueE = fleet_settings(family_spec("nonuniform", N=30))
    warmE_f = dataclasses.replace(warmE, fused="auto")
    rescueE_f = dataclasses.replace(rescueE, fused="auto")
    extraE, settledE, cycleE, fusedE = fused_path(
        "nonuniform_fused", specE, coldE, warmE_f, rescueE_f, device, card, 0.5,
        family="nonuniform",
    )
    rows_e = k2a_phase(specE, warmE_f, rescueE_f, settledE, checks, name="pathE")
    gate_and_trace("nonuniform", specE, warmE, warmE_f, settledE, cycleE, extraE["cycle_ms"])
    lap("30_32_path_e")

    # ---- 33-35. path F: the Crank–Nicolson flagship (K2b) ---------------- #
    specF, coldF, warmF, rescueF = fleet_settings(crank_nicolson_flagship())
    warmF_f = dataclasses.replace(warmF, fused="auto")
    rescueF_f = dataclasses.replace(rescueF, fused="auto")
    extraF, settledF, cycleF, fusedF = fused_path(
        "crank_nicolson_fused", specF, coldF, warmF_f, rescueF_f, device, card, 0.5,
    )
    rows_f = k2a_phase(specF, warmF_f, rescueF_f, settledF, checks, name="pathF")
    gate_and_trace("crank_nicolson", specF, warmF, warmF_f, settledF, cycleF,
                   extraF["cycle_ms"])
    lap("33_35_path_f")
    paths_s = time.perf_counter() - t_start - build_s

    # ---- the paths' f64 checks; 14 and 23: the other models, config #1, the
    # K2c-K2f, K2b and K2e cases ------------------------------------------- #
    t_cases = time.perf_counter()
    case_rows = last_phase(checks, [name for name, _, _ in all_cases()])
    print(json.dumps({"smoke_split_s": {
        "build": build_s, "phases_3_to_35": paths_s,
        "f64_checks_and_cases": time.perf_counter() - t_cases,
        "total_before_summary": time.perf_counter() - t_start, "paths": laps}}))

    # ---- 36. summary ---------------------------------------------------- #
    row, row2, row3 = k1[BATCH], k2a_rows[BATCH], k2_rows[BATCH]
    from mpc_local_planner_tpu_torch.ocp.collocation import SHOOTING_PREFIX

    def rule_launches(*prefixes):
        """The main paths' launches of the rules that start with one of ``prefixes``."""
        return sum(n for rule, n in RULE_LAUNCHES.items() if rule.startswith(prefixes))

    def fused_row(name, launches, r, line=264):
        return {
            "name": name,
            "route": "cuda",
            "source": "mpc_local_planner_tpu_torch/csrc/fused_al_sqp.cu",
            "replaces": f"mpc_local_planner_tpu/ops/fused_al_sqp_pallas.py:{line}",
            "launches": launches,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        }

    print(json.dumps({"kernels": [{
        "name": "K1 riccati_sweep",
        "route": "cuda",
        "source": "mpc_local_planner_tpu_torch/csrc/riccati_sweep.cu",
        "replaces": "mpc_local_planner_tpu/ops/riccati_pallas.py:37",
        "launches": launches,
        "max_abs_err": row["max_abs_err_f32"],
        "ms": row["ms"],
        "device_ms": row["device_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    },
        fused_row("K2a fused_al_sqp", k2a_launches, row2),
        fused_row("K2 fused_al_sqp: unicycle, quadratic form, terminal ball, fixed dt "
                  "(config #2)", fused2, row3),
        fused_row("K2 fused_al_sqp: simple car, two-disc footprint (K2c; the reference's "
                  "car-like config, path A)", fusedA, rows_a[BATCH]),
        fused_row("K2 fused_al_sqp: simple car, disc, line slots (K2c; the wall world, "
                  "path B, warm 4x4)", fusedB, rows_b[BATCH]),
        fused_row("K2 fused_al_sqp: simple car, polygon footprint, circle slots (K2c; the "
                  "polygon-footprint family, path C)", fusedC, rows_c[BATCH]),
        fused_row("K2 fused_al_sqp: simple car, minimum time with via points (K2d; the "
                  "via-points family, path D)", fusedD, rows_d[BATCH]),
        fused_row("K2 fused_al_sqp: simple car, minimum time on the non-uniform per-stage "
                  "dt grid (K2f; the non-uniform family, path E)", fusedE, rows_e[BATCH]),
        fused_row("K2 fused_al_sqp: simple car, Crank-Nicolson differences (K2b, the "
                  "-E^-1 fold of the Pallas defect; the Crank-Nicolson flagship, path F)",
                  rule_launches("midpoint_differences", "crank_nicolson_differences"),
                  rows_f[BATCH], line=552),
        fused_row("K2 fused_al_sqp: simple car on the shooting_rk4 grid (K2e, the tableau "
                  "walk of _shoot_phi; the B=1024 case shooting-rk4-flagship, on no main "
                  "path)", rule_launches(SHOOTING_PREFIX), case_rows["shooting-rk4-flagship"],
                  line=481),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


def family_worker(name, save=None):
    """``chip_smoke.py --family-case NAME [FILE]``: one case of
    ``last_phase``, its warm inputs saved to FILE."""
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.set_num_threads(1)
    family_case(name, save)
    print_peak_memory(name)


def f64_worker(path):
    """``chip_smoke.py --f64-check FILE``: one of ``F64Checks``'s checks."""
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.set_num_threads(1)
    job = torch.load(path, map_location="cuda:0", weights_only=False)
    k2a_f64_phase(job["spec"], job["st"], _double(job["args"]), job["tag"], job["floor"])
    print_peak_memory(job["tag"])


def print_peak_memory(tag):
    """One job's peak resident memory on the host, for ``MAX_PROCS``."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB on Linux
    print(f"{tag}: peak resident memory {peak:.2f} GiB")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--family-case"]:
        family_worker(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--f64-check"]:
        f64_worker(sys.argv[2])
    else:
        main()
