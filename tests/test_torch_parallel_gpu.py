"""The parallel layer on the card: the sharded solver on two shards of one
card against its per-block reference, and the mixed-model ensemble against
each group's own solver.

These launch the hand-written fused kernel, so they skip without a CUDA
card. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_parallel_gpu.py

* ``make_sharded_solver`` on ``[cuda:0] * 2`` (the flagship, N=30 with 8
  circle slots, 512 lanes, the fleet cycle's warm 3×4 budget and a 4×4
  rescue of 64 slots a shard) is bit-equal, lane for lane, to
  ``make_solver`` followed by ``make_rescue`` on each 256-lane block; each
  shard launches the fused kernel twice.
* ``MixedEnsembleSolver`` over the flagship and BASELINE config #2 (256
  lanes each): each group is bit-equal to its own ``make_solver``; one
  fused launch per group, counted by the wrapper under the group's library.
"""

import collections
import dataclasses

import pytest
import torch

from mpc_local_planner_tpu_torch.benchmarks import (
    config2_diffdrive_obstacles,
    config3_carlike_min_time,
    random_ensemble,
)
from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda
from mpc_local_planner_tpu_torch.parallel.ensembles import MixedEnsembleSolver
from mpc_local_planner_tpu_torch.parallel.sharding import (
    gather,
    make_mesh,
    make_sharded_solver,
    shard_batch,
)
from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings, default_init, make_solver
from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

pytestmark = pytest.mark.gpu
WARM = SolverSettings(n_al=3, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
                      alphas=(1.0, 0.5, 0.22))
RESCUE = dataclasses.replace(WARM, n_al=4, alphas=(1.0, 0.7, 0.5, 0.35, 0.22, 0.14, 0.08, 0.03))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernel has no CPU mode")
    return torch.device("cuda", 0)


def _trees_equal(a, b):
    flags = []
    tree_map(lambda x, y: flags.append(torch.equal(x, y)) or x, a, b)
    return all(flags)


def test_torch_sharded_solver_on_two_shards_of_one_card_is_bit_equal_per_block():
    dev = _card()
    spec = config3_carlike_min_time(N=30, obstacle_cap=8)
    scen = random_ensemble(spec, 512, torch.Generator().manual_seed(3), device=dev)
    init, duals = default_init(spec, WARM, scen)
    mesh = make_mesh(1, 2, devices=[dev, dev])
    before = fused_al_sqp_cuda.fused_solve_cuda.launches
    out = make_sharded_solver(spec, WARM, mesh, rescue_slots=64, rescue_settings=RESCUE)(
        *(shard_batch(t, mesh) for t in (scen, init, duals)))
    torch.cuda.synchronize(dev)
    assert fused_al_sqp_cuda.fused_solve_cuda.launches - before == 4
    solve = make_solver(spec, WARM, dev)
    rescue = make_rescue(spec, WARM, 64, rescue_settings=RESCUE, device=dev)
    for i in range(2):
        blk = [tree_map(lambda a, i=i: a[256 * i:256 * (i + 1)], t) for t in (scen, init, duals)]
        ref = rescue(blk[0], solve(*blk))
        assert _trees_equal(out.blocks[i], ref), i
    assert gather(out).converged.float().mean() >= 0.25


def test_torch_mixed_ensemble_on_the_card_is_bit_equal_per_group():
    dev = _card()
    specs = (config3_carlike_min_time(N=30, obstacle_cap=8), config2_diffdrive_obstacles(N=30))
    solver = MixedEnsembleSolver([(s, WARM) for s in specs], device=dev)
    scens = [random_ensemble(s, 256, torch.Generator().manual_seed(k), device=dev)
             for k, s in enumerate(specs)]
    states = [solver.init_state(g, scens[g]) for g in range(2)]
    counts = fused_al_sqp_cuda.fused_solve_cuda.launches_by_group
    before = collections.Counter(counts)
    results = solver.solve_all(scens, [s[0] for s in states], [s[1] for s in states])
    torch.cuda.synchronize(dev)
    groups = [fused_al_sqp_cuda.group(s, torch.float32) for s in specs]
    assert groups[0] != groups[1]
    assert [counts[g] - before[g] for g in groups] == [1, 1]
    assert sum((counts - before).values()) == 2
    for g, spec in enumerate(specs):
        assert _trees_equal(results[g], make_solver(spec, WARM, dev)(scens[g], *states[g]))
    assert solver.summary(results)["n_scenarios"] == 512
