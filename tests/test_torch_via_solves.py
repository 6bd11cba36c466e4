"""Whole warm solves with via points on the CPU: the port's un-fused
``solve`` and the fused kernel's plain version ``fused_solve_plain`` against
JAX ``vmap(solve_single)``, from identical inputs handed over through numpy
(``tests/test_torch_via_cold.py`` runs the cold problems and path D's cycle).

- The via-points family (path D, ``family_spec("via_points")``: 4 corridor
  via points, unordered) and the ensembles of ``tests/test_fused_solver.py``
  (3 via slots uniform in [0.2, 2]³ with about 30% masked, an orientation
  weight of 0.5, ordered and unordered, 2 circle slots): twelve lanes at N=8,
  goals and via points pulled in to 30% of their distance, the warm
  settings of that file (2×3, 8 candidates), from one warm state (the JAX
  result of a first solve from the straight-line seed). Float64: every lane
  at 1e-9, the multipliers at 1e-9 + ρ·1e-13;
  float32: the rule of ``tests/test_torch_footprints_lp_solves.py`` (the
  parity tolerances against JAX's float64 answer from the same inputs on
  the lanes float32 determines, the rest held looser): two float32 answers
  can sit further apart than either from the float64 one (on a lane of the
  orientation cases the multipliers of the defects 7.2e-3 apart, each
  within 4.0e-3 of it). The lanes float32 determines are at least half of
  those both converged. Path D's family ends most lanes at ρ = 7.5e4,
  where one ulp of a defect is 7e-3 in a multiplier: its draw
  (``PATH_D_KEY``) is one where float32 determines every lane both
  converged (the first draw in which three lanes are; at the draw 5 one of
  four was, JAX's own float32 answer 3.2e-3 beyond the tolerance from its
  float64 one on another).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.solvers import al_sqp as j_al

from test_fused_solver import WARM as J_WARM
from test_fused_solver import _setup
from test_torch_k2c_solves import WARM, _cast
from test_torch_footprints_lp_solves import _assert_f32_matches, _assert_f64_matches
from test_torch_quadratic import B, np_tree, to_torch
from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp

N = 8
# case: ordered, orientation weight; None = path D's family
CASES = {"path_d": None, "unordered_orientation": (False, 0.5), "ordered_orientation": (True, 0.5)}
PATH_D_KEY = 13


def _specs(case):
    if CASES[case] is None:
        return jb.family_spec("via_points", N=N), tb.family_spec("via_points", N=N)
    ordered, ow = CASES[case]
    over = dict(objective="minimum_time_via_points", via_cap=3, via_position_weight=2.0,
                via_orientation_weight=ow, via_points_ordered=ordered)
    return (dataclasses.replace(jb.config3_carlike_min_time(N=N, obstacle_cap=2), **over),
            dataclasses.replace(tb.config3_carlike_min_time(N=N, obstacle_cap=2), **over))


def _pull_in(scen):
    """Goals and via points pulled in to 30% of their distance from x0."""
    x0 = scen.x0[..., None, :2]
    vxy = x0 + 0.3 * (scen.via_points[..., :2] - x0)
    return dataclasses.replace(
        scen, xf=scen.x0 + 0.3 * (scen.xf - scen.x0),
        via_points=jnp.concatenate([vxy, scen.via_points[..., 2:]], axis=-1))


@functools.lru_cache(maxsize=None)
def jax_solves(case, dtype_name):
    """The warm inputs (numpy trees), the JAX solve from them and, in
    float32, the JAX float64 solve from the same inputs."""
    jdtype = {"f32": jnp.float32, "f64": jnp.float64}[dtype_name]
    jspec, _ = _specs(case)
    if CASES[case] is None:
        scen = jb.family_ensemble("via_points", jspec, B, jax.random.PRNGKey(PATH_D_KEY))
    else:  # tests/test_fused_solver.py::test_fused_via_points_match_xla
        _, scen, _, _ = _setup(N=N, M=2, batch=B, key=47)
        k1, k2 = jax.random.split(jax.random.PRNGKey(48))
        scen = dataclasses.replace(
            scen, via_points=jax.random.uniform(k1, (B, 3, 3), jnp.float32, 0.2, 2.0),
            via_mask=jax.random.uniform(k2, (B, 3), jnp.float32) > 0.3)
    duals = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                   j_al.init_duals(jspec, J_WARM, dtype=jnp.float32))
    scen, duals = _cast((_pull_in(scen), duals), jdtype)
    solve = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, J_WARM, s, i, d)))
    first = solve(scen, j_initial_primal(jspec, scen), duals)
    inputs = (np_tree(scen), np_tree(first.primal), np_tree(first.duals))
    out = np_tree(solve(scen, first.primal, first.duals))
    if dtype_name == "f64":
        return inputs, out, None
    return inputs, out, np_tree(solve(*_cast((scen, first.primal, first.duals), jnp.float64)))


def _solver(spec, st, path):
    if path == "unfused":
        return al_sqp.make_solver(spec, st, device="cpu")
    return functools.partial(k2a.fused_solve_plain, spec, st)


@pytest.mark.parametrize("path", ["unfused", "plain"])
@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_via_solve_matches_jax(case, dtype_name, path):
    assert all(getattr(J_WARM, k) == v for k, v in WARM.items())
    (scen, init, duals), j, j64 = jax_solves(case, dtype_name)
    _, spec = _specs(case)
    st = al_sqp.SolverSettings(**WARM)
    ts, ti, td = to_torch(scen, init, duals)
    assert k2a.fused_supported(spec) and al_sqp.fused_dispatch_ok(spec, st, ts, ti.xs.dtype,
                                                                  "cuda") == (dtype_name == "f32")
    solve = _solver(spec, st, path)
    before = riccati_cuda.lqr_solve_cuda.launches
    t = convert.to_numpy(solve(ts, ti, td))
    assert riccati_cuda.lqr_solve_cuda.launches == before  # CPU: the plain KKT solve
    if dtype_name == "f64":
        _assert_f64_matches(t, j)
        assert 0 < j["converged"].sum() <= B
    else:
        ts_ulp = [convert.to_numpy(solve(ts, q, td)) for q in agreement.ulp_perturbed(ti)]
        _assert_f32_matches(t, j, j64, ts_ulp)
    # the attraction bends the solution: the same solve with every slot
    # masked ends elsewhere
    off = dataclasses.replace(ts, via_mask=ts.via_mask & False)
    t_off = convert.to_numpy(solve(off, ti, td))
    assert not np.allclose(t_off["primal"]["xs"], t["primal"]["xs"], atol=1e-3)
