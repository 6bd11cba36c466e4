"""Whole solves with the fused kernel's geometry (K2c) on the CPU: the
port's un-fused ``solve`` and the kernel's plain version
``fused_solve_plain`` against JAX ``vmap(solve_single)``, from identical
inputs handed over through numpy.

The cases are those of ``tests/test_fused_solver.py`` that hold the Pallas
kernel's geometry against the XLA path (its ``_widened_setup``, keys and
slot mixes): the two-disc footprint with point and circle slots, dynamic
line slots with circles, polygon slots with a varying vertex count, and all
four families with the canonical two-disc footprint and dynamic obstacles.
Twelve lanes at N=8, goals pulled in to 30% of their distance, the warm
settings of that file (2×3, 8 candidates, 1e-3 tolerances), from one warm
state: the JAX result of a first solve from the straight-line seed.

- float64: every lane at 1e-9 (xs, us, dt, the duals, cost), identical
  conv flags.
- float32: the parity tolerances of ``tests/test_torch_quadratic.py``
  (``assert_matches_jax``) on the lanes both converged where float32
  rounding alone does not move either answer past them. This geometry flips
  discrete branches (the nearer disc, a clipped segment parameter, the
  nearest polygon edge) at float32-noise ties, which is why the JAX tests
  allow 6e-3 on trajectories there.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_local_planner_tpu.geometry import footprints as jfp
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.solvers import al_sqp as j_al

from test_fused_solver import WARM as J_WARM
from test_fused_solver import _widened_setup
from test_torch_quadratic import B, assert_matches_jax, np_tree, to_torch
from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.geometry import footprints as tfp
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp

N = 8
WARM = dict(
    n_al=2, n_sqp=3, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
    alphas=(1.0, 0.7, 0.5, 0.35, 0.22, 0.14, 0.08, 0.03),
)
# case: (footprint name and arguments, _widened_setup's key, slot mix,
# dynamic) as in tests/test_fused_solver.py
CASES = {
    "two_circles": (("TwoCirclesFootprint", dict(front_offset=0.15, front_radius=0.2,
                                                 rear_offset=-0.15, rear_radius=0.18)),
                    31, dict(mp=1, mc=3), False),
    "lines_dynamic": (("CircularFootprint", dict(radius=0.2)), 33, dict(mc=2, ml=3), True),
    "polygons": (("CircularFootprint", dict(radius=0.15)), 35,
                 dict(mc=1, mg=2, V=5, vary_nv=True), False),
    "mixed_canonical": (("TwoCirclesFootprint", dict(front_offset=0.15, front_radius=0.2,
                                                     rear_offset=-0.15, rear_radius=0.2)),
                        39, dict(mp=1, mc=2, ml=2, mg=1, V=4), True),
}


def _specs(case):
    (fp_name, fp_kw), _, fam, dyn = CASES[case]
    M = sum(fam.get(k, 0) for k in ("mp", "mc", "ml", "mg"))
    tspec = dataclasses.replace(
        tb.config3_carlike_min_time(N=N, obstacle_cap=M),
        footprint=getattr(tfp, fp_name)(**fp_kw), enable_dynamic_obstacles=dyn,
    )
    return getattr(jfp, fp_name)(**fp_kw), tspec


def _cast(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree
    )


@functools.lru_cache(maxsize=None)
def jax_solves(case, dtype_name):
    """The warm inputs (numpy trees), the JAX solve from them and, in
    float32, the JAX float64 solve from the same inputs."""
    jdtype = {"f32": jnp.float32, "f64": jnp.float64}[dtype_name]
    jfp_, _ = _specs(case)
    _, key, fam, dyn = CASES[case]
    jspec, scen, _, duals = _widened_setup(jfp_, key=key, batch=B, N=N, dyn=dyn, **fam)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.3 * (scen.xf - scen.x0))
    scen, duals = _cast((scen, duals), jdtype)
    init = j_initial_primal(jspec, scen)
    solve = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, J_WARM, s, i, d)))
    first = solve(scen, init, duals)
    inputs = (np_tree(scen), np_tree(first.primal), np_tree(first.duals))
    out = np_tree(solve(scen, first.primal, first.duals))
    if dtype_name == "f64":
        return inputs, out, None
    return inputs, out, np_tree(solve(*_cast((scen, first.primal, first.duals), jnp.float64)))


@pytest.mark.parametrize("path", ["unfused", "plain"])
@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_k2c_solve_matches_jax(case, dtype_name, path):
    assert all(getattr(J_WARM, k) == v for k, v in WARM.items())
    (scen, init, duals), j, j64 = jax_solves(case, dtype_name)
    _, spec = _specs(case)
    st = al_sqp.SolverSettings(**WARM)
    ts, ti, td = to_torch(scen, init, duals)
    assert k2a.fused_supported(spec) and k2a.fused_obstacles_supported(ts)
    if path == "unfused":
        solve = al_sqp.make_solver(spec, st, device="cpu")
    else:
        solve = functools.partial(k2a.fused_solve_plain, spec, st)
    before = riccati_cuda.lqr_solve_cuda.launches
    t = convert.to_numpy(solve(ts, ti, td))
    assert riccati_cuda.lqr_solve_cuda.launches == before  # CPU: the plain KKT solve
    ts_ulp = ()
    if dtype_name == "f32":
        ts_ulp = [convert.to_numpy(solve(ts, q, td)) for q in agreement.ulp_perturbed(ti)]
    lanes = assert_matches_jax(t, j, dtype_name, j64, ts_ulp)
    assert lanes.any()
    if dtype_name == "f64":
        assert 0 < j["converged"].sum() < B  # both outcomes are exercised
    assert (t["duals"]["mu_obs"] > 0).any()  # the obstacle rows are live
