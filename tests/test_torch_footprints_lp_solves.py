"""Whole solves with the line and polygon footprints on the CPU: the port's
un-fused ``solve`` and the fused kernel's plain version
``fused_solve_plain`` against JAX ``vmap(solve_single)``, from identical
inputs handed over through numpy.

Cases: the polygon-footprint family (``family_spec("polygon_footprint")``,
its own ensemble: 8 circle slots), and, as ``tests/test_fused_solver.py``
draws them (``_widened_setup``), a line footprint and a polygon footprint
each with all four slot families moving, and an 8-vertex polygon (the
kernel's limit) with all four families static and a varying vertex count.
Twelve lanes at N=8, goals pulled in to 30% of their distance, the warm
settings of that file (2×3, 8 candidates), from one warm state: the JAX
result of a first solve from the straight-line seed.

- float64: every lane at 1e-9 (xs, us, dt, cost), the multipliers at
  1e-9 + ρ·1e-13 (the rule of ``tests/test_torch_k2c_cycle.py``: a dual
  update adds ρ times the constraint rows, and ρ reaches 7.5e4 on the line
  footprint's lanes, where the states agree to 1e-13 and the box
  multipliers to 1.3e-9), identical conv flags.
- float32: conv flags equal to JAX's, and the parity tolerances of
  ``tests/test_torch_quadratic.py`` between the port's float32 answer and
  JAX's float64 answer from the same float32 inputs, on the lanes both
  converged where JAX's float32 answer meets those tolerances against its
  float64 one and the port's solves from states one ulp up and down meet
  them against its own: the port is held to the answer rounding does not
  decide, by the standard JAX's float32 solve meets. Against JAX's float32
  answer (``assert_matches_jax``) two rounded answers can sit further apart
  than either from the float64 one: on a lane of the line footprint at
  ρ = 7.5e4 the multipliers of the two float32 solves are 7.2e-3 apart,
  each within 4.8e-3 of the float64 answer. Those filters keep at least
  half of the lanes both converged, and the lanes they leave out are held
  too: states, dt and cost within the tolerances of the float64 answer,
  the multipliers within the tolerance plus twice JAX's own float32
  distance from it on that lane (on this file's cases the port's
  multipliers there are at most 7.1e-3 from the float64 answer, where
  JAX's float32 ones are 7.1e-3 from it too).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.geometry import footprints as jfp
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.solvers import al_sqp as j_al

from test_fused_solver import WARM as J_WARM
from test_fused_solver import _widened_setup
from test_torch_k2c_cycle import RHO_ULP
from test_torch_k2c_solves import WARM, _cast
from test_torch_quadratic import TOL, B, _as, lanes_within, np_tree, to_torch
from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.geometry import footprints as tfp
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp

N = 8
OCTAGON = tuple((0.3 * math.cos(2 * math.pi * i / 8), 0.2 * math.sin(2 * math.pi * i / 8))
                for i in range(8))
# case: (footprint name and arguments or None for the family's, key, slot
# mix for _widened_setup or None for the family's ensemble, dynamic)
CASES = {
    "polygon_family": (None, 5, None, False),
    "line_mixed_dynamic": (("LineFootprint", dict(line_start=(-0.1, 0.0), line_end=(0.35, 0.0))),
                           37, dict(mp=1, mc=2, ml=2, mg=1, V=4), True),
    "polygon_mixed_dynamic": (("PolygonFootprint", dict(vertices=(
        (-0.15, -0.1), (0.25, -0.1), (0.25, 0.1), (-0.15, 0.1)))),
        53, dict(mp=1, mc=1, ml=1, mg=1, V=4), True),
    "octagon": (("PolygonFootprint", dict(vertices=OCTAGON)), 55,
                dict(mp=1, mc=2, ml=1, mg=1, V=4, vary_nv=True), False),
}
# this file's cases; tests/test_torch_footprints_lp_mixed.py runs the rest
# (two files, so that a parallel run spreads the JAX compiles)
HERE = ("polygon_family", "octagon")


def _specs(case):
    fp, _, fam, dyn = CASES[case]
    if fp is None:
        return jb.family_spec("polygon_footprint", N=N), tb.family_spec("polygon_footprint", N=N)
    name, kw = fp
    M = sum(fam.get(k, 0) for k in ("mp", "mc", "ml", "mg"))
    tspec = dataclasses.replace(tb.config3_carlike_min_time(N=N, obstacle_cap=M),
                                footprint=getattr(tfp, name)(**kw),
                                enable_dynamic_obstacles=dyn)
    return getattr(jfp, name)(**kw), tspec


# the jitted JAX solve of each case, shared by both dtypes (one float64
# compile serves the float64 test and the float32 test's reference)
_JAX_SOLVERS = {}


@functools.lru_cache(maxsize=None)
def jax_solves(case, dtype_name):
    """The warm inputs (numpy trees), the JAX solve from them and, in
    float32, the JAX float64 solve from the same inputs."""
    jdtype = {"f32": jnp.float32, "f64": jnp.float64}[dtype_name]
    jfp_, _ = _specs(case)
    _, key, fam, dyn = CASES[case]
    if fam is None:
        jspec = jfp_
        scen = jb.family_ensemble("polygon_footprint", jspec, B, jax.random.PRNGKey(key))
        duals = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (B,) + a.shape),
            j_al.init_duals(jspec, J_WARM, dtype=jnp.float32))
    else:
        jspec, scen, _, duals = _widened_setup(jfp_, key=key, batch=B, N=N, dyn=dyn, **fam)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.3 * (scen.xf - scen.x0))
    scen, duals = _cast((scen, duals), jdtype)
    init = j_initial_primal(jspec, scen)
    solve = _JAX_SOLVERS.setdefault(
        case, jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, J_WARM, s, i, d))))
    first = solve(scen, init, duals)
    inputs = (np_tree(scen), np_tree(first.primal), np_tree(first.duals))
    out = np_tree(solve(scen, first.primal, first.duals))
    if dtype_name == "f64":
        return inputs, out, None
    return inputs, out, np_tree(solve(*_cast((scen, first.primal, first.duals), jnp.float64)))


def _assert_f64_matches(t, j):
    """Every lane: conv flags equal, xs, us, dt and cost within 1e-9, the
    multipliers within 1e-9 + ρ·1e-13."""
    np.testing.assert_array_equal(t["converged"], j["converged"])
    for k in ("xs", "us", "dt"):
        assert t["primal"][k].dtype == j["primal"][k].dtype == np.float64
        np.testing.assert_allclose(t["primal"][k], j["primal"][k], atol=1e-9, rtol=0, err_msg=k)
    np.testing.assert_allclose(t["cost"], j["cost"], atol=1e-9, rtol=0)
    tol = 1e-9 + RHO_ULP * j["duals"]["rho"]
    for k, b in j["duals"].items():
        err = np.abs(t["duals"][k] - b).reshape(len(tol), -1).max(axis=1, initial=0.0)
        assert np.all(err <= tol), (k, err, tol)


def _assert_f32_matches(t, j, j64, ts_ulp):
    """Conv flags equal to JAX's; on the lanes both converged where JAX's
    float32 answer lies within the parity tolerances of JAX's float64 answer
    from the same inputs, and the port's solves from states one ulp up and
    down lie within them of its own, the port's float32 answer lies within
    them of that float64 answer. Those lanes are at least half of the lanes
    both converged; on the rest the port's states, dt and cost lie within
    the tolerances of the float64 answer and its multipliers within the
    tolerance plus twice the distance of JAX's float32 multipliers from it
    on that lane. Returns the lanes held to the tolerances."""
    np.testing.assert_array_equal(t["converged"], j["converged"])
    assert t["primal"]["xs"].dtype == j["primal"]["xs"].dtype == np.float32
    tol, ref = TOL["f32"], _as(j64, np.float32)
    both = t["converged"] & j["converged"]
    lanes = lanes_within(ref, j, both, tol)
    for q in ts_ulp:
        lanes = lanes_within(q, t, lanes, tol)
    np.testing.assert_array_equal(lanes_within(t, ref, lanes, tol), lanes)
    assert 2 * int(lanes.sum()) >= int(both.sum()) > 0, (int(lanes.sum()), int(both.sum()))
    rest = both & ~lanes
    np.testing.assert_array_equal(lanes_within(t, ref, rest, dict(tol, duals=np.inf)), rest)
    for k, b in ref["duals"].items():
        b = b.reshape(B, -1)
        own = np.abs(j["duals"][k].reshape(B, -1) - b).max(axis=1, initial=0.0)[:, None]
        bound = np.maximum(tol["duals"], tol["rel"] * np.abs(b)) + 2.0 * own
        err = np.abs(t["duals"][k].reshape(B, -1) - b)
        assert np.all((err <= bound)[rest]), (k, err[rest].max(initial=0.0))
    return lanes


def check_solve(case, dtype_name, path):
    """The port's solve on ``path`` against the JAX solve of ``jax_solves``."""
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

    if dtype_name == "f64":
        _assert_f64_matches(t, j)
        assert 0 < j["converged"].sum() <= B
    else:
        _assert_f32_matches(t, j, j64, ts_ulp)
    assert (t["duals"]["mu_obs"] > 0).any()  # the obstacle rows are live


@pytest.mark.parametrize("path", ["unfused", "plain"])
@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("case", HERE)
def test_torch_footprint_solve_matches_jax(case, dtype_name, path):
    check_solve(case, dtype_name, path)
