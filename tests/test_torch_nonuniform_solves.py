"""Whole solves on the non-uniform per-stage dt grid on the CPU: the port's
un-fused ``solve`` (its KKT solve the plain ``lqr_solve`` with δdt_k as a
third control column, on any device, as the JAX solver runs it) and the
fused kernel's plain version ``fused_solve_plain`` against JAX
``vmap(solve_single)``, from identical inputs handed over through numpy;
then path E's fleet cycle against the JAX cycle.

- ``min_time`` and ``trapezoidal``: the problems of
  ``tests/test_fused_solver.py::test_fused_nonuniform_dt_matches_xla``
  (the flagship at N=8 with 3 circle slots, key 61, the seeded grid
  ``linspace(0.22, 0.38)``) and ``..._trapezoidal_quadratic_matches_xla``
  (config #2 with the integral trapezoidal form, hybrid weight 0.4, dt in
  [1e-3, 0.5], key 63). 24 lanes, goals pulled in to 30% of their
  distance, the warm settings of that file (2×3, 8 candidates), from one
  warm state: the JAX result of a first solve from that grid. Float64:
  states, controls, dt and cost on every lane at 1e-9; the multipliers at
  1e-9 + ρ·1e-13 plus ten times JAX's own largest move on that lane when
  its states start one ulp up or down (``MOVE_FACTOR``): the grid's steps
  are ill-conditioned, and JAX's own multipliers move past 1e-9 + ρ·1e-13
  under one ulp on half of these lanes (up to 9.2e-7 on the minimum-time
  case; the port's difference from JAX measured within 3.9 times the
  move). Float32:
  the parity tolerances of ``tests/test_torch_quadratic.py`` against JAX's
  float64 answer from the same inputs on the lanes float32 determines:
  both converged, JAX's float32 and float64 conv flags equal and its
  float32 answer within those tolerances of its float64 one, the port's
  solves from states one ulp up and down converged and within them of its
  own; the conv flags equal JAX's wherever float32 does not decide them
  (JAX's float32 and float64 flags agree, and the port's float32 flag
  agrees with its float64 one from the same inputs and with its one-ulp
  runs). On this grid a flag at the tolerance's edge can go either way in
  float32 (the trapezoidal case: the port's float32 solve converged a lane
  on which its float64 one, and JAX's in both types, did not).
- ``golden_min_time`` and ``golden_trapezoidal``: the problems of
  ``tests/test_nonuniform_grid.py`` (a unicycle to (2, 1, 0), N=12 and 10,
  minimum time and the trapezoidal quadratic form) solved cold from the
  straight-line seed, 4×10 at the settings of that file, float64 as above.
- ``trapezoidal`` at its full horizon: the spec of ``chip_smoke.py``'s
  ``nonuniform-trapezoidal-quadratic`` case (N=30, 10 circle slots), 64
  lanes of ``random_ensemble`` in a warm fleet state made in JAX as the
  smoke makes it (the cold preset's solve, two fleet cycles at the fleet's
  warm 3×4, then the next warm inputs), the warm 3×4 solve from it, float64
  as above, the states, controls and dt also with ten times JAX's own
  one-ulp move of them on the lane (on the lanes that did not converge it
  reaches 3.1e-10, and the port's difference 8.6 times that; on the
  converged ones both are under 1e-13). JAX converges under a quarter of
  these lanes (3 of 64), as the port does on the card (ROADMAP §3).
- Path E: ``family_spec("nonuniform")``'s fleet cycle at N=8 with
  ``stuck_restart``, the rescue chained twice and ``rho0_fail``, through
  ``tests/test_torch_k2c_cycle.py``'s harness, the multipliers with ten
  times JAX's own one-ulp move of its cycle as above.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.geometry.footprints import PointFootprint as JPoint
from mpc_local_planner_tpu.ocp.grid import Primal as JPrimal
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.ocp.grid import warm_start_resample as j_warm_start_resample
from mpc_local_planner_tpu.ocp.spec import OcpSpec as JOcpSpec
from mpc_local_planner_tpu.ocp.spec import Scenario as JScenario
from mpc_local_planner_tpu.planner.cycle import make_fleet_cycle as j_make_fleet_cycle
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.systems.models import RobotLimits as JLimits
from mpc_local_planner_tpu.systems.models import UnicycleModel as JUnicycle

import test_torch_k2c_cycle as cycle_harness
from test_fused_solver import WARM as J_WARM
from test_torch_cycle import _to_jax
from test_torch_k2c_cycle import RHO_ULP
from test_torch_k2c_solves import WARM, _cast
from test_torch_quadratic import TOL, _as, np_tree, to_torch
from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.geometry.footprints import PointFootprint as TPoint
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec as TOcpSpec
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp
from mpc_local_planner_tpu_torch.systems.models import RobotLimits as TLimits
from mpc_local_planner_tpu_torch.systems.models import UnicycleModel as TUnicycle

_J_TYPES = (JScenario, JPrimal, j_al.DualState)
N = 8
TRAPEZOIDAL = dict(integral_form=True, cost_integration="trapezoidal", hybrid_time_weight=0.4,
                   variable_dt=True, nonuniform_dt=True, dt_min=1e-3, dt_max=0.5)
# case: (the spec from a benchmarks module, ensemble key)
CASES = {
    "min_time": (lambda m: dataclasses.replace(m.config3_carlike_min_time(N=N, obstacle_cap=3),
                                               nonuniform_dt=True), 61),
    "trapezoidal": (lambda m: dataclasses.replace(
        m.config2_diffdrive_obstacles(N=N, obstacle_cap=3), **TRAPEZOIDAL), 63),
}
B = 24
MOVE_FACTOR = 10.0


def _jax_own_move(jsolve, scen, init, duals, j, part="duals"):
    """Per lane, the largest move of JAX's multipliers (``part="primal"``:
    of its states, controls and dt) when its solve starts from states one
    ulp up and one ulp down (numpy trees in and out)."""
    move = np.zeros(len(j["cost"]))
    for sign in (1.0, -1.0):
        up = dict(init, xs=init["xs"] * (1.0 + sign * np.finfo(init["xs"].dtype).eps))
        q = np_tree(jsolve(*(_to_jax(c, a) for c, a in zip(_J_TYPES, (scen, up, duals)))))
        for k, b in j[part].items():
            move = np.maximum(move, np.abs(q[part][k] - b).reshape(len(move), -1).max(
                axis=1, initial=0.0))
    return move


def _within(t, j, lanes, tol):
    """Lanes of ``lanes`` on which result trees ``t`` and ``j`` agree within
    the parity tolerances ``tol``."""
    n = len(lanes)
    ok = lanes.copy()
    for k in ("xs", "us", "dt"):
        ok &= np.all(np.abs(t["primal"][k] - j["primal"][k]).reshape(n, -1) <= tol[k], axis=1)
    ok &= np.abs(t["cost"] - j["cost"]) <= tol["cost"] + tol["cost_rel"] * np.abs(j["cost"])
    for k in j["duals"]:
        a, b = t["duals"][k].reshape(n, -1), j["duals"][k].reshape(n, -1)
        ok &= np.all(np.abs(a - b) <= np.maximum(tol["duals"], tol["rel"] * np.abs(b)), axis=1)
    return ok


def _assert_f32_matches_where_determined(t, j, j64, t64, ts_ulp):
    """The float32 rule of the module docstring (``t64``: the port's float64
    solve from the same inputs); returns the lanes held."""
    assert t["primal"]["xs"].dtype == j["primal"]["xs"].dtype == np.float32
    tol, ref = TOL["f32"], _as(j64, np.float32)
    decided = (j["converged"] == j64["converged"]) & (t["converged"] == t64["converged"])
    for q in ts_ulp:
        decided &= q["converged"] == t["converged"]
    np.testing.assert_array_equal(t["converged"][decided], j["converged"][decided])
    lanes = _within(ref, j, decided & t["converged"] & j["converged"], tol)
    for q in ts_ulp:
        lanes = _within(q, t, lanes, tol)
    np.testing.assert_array_equal(_within(t, ref, lanes, tol), lanes)
    assert lanes.any() and decided.sum() >= len(decided) // 2
    return lanes


def _assert_f64_matches_to_rounding(t, j, move, primal_move=0.0):
    """Conv flags equal; xs, us, dt and cost within 1e-9 (plus MOVE_FACTOR
    times ``primal_move``, JAX's own one-ulp move of them, where a caller
    measured it) on every lane; the multipliers within 1e-9 + ρ·1e-13 +
    MOVE_FACTOR times JAX's own one-ulp move on that lane
    (``_jax_own_move``)."""
    np.testing.assert_array_equal(t["converged"], j["converged"])
    tol_p = 1e-9 + MOVE_FACTOR * np.broadcast_to(primal_move, j["cost"].shape)
    for k in ("xs", "us", "dt"):
        assert t["primal"][k].dtype == j["primal"][k].dtype == np.float64
        err = np.abs(t["primal"][k] - j["primal"][k]).reshape(len(tol_p), -1).max(axis=1)
        assert np.all(err <= tol_p), (k, err, tol_p)
    np.testing.assert_allclose(t["cost"], j["cost"], atol=1e-9, rtol=0)
    tol = 1e-9 + RHO_ULP * j["duals"]["rho"] + MOVE_FACTOR * move
    for k, b in j["duals"].items():
        err = np.abs(t["duals"][k] - b).reshape(len(tol), -1).max(axis=1, initial=0.0)
        assert np.all(err <= tol), (k, err, tol)


@functools.lru_cache(maxsize=None)
def jax_solves(case, dtype_name):
    """The warm inputs (numpy trees), the JAX solve from them and, in
    float32, the JAX float64 solve from the same inputs."""
    jdtype = {"f32": jnp.float32, "f64": jnp.float64}[dtype_name]
    build, key = CASES[case]
    jspec = build(jb)
    scen = jb.random_ensemble(jspec, B, jax.random.PRNGKey(key))
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.3 * (scen.xf - scen.x0))
    init = j_initial_primal(jspec, scen)
    init = dataclasses.replace(init, dt=jnp.broadcast_to(
        jnp.linspace(0.22, 0.38, N, dtype=jnp.float32), (B, N)))
    duals = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                   j_al.init_duals(jspec, J_WARM, dtype=jnp.float32))
    scen, init, duals = _cast((scen, init, duals), jdtype)
    solve = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, J_WARM, s, i, d)))
    first = solve(scen, init, duals)
    inputs = (np_tree(scen), np_tree(first.primal), np_tree(first.duals))
    out = np_tree(solve(scen, first.primal, first.duals))
    if dtype_name == "f64":
        return inputs, out, _jax_own_move(solve, *inputs, out)
    return inputs, out, np_tree(solve(*_cast((scen, first.primal, first.duals), jnp.float64)))


def _solver(spec, st, path):
    if path == "unfused":
        return al_sqp.make_solver(spec, st, device="cpu")
    return functools.partial(k2a.fused_solve_plain, spec, st)


@pytest.mark.parametrize("path", ["unfused", "plain"])
@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_nonuniform_solve_matches_jax(case, dtype_name, path):
    assert all(getattr(J_WARM, k) == v for k, v in WARM.items())
    (scen, init, duals), j, j64 = jax_solves(case, dtype_name)  # f64: JAX's one-ulp move
    spec = CASES[case][0](tb)
    st = al_sqp.SolverSettings(**WARM)
    ts, ti, td = to_torch(scen, init, duals)
    assert tuple(ti.dt.shape) == (B, N) and tuple(td.mu_dt.shape) == (B, 2 * N)
    assert k2a.fused_supported(spec)
    solve = _solver(spec, st, path)
    before = riccati_cuda.lqr_solve_cuda.launches
    t = convert.to_numpy(solve(ts, ti, td))
    assert riccati_cuda.lqr_solve_cuda.launches == before  # the plain KKT solve
    if dtype_name == "f64":
        _assert_f64_matches_to_rounding(t, j, j64)
        assert 0 < j["converged"].sum() <= B
        # why the slack: JAX's own one-ulp move passes the strict tolerance
        assert (j64 > 1e-9 + RHO_ULP * j["duals"]["rho"]).any()
    else:
        ts_ulp = [convert.to_numpy(solve(ts, q, td)) for q in agreement.ulp_perturbed(ti)]
        t64 = convert.to_numpy(solve(*(tree_map(lambda a: a.double() if a.is_floating_point()
                                                else a, x) for x in (ts, ti, td))))
        _assert_f32_matches_where_determined(t, j, j64, t64, ts_ulp)
    # the per-stage dt moves stage by stage
    spread = t["primal"]["dt"].max(axis=-1) - t["primal"]["dt"].min(axis=-1)
    assert spread.max() > 1e-3


# --------------------------------------------------------------------------- #
# the golden problems, cold
# --------------------------------------------------------------------------- #
GOLDEN_SETTINGS = dict(n_al=4, n_sqp=10, rho0=10.0, rho_growth=5.0, rho_max=1e8,
                       tol_eq=1e-3, tol_ineq=1e-3)


def _golden_spec(problem, spec_cls, unicycle, point, limits_cls):
    """tests/test_nonuniform_grid.py's ``_min_time_spec`` (N=12), or its
    trapezoidal quadratic form (N=10)."""
    limits = limits_cls(max_vel_x=0.4, max_vel_x_backwards=0.2, max_vel_theta=0.3,
                        acc_lim_x=0.5, acc_lim_theta=0.5)
    spec = spec_cls(model=unicycle(), footprint=point(), N=12, objective="minimum_time",
                    variable_dt=True, nonuniform_dt=True, dt_min=1e-3, dt_max=1.0, dt_ref=0.3,
                    xf_fixed=(True, True, True), limits=limits)
    if problem == "golden_min_time":
        return spec
    return dataclasses.replace(
        spec, N=10, objective="quadratic_form", integral_form=True,
        cost_integration="trapezoidal", q_diag=(2.0, 2.0, 1.0), r_diag=(1.0, 0.5),
        qf_diag=(10.0, 10.0, 4.0), xf_fixed=(False, False, False), hybrid_time_weight=0.5)


@functools.lru_cache(maxsize=None)
def jax_golden(problem):
    jspec = _golden_spec(problem, JOcpSpec, JUnicycle, JPoint, JLimits)
    scen = JScenario.goal_only(x0=jnp.array([0.0, 0.0, 0.0]), xf=jnp.array([2.0, 1.0, 0.0]),
                               dtype=jnp.float64)
    scen = jax.tree_util.tree_map(lambda a: a[None], scen)
    st = j_al.SolverSettings(**GOLDEN_SETTINGS)
    init = j_initial_primal(jspec, scen)
    duals = jax.tree_util.tree_map(lambda a: a[None], j_al.init_duals(jspec, st, jnp.float64))
    solve = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, st, s, i, d)))
    inputs = (np_tree(scen), np_tree(init), np_tree(duals))
    out = np_tree(solve(scen, init, duals))
    return inputs, out, _jax_own_move(solve, *inputs, out)


@pytest.mark.parametrize("path", ["unfused", "plain"])
@pytest.mark.parametrize("problem", ["golden_min_time", "golden_trapezoidal"])
def test_torch_nonuniform_cold_golden_problem_matches_jax(problem, path):
    (scen, init, duals), j, move = jax_golden(problem)
    spec = _golden_spec(problem, TOcpSpec, TUnicycle, TPoint, TLimits)
    ts, ti, td = to_torch(scen, init, duals)
    t = convert.to_numpy(_solver(spec, al_sqp.SolverSettings(**GOLDEN_SETTINGS), path)(ts, ti, td))
    _assert_f64_matches_to_rounding(t, j, move)
    assert t["primal"]["dt"].shape == (1, spec.N)
    assert np.all(t["primal"]["dt"] >= spec.dt_min - 1e-12)
    assert np.all(t["primal"]["dt"] <= spec.dt_max + 1e-12)


# --------------------------------------------------------------------------- #
# the trapezoidal form at its full horizon, from a warm fleet state
# --------------------------------------------------------------------------- #
FULL_N, FULL_B = 30, 64
FLEET_WARM = dict(n_al=3, n_sqp=4, rho0=120.0, rho_growth=5.0, reg0=1.0, tol_eq=1e-3,
                  tol_ineq=1e-3, alphas=(1.0, 0.5, 0.22))


def _full_trapezoidal(m):
    return dataclasses.replace(m.config2_diffdrive_obstacles(N=FULL_N, obstacle_cap=10),
                               **TRAPEZOIDAL)


@functools.lru_cache(maxsize=None)
def jax_trapezoidal_warm_state():
    """The warm inputs (numpy trees), the JAX warm 3×4 solve from them and
    JAX's own one-ulp moves of its multipliers and of its primal (module
    docstring), in float64."""
    jspec = _full_trapezoidal(jb)
    scen = _cast(jb.random_ensemble(jspec, FULL_B, jax.random.PRNGKey(0)), jnp.float64)

    def batched_duals(st):
        return jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (FULL_B,) + a.shape),
                                      j_al.init_duals(jspec, st, dtype=jnp.float64))

    cold, warm = j_al.SolverSettings.for_spec(jspec), j_al.SolverSettings(**FLEET_WARM)
    r = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, cold, s, i, d)))(
        scen, j_initial_primal(jspec, scen), batched_duals(cold))
    solve = jax.vmap(lambda s, i, d: j_al.solve_single(jspec, warm, s, i, d))
    cycle = jax.jit(j_make_fleet_cycle(jspec, warm, batched_duals(warm), solve=solve))
    for _ in range(2):
        scen, r = cycle(scen, r)
    x0n = jnp.where(r.converged[:, None], r.primal.xs[:, 1, :], scen.x0)
    inputs = (np_tree(dataclasses.replace(scen, x0=x0n)),
              np_tree(j_warm_start_resample(r.primal, x0n, steps=1, spec=jspec)),
              np_tree(j_al.shift_duals(r.duals, warm, steps=1)))
    solve = jax.jit(solve)
    out = np_tree(solve(*(_to_jax(c, a) for c, a in zip(_J_TYPES, inputs))))
    return inputs, out, (_jax_own_move(solve, *inputs, out),
                         _jax_own_move(solve, *inputs, out, part="primal"))


@pytest.mark.parametrize("path", ["unfused", "plain"])
def test_torch_nonuniform_trapezoidal_warm_state_at_full_horizon_matches_jax(path):
    """The port's warm solve of the trapezoidal form at N=30 from JAX's warm
    fleet state agrees with JAX's to rounding, and converges as few lanes
    as JAX's."""
    (scen, init, duals), j, (move, primal_move) = jax_trapezoidal_warm_state()
    spec = _full_trapezoidal(tb)
    assert tuple(init["dt"].shape) == (FULL_B, FULL_N)
    t = convert.to_numpy(_solver(spec, al_sqp.SolverSettings(**FLEET_WARM), path)(
        *to_torch(scen, init, duals)))
    _assert_f64_matches_to_rounding(t, j, move, primal_move)
    # the form converges few lanes at the warm 3×4, in JAX as on the card
    assert 0 < j["converged"].sum() < FULL_B // 4
    spread = t["primal"]["dt"].max(axis=-1) - t["primal"]["dt"].min(axis=-1)
    assert spread.max() > 1e-3


# --------------------------------------------------------------------------- #
# path E's fleet cycle
# --------------------------------------------------------------------------- #
def test_torch_nonuniform_fleet_cycle_with_stuck_restart_matches_jax():
    """Path E's cycle (``family_spec("nonuniform")``: the flagship on the
    non-uniform grid, ``random_ensemble``'s scenarios) against the JAX
    cycle from one start state: the per-stage dt resampled on the advanced
    lanes, the 2N dt-box multipliers shifted with the grid, the rest as
    ``tests/test_torch_k2c_cycle.py`` holds the K2c paths."""
    family = "nonuniform"
    paths = dict(cycle_harness.PATHS, nonuniform=(7, 300.0))
    scen, r, stuck = cycle_harness._start_state(family, paths)
    assert r["primal"]["dt"].shape == (cycle_harness.B, cycle_harness.N)
    diverged = ~((r["eq_norm"] <= 0.5) & (r["ineq_viol"] <= 0.5))
    assert r["converged"].any() and np.array_equal(np.flatnonzero(diverged), [4, 5])
    torch_out = cycle_harness._cycle_torch(family, scen, r, stuck, paths)
    jax_out = cycle_harness._cycle_jax(family, scen, r, stuck, paths)
    move = np.zeros(cycle_harness.B)
    eps = np.finfo(np.float64).eps
    for sign in (1.0, -1.0):
        # JAX's own move from the result's states one ulp up and down, and
        # from the goals one ulp up and down (the seed a restarted lane takes)
        r_ulp = dict(r, primal=dict(r["primal"], xs=r["primal"]["xs"] * (1.0 + sign * eps)))
        scen_ulp = dict(scen, xf=scen["xf"] * (1.0 + sign * eps))
        for sc, rr in ((scen, r_ulp), (scen_ulp, r)):
            q = cycle_harness._cycle_jax(family, sc, rr, stuck, paths)[1]["duals"]
            for k, b in jax_out[1]["duals"].items():
                move = np.maximum(move, np.abs(q[k] - b).reshape(len(move), -1).max(
                    axis=1, initial=0.0))
    cycle_harness.assert_cycles_match(scen, r, stuck, torch_out, jax_out,
                                      dual_slack=MOVE_FACTOR * move)
    assert torch_out[1]["primal"]["dt"].shape == (cycle_harness.B, cycle_harness.N)
    assert torch_out[1]["duals"]["mu_dt"].shape == (cycle_harness.B, 2 * cycle_harness.N)
