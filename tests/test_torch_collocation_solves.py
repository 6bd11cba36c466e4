"""Whole solves under the midpoint and Crank–Nicolson rules and on shooting
grids on the CPU: the port's un-fused ``solve`` (AD derivatives, the −E⁻¹
fold of ``_kkt_system``) and the fused kernel's plain version
``fused_solve_plain`` (the kernel's closed forms: the fold, the tableau
walk) against JAX ``vmap(solve_single)``, from identical inputs handed over
through numpy; then two fleet cycles of the Crank–Nicolson flagship
against the JAX cycle.

- The flagship at N=8 with midpoint and Crank–Nicolson differences (4
  circle slots, key 41) and on the ``shooting_rk4`` and
  ``shooting_rk2_heun`` grids (2 slots, key 59): the problems of
  ``tests/test_fused_solver.py::test_fused_collocation_rules_match_xla``
  and ``::test_fused_shooting_matches_xla``, 12 lanes, goals pulled in to
  30% of their distance, the warm settings of that file (2×3, 8
  candidates), from one warm state: the JAX result of a first solve from
  the straight-line seed. Float64 on every lane at 1e-9; float32 with
  ``tests/test_torch_quadratic.py``'s tolerances on the lanes float32
  determines (``assert_matches_jax``).
- Two combinations: config #2 (unicycle, quadratic form, Qf, ball, fixed
  dt) with Crank–Nicolson, and midpoint differences on the non-uniform
  grid (``family_spec("nonuniform")``), in float64: states, controls, dt
  and cost at 1e-9, the multipliers at 1e-9 + ρ·1e-13 plus ten times
  JAX's own one-ulp move on the lane, as
  ``tests/test_torch_nonuniform_solves.py`` holds that grid.
- The Crank–Nicolson flagship's fleet cycle, twice in a row, through
  ``tests/test_torch_k2c_cycle.py``'s harness (stuck restart, the rescue
  chained twice, ``rho0_fail``): the port's warm solve the kernel's plain
  version, as the fused path runs it, the JAX cycle its XLA path.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.ocp.spec import Scenario as JScenario
from mpc_local_planner_tpu.planner.cycle import make_fleet_cycle as j_make_fleet_cycle
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.solvers.rescue import make_rescue as j_make_rescue

import test_torch_k2c_cycle as k2c_cycle
from test_torch_cycle import _np, _to_jax
from test_torch_nonuniform_solves import _J_TYPES, _assert_f64_matches_to_rounding, _jax_own_move
from test_torch_quadratic import WARM, _as, assert_matches_jax, np_tree, to_torch
from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle as t_make_fleet_cycle
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp
from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue as t_make_rescue

B, N = 12, 8  # B: test_torch_quadratic's lanes, whose comparisons this file takes
# case: (spec maker on a benchmarks module, ensemble key)
CASES = {
    "midpoint": (lambda m: dataclasses.replace(
        m.config3_carlike_min_time(N=N, obstacle_cap=4), collocation="midpoint_differences"), 41),
    "crank_nicolson": (lambda m: dataclasses.replace(
        m.config3_carlike_min_time(N=N, obstacle_cap=4),
        collocation="crank_nicolson_differences"), 41),
    "shooting_rk4": (lambda m: dataclasses.replace(
        m.config3_carlike_min_time(N=N, obstacle_cap=2), collocation="shooting_rk4"), 59),
    "shooting_rk2_heun": (lambda m: dataclasses.replace(
        m.config3_carlike_min_time(N=N, obstacle_cap=2), collocation="shooting_rk2_heun"), 59),
    "config2_crank_nicolson": (lambda m: dataclasses.replace(
        m.config2_diffdrive_obstacles(N=N, obstacle_cap=4),
        collocation="crank_nicolson_differences"), 3),
    "nonuniform_midpoint": (lambda m: dataclasses.replace(
        m.family_spec("nonuniform", N=N), collocation="midpoint_differences"), 61),
}
RULES = ("midpoint", "crank_nicolson", "shooting_rk4", "shooting_rk2_heun")
COMBINATIONS = ("config2_crank_nicolson", "nonuniform_midpoint")


@functools.lru_cache(maxsize=None)
def jax_solves(case, dtype_name):
    """The warm inputs (numpy trees) and the JAX solve from them (a first
    2×3 solve from the straight-line seed, then the compared one); in
    float32 also the JAX float64 solve from the same inputs, in float64
    JAX's own one-ulp move of its multipliers per lane."""
    jdtype = {"f32": jnp.float32, "f64": jnp.float64}[dtype_name]
    build, key = CASES[case]
    jspec = build(jb)
    scen = jb.random_ensemble(jspec, B, jax.random.PRNGKey(key), dtype=jdtype)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.3 * (scen.xf - scen.x0))
    jst = j_al.SolverSettings(**WARM)
    duals = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), j_al.init_duals(jspec, jst, jdtype))
    solve = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, jst, s, i, d)))
    first = solve(scen, j_initial_primal(jspec, scen), duals)
    inputs = (np_tree(scen), np_tree(first.primal), np_tree(first.duals))
    out = np_tree(solve(scen, first.primal, first.duals))
    if dtype_name == "f64":
        return inputs, out, _jax_own_move(solve, *inputs, out)
    up = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        (scen, first.primal, first.duals))
    return inputs, out, np_tree(solve(*up))


def _solve(case, path, dtype_name):
    (scen, init, duals), j, extra = jax_solves(case, dtype_name)
    spec = CASES[case][0](tb)
    st = al_sqp.SolverSettings(**WARM)
    if path == "unfused":
        solve = al_sqp.make_solver(spec, st, device="cpu")
    else:
        solve = functools.partial(k2a.fused_solve_plain, spec, st)
    ts, ti, td = to_torch(scen, init, duals)
    before = riccati_cuda.lqr_solve_cuda.launches
    t = convert.to_numpy(solve(ts, ti, td))
    assert riccati_cuda.lqr_solve_cuda.launches == before  # CPU: the plain KKT solve
    return solve, (ts, ti, td), t, j, extra


@pytest.mark.parametrize("path", ["unfused", "plain"])
@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("case", RULES)
def test_torch_collocation_solve_matches_jax(case, dtype_name, path):
    solve, (ts, ti, td), t, j, extra = _solve(case, path, dtype_name)
    ts_ulp = ()
    if dtype_name == "f32":
        ts_ulp = [convert.to_numpy(solve(ts, q, td)) for q in agreement.ulp_perturbed(ti)]
        lanes = assert_matches_jax(t, j, dtype_name, extra, ts_ulp)
    else:
        lanes = assert_matches_jax(t, j, dtype_name)
    assert lanes.any() and 0 < j["converged"].sum() < B  # both outcomes are exercised


@pytest.mark.parametrize("path", ["unfused", "plain"])
@pytest.mark.parametrize("case", COMBINATIONS)
def test_torch_collocation_combination_solve_matches_jax(case, path):
    _, _, t, j, move = _solve(case, path, "f64")
    _assert_f64_matches_to_rounding(t, j, move)
    assert j["converged"].any()
    if case == "config2_crank_nicolson":  # the fixed dt stays at dt_ref
        np.testing.assert_array_equal(t["primal"]["dt"], np.full(B, 0.3))
    else:  # a dt per stage that moves
        assert t["primal"]["dt"].shape == (B, N) and np.ptp(t["primal"]["dt"]) > 0.0


# --------------------------------------------------------------------------- #
# the Crank–Nicolson flagship's fleet cycle
# --------------------------------------------------------------------------- #
RHO0_FAIL = 300.0
B_CYCLE = k2c_cycle.B


def _cn_spec(m):
    return dataclasses.replace(m.config3_carlike_min_time(N=N, obstacle_cap=8),
                               collocation="crank_nicolson_differences")


def _start_state():
    """``test_torch_k2c_cycle``'s start state on the Crank–Nicolson
    flagship (``random_ensemble``, key 7): the port's cold 2×3 solve, lane 4
    blown up, lane 5 diverged, lanes 1 and 3 unconverged and sane, lane 1
    stuck at the restart count."""
    js = jb.random_ensemble(_cn_spec(jb), B_CYCLE, jax.random.PRNGKey(7), dtype=jnp.float64)
    scen = _np(dataclasses.replace(js, xf=js.x0 + 0.3 * (js.xf - js.x0)))
    tspec = _cn_spec(tb)
    st = al_sqp.SolverSettings(**k2c_cycle.COLD)
    ts = convert.from_numpy(TScenario, scen, "cpu")
    init, duals = al_sqp.default_init(tspec, st, ts, dtype=torch.float64)
    r = convert.to_numpy(al_sqp.make_solver(tspec, st, device="cpu")(ts, init, duals))
    r["primal"]["us"][4] = np.nan
    r["eq_norm"][4] = np.nan
    r["converged"][4] = False
    r["eq_norm"][5] = 0.9
    r["converged"][5] = False
    for lane in (1, 3):
        r["converged"][lane] = False
        r["eq_norm"][lane] = min(float(r["eq_norm"][lane]), 0.4)
        r["ineq_viol"][lane] = min(float(r["ineq_viol"][lane]), 0.4)
    return scen, r, np.array([0, 2, 0, 1, 0, 1], dtype=np.int32)


def _chained(rescue):
    def chained(s, res):
        for _ in range(k2c_cycle.CHAIN):
            res = rescue(s, res)
        return res

    return chained


def _torch_cycle():
    tspec = _cn_spec(tb)
    warm = al_sqp.SolverSettings(**k2c_cycle.WARM)
    duals0 = al_sqp.init_duals(tspec, warm, torch.float64, "cpu", batch=(B_CYCLE,))
    rescue = t_make_rescue(tspec, warm, k2c_cycle.SLOTS,
                           rescue_settings=al_sqp.SolverSettings(**k2c_cycle.RESCUE),
                           device="cpu")
    plain = functools.partial(k2a.fused_solve_plain, tspec, warm)
    cycle = t_make_fleet_cycle(tspec, warm, duals0, solve=plain, rescue=_chained(rescue),
                               device="cpu", rho0_fail=RHO0_FAIL,
                               stuck_restart=k2c_cycle.STUCK_RESTART)

    def run(scen, r, stuck):
        s2, r2, k2 = cycle(convert.from_numpy(TScenario, scen, "cpu"),
                           convert.from_numpy(al_sqp.SolveResult, r, "cpu"),
                           torch.from_numpy(stuck))
        return convert.to_numpy(s2), convert.to_numpy(r2), k2.numpy()

    return run


def _jax_cycle():
    jspec = _cn_spec(jb)
    warm = j_al.SolverSettings(**k2c_cycle.WARM)
    duals0 = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B_CYCLE,) + a.shape),
                                    j_al.init_duals(jspec, warm, jnp.float64))
    rescue = j_make_rescue(jspec, warm, k2c_cycle.SLOTS,
                           rescue_settings=j_al.SolverSettings(**k2c_cycle.RESCUE))
    cycle = jax.jit(j_make_fleet_cycle(jspec, warm, duals0, rescue=_chained(rescue),
                                       rho0_fail=RHO0_FAIL,
                                       stuck_restart=k2c_cycle.STUCK_RESTART))

    def run(scen, r, stuck):
        s2, r2, k2 = cycle(_to_jax(JScenario, scen), _to_jax(j_al.SolveResult, r),
                           jnp.asarray(stuck))
        return _np(s2), _np(r2), np.asarray(k2)

    return run


def test_torch_crank_nicolson_fleet_cycles_match_jax():
    """Two cycles in a row from the start state: the port's warm solve the
    kernel's plain version (the fused path's math), its rescue the
    un-fused solve, against the JAX cycle; the second cycle starts from
    the first's JAX state."""
    scen, r, stuck = _start_state()
    torch_cycle, jax_cycle = _torch_cycle(), _jax_cycle()
    for _ in range(2):
        t_out, j_out = torch_cycle(scen, r, stuck), jax_cycle(scen, r, stuck)
        k2c_cycle.assert_cycles_match(scen, r, stuck, t_out, j_out)
        scen, r, stuck = j_out
    assert r["converged"].any()
