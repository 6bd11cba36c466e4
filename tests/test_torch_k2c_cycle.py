"""The fleet cycles of the three K2c paths on the CPU, against the JAX
cycle (float64): the reference's car-like config
(``family_spec("canonical_carlike")``: the two-disc footprint, 8 circle
slots), the wall world (``family_spec("converter_lines")``: 6 line slots
from the wall sampler) and the polygon-footprint family
(``family_spec("polygon_footprint")``: a 0.5 × 0.3 m rectangle, 8 circle
slots), each with ``stuck_restart=2`` and the rescue chained twice per
cycle, as bench.py's families mode drives the wall world; the car-like and
polygon cycles also with ``rho0_fail``.

Six lanes at N=8 start from one result state handed to both packages
through numpy (goals pulled in to 30% of their distance): the port's 2×3
solve from the straight-line seed, with lane
4 blown up (NaN controls and eq_norm), lane 5 past the divergence
threshold, lanes 1 and 3 unconverged but sane, and a consecutive-failure
count that has reached 2 on lane 1. The cycle must advance the converged
lanes, continue lane 3, restart lane 1 (stuck) and lanes 4 and 5 (diverged)
from the fresh seed, rescue the stragglers twice, and count the failures
on, as the JAX cycle does. States, controls, dt and the norms agree within
1e-9 absolute or 1e-12 relative, the multipliers within 1e-9 + ρ·1e-13
(ρ times the states' rounding), the counts and flags exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp.spec import Scenario as JScenario
from mpc_local_planner_tpu.planner.cycle import make_fleet_cycle as j_make_fleet_cycle
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.solvers.rescue import make_rescue as j_make_rescue

from test_torch_cycle import _np, _to_jax
from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle as t_make_fleet_cycle
from mpc_local_planner_tpu_torch.solvers import al_sqp as t_al
from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue as t_make_rescue

B, N = 6, 8
SLOTS = 2
CHAIN = 2
STUCK_RESTART = 2
COLD = dict(n_al=2, n_sqp=3, rho0=120.0, reg0=1.0, tol_eq=1e-2, tol_ineq=1e-2,
            alphas=(1.0, 0.5, 0.22))
WARM = dict(COLD, n_al=2, n_sqp=2)
RESCUE = dict(WARM, alphas=(1.0, 0.7, 0.5, 0.22))
ATOL, RTOL = 1e-9, 1e-12
# multipliers: 1e-9 + ρ·1e-13 per lane. A dual update adds ρ times the
# constraint rows, ρ reaches ρ_max = 1e6 on the wall world, and the states
# agree to rounding (4e-13 there), so ρ times their rounding is 1e-8.
RHO_ULP = 1e-13
# family: (ensemble key, rho0_fail)
PATHS = {"canonical_carlike": (7, 300.0), "converter_lines": (7, 0.0),
         "polygon_footprint": (7, 300.0)}


def _assert_trees_close(a, b, path=""):
    """Float leaves within 1e-9 absolute or 1e-12 relative (the multipliers
    grow past 1e3 in the chained rescues, where 1e-9 is a few ulps), the
    rest equal."""
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _assert_trees_close(a[k], b[k], f"{path}.{k}")
        return
    assert a.shape == b.shape and a.dtype == b.dtype, path
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=path)
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def _start_state(family, paths=PATHS):
    key, _ = paths[family]
    jspec = jb.family_spec(family, N=N)
    js = jb.family_ensemble(family, jspec, B, jax.random.PRNGKey(key), dtype=jnp.float64)
    x0 = js.x0[:, None, :2]  # goals and via points pulled in to 30%
    vxy = x0 + 0.3 * (js.via_points[..., :2] - x0)
    js = dataclasses.replace(js, xf=js.x0 + 0.3 * (js.xf - js.x0), via_points=jnp.concatenate(
        [vxy, js.via_points[..., 2:]], axis=-1))
    scen = _np(js)
    tspec = tb.family_spec(family, N=N)
    st = t_al.SolverSettings(**COLD)
    ts = convert.from_numpy(TScenario, scen, "cpu")
    init, duals = t_al.default_init(tspec, st, ts, dtype=torch.float64)
    r = convert.to_numpy(t_al.make_solver(tspec, st, device="cpu")(ts, init, duals))
    r["primal"]["us"][4] = np.nan
    r["eq_norm"][4] = np.nan
    r["converged"][4] = False
    r["eq_norm"][5] = 0.9
    r["converged"][5] = False
    for lane in (1, 3):
        r["converged"][lane] = False
        r["eq_norm"][lane] = min(float(r["eq_norm"][lane]), 0.4)
        r["ineq_viol"][lane] = min(float(r["ineq_viol"][lane]), 0.4)
    stuck = np.array([0, 2, 0, 1, 0, 1], dtype=np.int32)
    return scen, r, stuck


def _cycle_torch(family, scen, r, stuck, paths=PATHS):
    tspec = tb.family_spec(family, N=N)
    warm = t_al.SolverSettings(**WARM)
    duals0 = t_al.init_duals(tspec, warm, torch.float64, "cpu", batch=(B,))
    rescue = t_make_rescue(
        tspec, warm, SLOTS, rescue_settings=t_al.SolverSettings(**RESCUE), device="cpu"
    )

    def chained(s, res):
        for _ in range(CHAIN):
            res = rescue(s, res)
        return res

    cycle = t_make_fleet_cycle(tspec, warm, duals0, rescue=chained, device="cpu",
                               rho0_fail=paths[family][1], stuck_restart=STUCK_RESTART)
    s2, r2, k2 = cycle(
        convert.from_numpy(TScenario, scen, "cpu"),
        convert.from_numpy(t_al.SolveResult, r, "cpu"),
        torch.from_numpy(stuck),
    )
    return convert.to_numpy(s2), convert.to_numpy(r2), k2.numpy()


def _cycle_jax(family, scen, r, stuck, paths=PATHS):
    jspec = jb.family_spec(family, N=N)
    warm = j_al.SolverSettings(**WARM)
    duals0 = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), j_al.init_duals(jspec, warm, jnp.float64)
    )
    rescue = j_make_rescue(jspec, warm, SLOTS, rescue_settings=j_al.SolverSettings(**RESCUE))

    def chained(s, res):
        for _ in range(CHAIN):
            res = rescue(s, res)
        return res

    cycle = jax.jit(j_make_fleet_cycle(jspec, warm, duals0, rescue=chained,
                                       rho0_fail=paths[family][1],
                                       stuck_restart=STUCK_RESTART))
    s2, r2, k2 = cycle(_to_jax(JScenario, scen), _to_jax(j_al.SolveResult, r), jnp.asarray(stuck))
    return _np(s2), _np(r2), np.asarray(k2)


@pytest.mark.parametrize("family", sorted(PATHS))
def test_torch_k2c_fleet_cycle_with_stuck_restart_matches_jax(family):
    scen, r, stuck = _start_state(family)
    advance = r["converged"]
    diverged = ~((r["eq_norm"] <= 0.5) & (r["ineq_viol"] <= 0.5))
    np.testing.assert_array_equal(np.flatnonzero(diverged), [4, 5])
    assert advance.any() and (~advance & ~diverged & (stuck < STUCK_RESTART)).any()

    assert_cycles_match(scen, r, stuck, _cycle_torch(family, scen, r, stuck),
                        _cycle_jax(family, scen, r, stuck))


def assert_cycles_match(scen, r, stuck, torch_out, jax_out, dual_slack=0.0):
    """The port's cycle against the JAX cycle from one start state: trees,
    multipliers and counts as the module docstring says (the multipliers
    with ``dual_slack`` more per lane where a caller measured JAX's own
    rounding move); the lanes advanced, continued or restarted as the
    policy says."""
    (ts2, tr2, tk2), (js2, jr2, jk2) = torch_out, jax_out
    advance = r["converged"]
    diverged = ~((r["eq_norm"] <= 0.5) & (r["ineq_viol"] <= 0.5))
    _assert_trees_close(ts2, js2)
    _assert_trees_close({k: v for k, v in tr2.items() if k != "duals"},
                        {k: v for k, v in jr2.items() if k != "duals"})
    tol = ATOL + RHO_ULP * jr2["duals"]["rho"] + dual_slack
    for k, b in jr2["duals"].items():
        a = tr2["duals"][k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        err = np.abs(a - b).reshape(B, -1).max(axis=1, initial=0.0)
        assert np.all(err <= tol), (k, err, tol)
    np.testing.assert_array_equal(tk2, jk2)
    assert tk2.dtype == np.int32
    # restarted (stuck or diverged) and converged lanes start a new count
    restarted = diverged | (stuck >= STUCK_RESTART)
    np.testing.assert_array_equal(tk2[restarted | tr2["converged"]], 0)
    np.testing.assert_array_equal(tk2[~restarted & ~tr2["converged"]],
                                  stuck[~restarted & ~tr2["converged"]] + 1)
    assert np.all(np.isfinite(tr2["primal"]["us"][4]))  # the NaN lane was reset
    np.testing.assert_array_equal(ts2["x0"][advance], r["primal"]["xs"][advance, 1])
    np.testing.assert_array_equal(ts2["x0"][~advance], scen["x0"][~advance])
