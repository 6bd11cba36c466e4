"""One warm fleet cycle with the straggler rescue: the port against the JAX
package (CPU, f64).

Six lanes of the flagship at N=8 with 4 circle slots start from one result
state, handed to both packages through numpy: the port's 2×3 solve from the
straight-line seed, with lane 4 blown up (NaN controls and a NaN eq_norm) and
lane 5 pushed past the divergence threshold (eq_norm 0.9). One
``make_fleet_cycle`` step with ``make_rescue`` (2 slots) must advance the
converged lanes, continue the sane unconverged ones, reset lanes 4 and 5
(NaN-safe) and rescue the first two stragglers, exactly as the JAX cycle
does. Tolerance: 1e-9 absolute (f64; the same arithmetic in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_local_planner_tpu.benchmarks import config3_carlike_min_time as j_config3
from mpc_local_planner_tpu.benchmarks import random_ensemble as j_random_ensemble
from mpc_local_planner_tpu.geometry.obstacles import ObstacleSet as JObstacleSet
from mpc_local_planner_tpu.ocp.grid import Primal as JPrimal
from mpc_local_planner_tpu.ocp.spec import Scenario as JScenario
from mpc_local_planner_tpu.planner.cycle import make_fleet_cycle as j_make_fleet_cycle
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.solvers.rescue import make_rescue as j_make_rescue

from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time as t_config3
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle as t_make_fleet_cycle
from mpc_local_planner_tpu_torch.solvers import al_sqp as t_al
from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue as t_make_rescue

B, N, M = 6, 8, 4
SLOTS = 2
ATOL = 1e-9
COLD = dict(n_al=2, n_sqp=3, rho0=120.0, reg0=1.0, tol_eq=1e-2, tol_ineq=1e-2,
            alphas=(1.0, 0.5, 0.22))
WARM = dict(COLD, n_al=2, n_sqp=2)
RESCUE = dict(WARM, alphas=(1.0, 0.7, 0.5, 0.22))


def _np(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: _np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def _to_jax(cls, tree):
    """Nested numpy dict -> JAX dataclass (the JAX containers' field names)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = tree[f.name]
        kwargs[f.name] = _to_jax(_J_NESTED[(cls, f.name)], v) if isinstance(v, dict) else jnp.asarray(v)
    return cls(**kwargs)


_J_NESTED = {
    (JScenario, "obstacles"): JObstacleSet,
    (j_al.SolveResult, "primal"): JPrimal,
    (j_al.SolveResult, "duals"): j_al.DualState,
}


def _start_state():
    """(scenario, result) as numpy trees: the port's cold 2×3 solve, doctored."""
    jspec = j_config3(N=N, obstacle_cap=M)
    js = j_random_ensemble(jspec, B, jax.random.PRNGKey(3), dtype=jnp.float64)
    js = dataclasses.replace(js, xf=js.x0 + 0.3 * (js.xf - js.x0))
    scen = _np(js)
    tspec = t_config3(N=N, obstacle_cap=M)
    st = t_al.SolverSettings(**COLD)
    ts = convert.from_numpy(TScenario, scen, "cpu")
    init, duals = t_al.default_init(tspec, st, ts, dtype=torch.float64)
    r = convert.to_numpy(t_al.make_solver(tspec, st, device="cpu")(ts, init, duals))
    r["primal"]["us"][4] = np.nan
    r["eq_norm"][4] = np.nan
    r["converged"][4] = False
    r["eq_norm"][5] = 0.9
    r["converged"][5] = False
    return scen, r


def _cycle_torch(scen, r, rescue):
    tspec = t_config3(N=N, obstacle_cap=M)
    warm = t_al.SolverSettings(**WARM)
    duals0 = t_al.init_duals(tspec, warm, torch.float64, "cpu", batch=(B,))
    res = (
        t_make_rescue(tspec, warm, SLOTS, rescue_settings=t_al.SolverSettings(**RESCUE), device="cpu")
        if rescue else None
    )
    cycle = t_make_fleet_cycle(tspec, warm, duals0, rescue=res, device="cpu")
    s2, r2 = cycle(
        convert.from_numpy(TScenario, scen, "cpu"),
        convert.from_numpy(t_al.SolveResult, r, "cpu"),
    )
    return convert.to_numpy(s2), convert.to_numpy(r2)


def _cycle_jax(scen, r):
    jspec = j_config3(N=N, obstacle_cap=M)
    warm = j_al.SolverSettings(**WARM)
    duals0 = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), j_al.init_duals(jspec, warm, jnp.float64)
    )
    rescue = j_make_rescue(jspec, warm, SLOTS, rescue_settings=j_al.SolverSettings(**RESCUE))
    cycle = jax.jit(j_make_fleet_cycle(jspec, warm, duals0, rescue=rescue))
    s2, r2 = cycle(_to_jax(JScenario, scen), _to_jax(j_al.SolveResult, r))
    return _np(s2), _np(r2)


def _assert_trees_close(a, b, path=""):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _assert_trees_close(a[k], b[k], f"{path}.{k}")
        return
    assert a.shape == b.shape and a.dtype == b.dtype, path
    if a.dtype == np.bool_ or not np.issubdtype(a.dtype, np.floating):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=path)


def test_torch_fleet_cycle_with_rescue_matches_jax():
    scen, r = _start_state()
    conv = r["converged"]
    sane = (r["eq_norm"] <= 0.5) & (r["ineq_viol"] <= 0.5)  # False for NaN
    advance, reset = conv, ~sane
    cont = ~conv & sane
    assert advance.any() and cont.any()
    np.testing.assert_array_equal(np.flatnonzero(reset), [4, 5])

    ts2, tr2 = _cycle_torch(scen, r, rescue=True)
    js2, jr2 = _cycle_jax(scen, r)
    _assert_trees_close(ts2, js2)
    _assert_trees_close(tr2, jr2)

    # advanced lanes start one stage on, with the executed control as u_prev
    np.testing.assert_array_equal(ts2["x0"][advance], r["primal"]["xs"][advance, 1])
    np.testing.assert_array_equal(ts2["u_prev"][advance], r["primal"]["us"][advance, 0])
    np.testing.assert_array_equal(ts2["x0"][~advance], scen["x0"][~advance])
    assert np.all(np.isfinite(tr2["primal"]["us"][4]))  # the NaN lane was reset

    # the rescue re-solved exactly the first SLOTS stragglers of the warm solve
    _, tr_plain = _cycle_torch(scen, r, rescue=False)
    stragglers = np.flatnonzero(~tr_plain["converged"])
    assert len(stragglers) >= SLOTS
    changed = np.flatnonzero(
        np.any(tr2["primal"]["xs"] != tr_plain["primal"]["xs"], axis=(1, 2))
    )
    np.testing.assert_array_equal(changed, stragglers[:SLOTS])
    untouched = np.setdiff1d(np.arange(B), changed)
    _assert_trees_close(
        {k: tr2[k][untouched] for k in ("cost", "eq_norm", "converged")},
        {k: tr_plain[k][untouched] for k in ("cost", "eq_norm", "converged")},
    )
