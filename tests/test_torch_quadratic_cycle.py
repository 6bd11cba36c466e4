"""One warm fleet cycle with the straggler rescue on BASELINE config #2 (the
quadratic form with Qf, the terminal ball, a fixed dt): the port against the
JAX package (CPU, f64, 1e-9 absolute).

Six lanes at N=8 with 4 circle slots start from one result state handed to
both packages through numpy: the port's 2×3 solve from the straight-line
seed, with lane 4 blown up (NaN controls and eq_norm) and lane 5 pushed past
the divergence threshold. The cycle must advance the converged lanes,
continue the sane unconverged ones, reset lanes 4 and 5 and rescue the first
two stragglers, as the JAX cycle does.

It also pins the fixed-dt warm start that the port keeps from the JAX
cycle: the resample hands an advanced lane dt·(N−1)/N although dt is fixed,
the solve's first linearization uses that dt, and the line search then
clips every candidate, α = 0 included, to dt_ref.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_local_planner_tpu.benchmarks import config2_diffdrive_obstacles as j_config2
from mpc_local_planner_tpu.benchmarks import random_ensemble as j_random_ensemble
from mpc_local_planner_tpu.ocp.spec import Scenario as JScenario
from mpc_local_planner_tpu.planner.cycle import make_fleet_cycle as j_make_fleet_cycle
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.solvers.rescue import make_rescue as j_make_rescue

from test_torch_cycle import _assert_trees_close, _np, _to_jax
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.benchmarks import config2_diffdrive_obstacles as t_config2
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle as t_make_fleet_cycle
from mpc_local_planner_tpu_torch.solvers import al_sqp as t_al
from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue as t_make_rescue

B, N, M = 6, 8, 4
SLOTS = 2
COLD = dict(n_al=2, n_sqp=3, rho0=120.0, reg0=1.0, tol_eq=1e-2, tol_ineq=1e-2,
            alphas=(1.0, 0.5, 0.22))
WARM = dict(COLD, n_al=2, n_sqp=2)
RESCUE = dict(WARM, alphas=(1.0, 0.7, 0.5, 0.22))


def _start_state():
    jspec = j_config2(N=N, obstacle_cap=M)
    js = j_random_ensemble(jspec, B, jax.random.PRNGKey(3), dtype=jnp.float64)
    js = dataclasses.replace(js, xf=js.x0 + 0.3 * (js.xf - js.x0))
    scen = _np(js)
    tspec = t_config2(N=N, obstacle_cap=M)
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


def _cycle_torch(scen, r, seen):
    tspec = t_config2(N=N, obstacle_cap=M)
    warm = t_al.SolverSettings(**WARM)
    duals0 = t_al.init_duals(tspec, warm, torch.float64, "cpu", batch=(B,))
    solve = t_al.make_solver(tspec, warm, device="cpu")

    def recording(s, init, duals):
        seen.append((s, init, duals))
        return solve(s, init, duals)

    rescue = t_make_rescue(
        tspec, warm, SLOTS, rescue_settings=t_al.SolverSettings(**RESCUE), device="cpu"
    )
    cycle = t_make_fleet_cycle(tspec, warm, duals0, solve=recording, rescue=rescue, device="cpu")
    s2, r2 = cycle(
        convert.from_numpy(TScenario, scen, "cpu"),
        convert.from_numpy(t_al.SolveResult, r, "cpu"),
    )
    return convert.to_numpy(s2), convert.to_numpy(r2)


def _cycle_jax(scen, r):
    jspec = j_config2(N=N, obstacle_cap=M)
    warm = j_al.SolverSettings(**WARM)
    duals0 = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), j_al.init_duals(jspec, warm, jnp.float64)
    )
    rescue = j_make_rescue(jspec, warm, SLOTS, rescue_settings=j_al.SolverSettings(**RESCUE))
    cycle = jax.jit(j_make_fleet_cycle(jspec, warm, duals0, rescue=rescue))
    s2, r2 = cycle(_to_jax(JScenario, scen), _to_jax(j_al.SolveResult, r))
    return _np(s2), _np(r2)


def test_torch_quadratic_fleet_cycle_with_rescue_matches_jax():
    scen, r = _start_state()
    advance = r["converged"]
    reset = ~((r["eq_norm"] <= 0.5) & (r["ineq_viol"] <= 0.5))
    assert advance.any() and (~advance & ~reset).any()
    np.testing.assert_array_equal(np.flatnonzero(reset), [4, 5])

    seen = []
    ts2, tr2 = _cycle_torch(scen, r, seen)
    js2, jr2 = _cycle_jax(scen, r)
    _assert_trees_close(ts2, js2)
    _assert_trees_close(tr2, jr2)
    np.testing.assert_array_equal(ts2["x0"][advance], r["primal"]["xs"][advance, 1])
    np.testing.assert_array_equal(ts2["x0"][~advance], scen["x0"][~advance])
    assert np.all(np.isfinite(tr2["primal"]["us"][4]))  # the NaN lane was reset
    assert tr2["duals"]["mu_ball"].max() > 0.0
    np.testing.assert_array_equal(tr2["primal"]["dt"], np.full(B, 0.3))

    # the fixed-dt warm start: advanced lanes enter the solve with the
    # resampled dt, continued and reset lanes with dt_ref ...
    (s_in, init_in, duals_in), = seen
    dt_in = init_in.dt.numpy()
    np.testing.assert_allclose(dt_in[advance], 0.3 * (N - 1) / N, rtol=1e-15)
    np.testing.assert_array_equal(dt_in[~advance], 0.3)
    # ... and the first linearization at that dt shapes the answer: the same
    # solve from dt_ref ends elsewhere on those lanes
    tspec = t_config2(N=N, obstacle_cap=M)
    solve = t_al.make_solver(tspec, t_al.SolverSettings(**WARM), device="cpu")
    at_ref = solve(s_in, dataclasses.replace(init_in, dt=torch.full_like(init_in.dt, 0.3)), duals_in)
    plain = solve(s_in, init_in, duals_in)
    moved = np.abs(at_ref.primal.xs.numpy() - plain.primal.xs.numpy()).max(axis=(1, 2))
    assert np.all(moved[advance] > 1e-6) and np.all(moved[~advance] == 0.0)
