"""The port's batched AL-SQP solve against JAX ``vmap(solve_single)`` (CPU).

Both sides start from identical inputs: scenarios from the JAX
``random_ensemble`` (goals pulled in to 30% of their distance so that a 2×3
budget converges some lanes), the straight-line seed and fresh duals, handed
over through numpy. The settings are the warm-cycle ones of ``bench.py::main``
(ρ₀ = 120, reg₀ = 1, three line-search candidates) at a 2×3 budget with a
1e-2 feasibility tolerance.

Tolerances:
- f64, every lane: 1e-9 absolute on the primal, cost and norms, 1e-9 on the
  duals (ρ reaches 3e3). Both sides run the same arithmetic in another order,
  so they differ by rounding only (measured ≤ 4e-13).
- f32, on the lanes both sides converged: the conv flags agree on every lane;
  xs and us 5e-5, dt 5e-6, cost and eq_norm 1e-5, duals 5e-3 absolute or
  1e-3 relative — the parity tolerances of ROADMAP.md ("How parity is held").
  Measured: xs 2.4e-7, us 6.9e-7, dt 3e-8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu.benchmarks import config3_carlike_min_time as j_config3
from mpc_local_planner_tpu.benchmarks import random_ensemble as j_random_ensemble
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.solvers import al_sqp as j_al

from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time as t_config3
from mpc_local_planner_tpu_torch.ocp.grid import Primal as TPrimal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.solvers import al_sqp as t_al

B, N, M = 8, 8, 4
SETTINGS = dict(
    n_al=2, n_sqp=3, rho0=120.0, reg0=1.0, tol_eq=1e-2, tol_ineq=1e-2,
    alphas=(1.0, 0.5, 0.22),
)


def _np(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: _np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def _inputs(jdtype):
    jspec = j_config3(N=N, obstacle_cap=M)
    scen = j_random_ensemble(jspec, B, jax.random.PRNGKey(3), dtype=jdtype)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.3 * (scen.xf - scen.x0))
    init = j_initial_primal(jspec, scen)
    jst = j_al.SolverSettings(**SETTINGS)
    duals = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), j_al.init_duals(jspec, jst, jdtype)
    )
    return jspec, jst, scen, init, duals


def _t_scenarios(spec, batch=3):
    from mpc_local_planner_tpu_torch.benchmarks import random_ensemble

    return random_ensemble(spec, batch, torch.Generator().manual_seed(0), device="cpu")


def _solve_both(jdtype):
    jspec, jst, scen, init, duals = _inputs(jdtype)
    j_out = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, jst, s, i, d)))(
        scen, init, duals
    )
    solve = t_al.make_solver(
        t_config3(N=N, obstacle_cap=M), t_al.SolverSettings(**SETTINGS), device="cpu"
    )
    before = riccati_cuda.lqr_solve_cuda.launches
    t_out = solve(
        convert.from_numpy(TScenario, _np(scen), "cpu"),
        convert.from_numpy(TPrimal, _np(init), "cpu"),
        convert.from_numpy(t_al.DualState, _np(duals), "cpu"),
    )
    assert riccati_cuda.lqr_solve_cuda.launches == before  # CPU: the plain KKT solve
    return convert.to_numpy(t_out), _np(j_out)


def test_torch_solve_matches_jax_f64():
    t, j = _solve_both(jnp.float64)
    assert t["primal"]["xs"].dtype == np.float64
    np.testing.assert_array_equal(t["converged"], j["converged"])
    assert 0 < j["converged"].sum() < B  # both outcomes are exercised
    for k in ("xs", "us", "dt"):
        np.testing.assert_allclose(t["primal"][k], j["primal"][k], atol=1e-9, rtol=0, err_msg=k)
    for k in ("cost", "eq_norm", "ineq_viol"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-9, rtol=0, err_msg=k)
    for k in j["duals"]:
        np.testing.assert_allclose(t["duals"][k], j["duals"][k], atol=1e-9, rtol=0, err_msg=k)


def test_torch_solve_matches_jax_f32_on_converged_lanes():
    t, j = _solve_both(jnp.float32)
    assert t["primal"]["xs"].dtype == np.float32
    np.testing.assert_array_equal(t["converged"], j["converged"])
    both = t["converged"] & j["converged"]
    assert both.sum() >= 2
    tol = {"xs": 5e-5, "us": 5e-5, "dt": 5e-6}
    for k, atol in tol.items():
        np.testing.assert_allclose(
            t["primal"][k][both], j["primal"][k][both], atol=atol, rtol=0, err_msg=k
        )
    for k in ("cost", "eq_norm"):
        np.testing.assert_allclose(t[k][both], j[k][both], atol=1e-5, rtol=0, err_msg=k)
    for k in j["duals"]:
        a, b = t["duals"][k][both], j["duals"][k][both]
        assert np.all(np.abs(a - b) <= np.maximum(5e-3, 1e-3 * np.abs(b))), k


def test_torch_settings_refuse_what_the_slice_does_not_run():
    spec = t_config3(N=N, obstacle_cap=M)
    # early_exit and the pscan KKT solve are ported: admitted
    for good in (dict(early_exit=True), dict(horizon_parallel=True), dict(kkt="pscan")):
        assert callable(t_al.make_solver(spec, t_al.SolverSettings(**good), device="cpu"))
    with pytest.raises(ValueError, match="kkt"):
        t_al.make_solver(spec, t_al.SolverSettings(kkt="bogus"), device="cpu")
    with pytest.raises(ValueError, match="fused"):
        t_al.make_solver(spec, t_al.SolverSettings(fused="bogus"), device="cpu")


def test_torch_entry_points_raise_without_a_card(monkeypatch):
    """No card and no explicit CPU request: raise, never run on the CPU."""
    from mpc_local_planner_tpu_torch import (
        make_fleet_cycle,
        make_rescue,
        random_ensemble,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = t_config3(N=N, obstacle_cap=M)
    st = t_al.SolverSettings(**SETTINGS)
    duals0 = t_al.init_duals(spec, st, torch.float32, "cpu", batch=(2,))
    for build in (
        lambda: t_al.make_solver(spec, st),
        lambda: make_rescue(spec, st, 2),
        lambda: make_fleet_cycle(spec, st, duals0),
        lambda: random_ensemble(spec, 2, torch.Generator().manual_seed(0)),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_torch_solver_refuses_inputs_on_another_device():
    spec = t_config3(N=N, obstacle_cap=M)
    st = t_al.SolverSettings(**SETTINGS)
    scen = _t_scenarios(spec)
    init, duals = t_al.default_init(spec, st, scen)
    meta = dataclasses.replace(init, dt=torch.empty_like(init.dt, device="meta"))
    with pytest.raises(ValueError, match="solver built for cpu"):
        t_al.make_solver(spec, st, device="cpu")(scen, meta, duals)


def test_torch_random_ensemble_matches_the_jax_layout():
    """The streams differ (torch.Generator vs jax.random); the layout, the
    sampling ranges and the obstacle clearance rule are the same."""
    jspec = j_config3(N=N, obstacle_cap=M)
    tspec = t_config3(N=N, obstacle_cap=M)
    js = _np(j_random_ensemble(jspec, 64, jax.random.PRNGKey(0)))
    ts = convert.to_numpy(_t_scenarios(tspec, 64))
    for key in ("x0", "xf", "via_points", "via_mask", "u_prev"):
        assert ts[key].shape == js[key].shape and ts[key].dtype == js[key].dtype, key
    for key, val in js["obstacles"].items():
        assert ts["obstacles"][key].shape[1:] == val.shape[1:], key
        assert ts["obstacles"][key].dtype == val.dtype, key
    ang = ts["xf"][:, 2]
    dist = np.hypot(ts["xf"][:, 0], ts["xf"][:, 1])
    assert np.all(np.abs(ang) <= 0.8) and np.all((dist >= 1.8 - 1e-5) & (dist <= 3.0 + 1e-5))
    np.testing.assert_allclose(np.arctan2(ts["xf"][:, 1], ts["xf"][:, 0]), ang, atol=1e-6)
    # an active circle sits more than 0.45 off the start-goal line
    c = ts["obstacles"]["circles"]
    normal = np.stack([-np.sin(ang), np.cos(ang)], axis=-1)
    lateral = np.abs(np.sum(c * normal[:, None, :], axis=-1))
    mask = ts["obstacles"]["circle_mask"]
    assert mask.any() and not mask.all()
    np.testing.assert_array_equal(mask, lateral > 0.45)
    assert np.all(ts["obstacles"]["circle_radii"] == np.float32(0.25))
