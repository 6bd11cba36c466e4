"""The port's controllers, plant and closed-loop tasks on the CPU
(``controllers/``, ``plants/simulated_plant.py``, ``tasks/closed_loop.py``).

Each is held against the JAX package's on the same float64 inputs at 1e-9
(the LQR gains, the feedback laws, the PID loop, the dual-mode switch, the
plant's dead time, ``run_feedback_loop`` over a batch of plants, which JAX
runs under ``vmap``). The plant's noise comes from a ``torch.Generator``: it
is held by its statistics and by its reproducibility from one seed.
``ClosedLoopControlTask.perform`` is held against JAX's ``perform`` with one
deterministic stand-in controller in each package, so that no JAX
Controller compiles (float32, as both tasks run the plant); and one real
closed loop of the port's Controller reaches its goal, as JAX's test of the
task does.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.controllers import (
    DualModeController as JDualMode,
    LqrController as JLqr,
    PidController as JPid,
    SimpleStateController as JSimple,
)
from mpc_local_planner_tpu.plants.simulated_plant import SimulatedPlant as JPlant
from mpc_local_planner_tpu.systems.models import UnicycleModel as JUnicycle
from mpc_local_planner_tpu.tasks.closed_loop import (
    ClosedLoopControlTask as JTask,
    run_feedback_loop as j_run_feedback_loop,
)

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.controllers import (
    DualModeController,
    LqrController,
    PidController,
    PidState,
    SimpleStateController,
)
from mpc_local_planner_tpu_torch.plants import PlantState, SimulatedPlant
from mpc_local_planner_tpu_torch.systems.models import UnicycleModel
from mpc_local_planner_tpu_torch.tasks.closed_loop import (
    ClosedLoopControlTask,
    run_feedback_loop,
)

CPU = "cpu"


class _DoubleIntegratorJ:
    """ẋ = (v, u) (JAX's test model)."""

    control_dim = 1
    state_dim = 2

    def f(self, x, u):
        return jnp.stack([x[..., 1], u[..., 0]], axis=-1)

    def linearize(self, x, u):
        return jax.jacfwd(self.f, argnums=0)(x, u), jax.jacfwd(self.f, argnums=1)(x, u)


class _DoubleIntegratorT:
    control_dim = 1
    state_dim = 2

    def f(self, x, u):
        return torch.stack([x[..., 1], u[..., 0]], dim=-1)

    def linearize(self, x, u):
        return (torch.func.jacfwd(self.f, argnums=0)(x, u),
                torch.func.jacfwd(self.f, argnums=1)(x, u))


def _close(port, ref, tol=1e-9):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * max(1.0, np.max(np.abs(ref))))


@pytest.mark.parametrize("dt", [0.1, None])
def test_torch_lqr_gain_and_feedback_loop_match_jax(dt):
    """JAX's double-integrator LQR tests: the gain (discrete and
    continuous), the law, and the loop over a batch of 5 plants."""
    q, r = ((5.0, 1.0), (0.5,)) if dt else ((2.0, 1.0), (1.0,))
    xref = np.array([0.5, 0.0]) if dt else np.zeros(2)
    jc = JLqr.make(_DoubleIntegratorJ(), jnp.asarray(xref), jnp.zeros(1), q_diag=q, r_diag=r,
                   dt=dt, se2_state=False)
    tc = LqrController.make(_DoubleIntegratorT(), xref, torch.zeros(1), q_diag=q, r_diag=r,
                            dt=dt, se2_state=False, device=CPU)
    assert tc.K.dtype == torch.float64 and not tc.se2_state
    _close(tc.K, jc.K)
    loop_dt = dt or 0.05
    x0 = np.random.default_rng(0).normal(size=(5, 2))
    jxs, jus = jax.vmap(lambda x: j_run_feedback_loop(
        jc.control, JPlant(model=_DoubleIntegratorJ(), method="rk4"), x, loop_dt, 60))(
        jnp.asarray(x0))
    txs, tus = run_feedback_loop(tc.control, SimulatedPlant(model=_DoubleIntegratorT()),
                                 torch.from_numpy(x0), loop_dt, 60)
    assert txs.shape == (61, 5, 2) and tus.shape == (60, 5, 1)
    _close(txs, np.moveaxis(np.asarray(jxs), 0, 1))
    _close(tus, np.moveaxis(np.asarray(jus), 0, 1))
    # the loop regulates toward the reference
    assert np.abs(txs[-1].numpy() - xref).max() < np.abs(x0 - xref).max()


def test_torch_simple_state_and_dual_mode_match_jax():
    K = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.5]])
    xs = np.array([[0.2, -0.1, 0.3], [1.0, 2.0, 3.1], [-0.5, 0.2, -3.0]])
    jc = JSimple(K=jnp.asarray(K), xref=jnp.zeros(3), uref=jnp.array([0.1, 0.0]), se2_state=True)
    tc = convert.from_numpy(SimpleStateController, jc, CPU)
    assert tc.se2_state is True
    _close(tc.control(torch.from_numpy(xs)), jc.control(jnp.asarray(xs)), tol=1e-12)
    np.testing.assert_allclose(tc.control(torch.tensor([0.2, -0.1, 0.3])).numpy(),
                               [0.1 - 0.2, -(-0.1) - 0.5 * 0.3], atol=1e-6)

    jl = JLqr.make(JUnicycle(), jnp.zeros(3), jnp.array([0.1, 0.0]), dt=0.1)
    tl = LqrController.make(UnicycleModel(), np.zeros(3), np.array([0.1, 0.0]), dt=0.1,
                            device=CPU)
    _close(tl.K, jl.K)
    jd = JDualMode(lqr=jl, ball_weights=jnp.ones(3), ball_radius=0.5)
    td = DualModeController(lqr=tl, ball_weights=torch.ones(3, dtype=torch.float64),
                            ball_radius=0.5)
    pts = np.array([[0.1, 0.1, 0.0], [2.0, 0.0, 0.0], [0.3, -0.2, 0.3], [0.0, 0.0, 3.1]],
                   dtype=np.float32)
    u_mpc = np.full((4, 2), 9.0, dtype=np.float32)
    ju, jin = jd.select(jnp.asarray(pts), jnp.asarray(u_mpc))
    tu, tin = td.select(torch.from_numpy(pts), torch.from_numpy(u_mpc))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(tin.numpy(), [True, False, True, False])
    _close(tu, ju)
    # the converter carries the nested LQR law and the static radius
    td2 = convert.from_numpy(DualModeController, jd, CPU)
    assert td2.ball_radius == 0.5 and td2.lqr.se2_state
    _close(td2.lqr.K, jl.K, tol=0)


def test_torch_pid_loop_and_integral_clamp_match_jax():
    """JAX's first-order PID loop, and a loop whose integral rides its limit
    (the clamp's ties: maximum, then minimum)."""
    for kw, steps in ((dict(kp=2.0, ki=1.0), 200), (dict(kp=[1.0, 0.5], ki=[3.0, 2.0],
                                                          kd=0.1, integral_limit=0.05), 60)):
        dim = 2 if isinstance(kw["kp"], list) else 1
        jp = JPid.make(dim=dim, **{k: jnp.asarray(v) if isinstance(v, list) else v
                                   for k, v in kw.items()})
        tp = PidController.make(dim=dim, dtype=torch.float64, device=CPU, **kw)
        js, ts = jp.init_state(), tp.init_state()
        jx, tx = jnp.zeros(dim), torch.zeros(dim, dtype=torch.float64)
        target = np.linspace(1.0, 2.0, dim)
        for _ in range(steps):
            js, ju = jp.step(js, jnp.asarray(target) - jx, 0.05)
            ts, tu = tp.step(ts, torch.from_numpy(target) - tx, 0.05)
            jx = jx + 0.05 * (-jx + ju)
            tx = tx + 0.05 * (-tx + tu)
        _close(tx, jx, tol=1e-12)
        _close(ts.integral, js.integral, tol=1e-12)
        back = convert.from_numpy(PidState, js, CPU)
        _close(back.prev_error, js.prev_error, tol=0)
        if dim == 1:
            np.testing.assert_allclose(tx.numpy(), 1.0, atol=1e-2)
        else:
            assert np.all(np.abs(ts.integral.numpy()) == 0.05)


def test_torch_plant_dead_time_matches_jax():
    jp = JPlant(model=JUnicycle(), dead_time_steps=2, method="explicit_euler")
    tp = SimulatedPlant(model=UnicycleModel(), dead_time_steps=2, method="explicit_euler")
    js, ts = jp.init_state(jnp.zeros((3, 3))), tp.init_state(torch.zeros(3, 3, dtype=torch.float64))
    assert ts.u_buffer.shape == (3, 2, 2)
    us = np.random.default_rng(1).normal(size=(6, 3, 2))
    for k in range(6):
        js = jp.step(js, jnp.asarray(us[k]), 0.1)
        ts = tp.step(ts, torch.from_numpy(us[k]), 0.1)
        if k < 2:  # the zero-initialized buffer is applied first
            np.testing.assert_allclose(ts.x.numpy(), 0.0, atol=1e-12)
        _close(ts.x, js.x, tol=1e-12)
        _close(ts.u_buffer, js.u_buffer, tol=0)
    back = convert.from_numpy(PlantState, js, CPU)
    _close(back.x, js.x, tol=0)
    # rk4 substeps without dead time
    jq, tq = JPlant(model=JUnicycle(), substeps=3), SimulatedPlant(model=UnicycleModel(),
                                                                   substeps=3)
    x1 = jq.step(jq.init_state(jnp.asarray(us[0, :, :1].repeat(3, 1))), jnp.asarray(us[1]), 0.2)
    t1 = tq.step(tq.init_state(torch.from_numpy(us[0, :, :1].repeat(3, 1))),
                 torch.from_numpy(us[1]), 0.2)
    _close(t1.x, x1.x, tol=1e-12)


def test_torch_plant_noise_statistics_and_reproducibility():
    plant = SimulatedPlant(model=UnicycleModel(), process_noise_std=0.2,
                           measurement_noise_std=0.05)
    s0 = plant.init_state(torch.zeros(20000, 3, dtype=torch.float64))
    u = torch.zeros(20000, 2, dtype=torch.float64)
    # without a generator there is no noise
    np.testing.assert_array_equal(plant.step(s0, u, 0.1).x.numpy(), 0.0)
    np.testing.assert_array_equal(plant.output(s0).numpy(), 0.0)
    s1 = plant.step(s0, u, 0.1, torch.Generator().manual_seed(3))
    y1 = plant.output(s1, torch.Generator().manual_seed(4)) - s1.x
    for v, std in ((s1.x, 0.2), (y1, 0.05)):
        v = v.numpy()
        assert abs(v.mean()) < 4 * std / np.sqrt(v.size)
        assert abs(v.std() / std - 1.0) < 0.02
    again = plant.step(s0, u, 0.1, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(again.x.numpy(), s1.x.numpy())
    other = plant.step(s0, u, 0.1, torch.Generator().manual_seed(5))
    assert not np.array_equal(other.x.numpy(), s1.x.numpy())


class _StandIn:
    """A deterministic controller with the Controller's surface that the
    task uses: steer toward the goal, slow down near it."""

    def __init__(self, spec, xp, device=None):
        self.spec, self.xp, self.device = spec, xp, device

    def step(self, scen):
        xp = self.xp
        d = scen.xf[..., :2] - scen.x0[..., :2]
        dist = xp.sqrt(xp.sum(d * d, -1))
        head = xp.arctan2(d[..., 1], d[..., 0]) - scen.x0[..., 2]
        head = xp.arctan2(xp.sin(head), xp.cos(head))
        v = xp.minimum(0.5 * dist, xp.ones_like(dist) * 0.4) + 0.01 * scen.u_prev[..., 0]
        return types.SimpleNamespace(u0=xp.stack([v, 1.5 * head]))

    def is_goal_reached(self, x, goal):
        d = goal[:2] - x[:2]
        return bool(self.xp.sqrt(self.xp.sum(d * d)) < 0.05)


def test_torch_closed_loop_perform_matches_jax_with_a_stand_in_controller():
    jspec, tspec = jb.config1_unicycle_quadratic(N=5), tb.config1_unicycle_quadratic(N=5)
    goal = np.array([1.0, 0.5, 0.3])
    jlog = JTask(_StandIn(jspec, jnp), JPlant(model=JUnicycle()), 0.2).perform(
        np.zeros(3), goal, n_cycles=40)
    tlog = ClosedLoopControlTask(_StandIn(tspec, torch, torch.device(CPU)),
                                 SimulatedPlant(model=UnicycleModel()), 0.2).perform(
        np.zeros(3), goal, n_cycles=40)
    assert tlog.goal_reached == jlog.goal_reached
    assert tlog.states.values.shape == jlog.states.values.shape
    assert tlog.controls.values.shape == jlog.controls.values.shape
    assert tlog.states.values.dtype == torch.float32
    assert tlog.solve_ms.shape == jlog.solve_ms.shape == (tlog.controls.values.shape[0],)
    _close(tlog.states.values, jlog.states.values, tol=1e-5)
    _close(tlog.controls.values, jlog.controls.values, tol=1e-5)
    _close(tlog.states.times, jlog.states.times, tol=1e-12)
    _close(tlog.controls.times, jlog.controls.times, tol=1e-12)


def test_torch_closed_loop_task_port_controller_reaches_goal():
    """JAX's test_closed_loop_task_mpc_reaches_goal_and_records on the port's
    unbatched Controller (the un-fused solve at one lane)."""
    from mpc_local_planner_tpu_torch.planner import Controller, load_config

    cfg = load_config({
        "grid": {"grid_size_ref": 10, "dt_ref": 0.3},
        "planning": {"objective_type": "quadratic_form", "terminal_cost_type": "quadratic",
                     "final_state_weights": [10.0, 10.0, 10.0]},
        "collision": {"obstacle_capacity": 0},
        "solver": {"iterations": 5, "inner_iterations": 6},
    })
    ctrl = Controller(cfg, device=CPU)
    task = ClosedLoopControlTask(ctrl, SimulatedPlant(model=ctrl.spec.model, method="rk4"),
                                 sim_dt=cfg.grid.dt_ref)
    goal = np.array([1.0, 0.5, float(np.arctan2(0.5, 1.0))])
    log = task.perform(np.zeros(3), goal, n_cycles=50)
    assert log.goal_reached
    assert log.states.values.shape[0] == log.controls.values.shape[0] + 1
    assert log.solve_ms.shape[0] == log.controls.values.shape[0]
    assert dataclasses.is_dataclass(log.states)
