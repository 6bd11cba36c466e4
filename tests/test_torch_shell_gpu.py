"""Serving and the planner shell on the card: ``JourneyStream`` and
``LocalPlanner`` on CUDA against the same objects on the CPU, and the kernels
each launches.

These run the hand-written kernel K1, so they skip without a CUDA card. This
file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_shell_gpu.py

* A ``JourneyStream`` (the flagship at N=30, 8 circle slots, bench.py's
  early-exit serving preset, E=16) runs ``init`` on CUDA; its state goes to
  the same stream on the CPU (``convert``) before each of two cycles, and
  each cycle on both devices is held together with bench.py's gate
  (``agreement.gate``: conv flags equal, a quarter of the journeys
  converged on both, max |Δxs| on those within the budget's bound; the
  retirement flags equal). On the card every SQP iteration launches K1
  once (the iterations counted apart, by wrapping ``_sqp_iteration``) and
  the fused kernel never.
* A ``LocalPlanner`` on examples/demo_planner.py's scenario (unicycle, N=20,
  the quadratic form, 30 point slots) takes five cycles on CUDA and on the
  CPU, the card's Controller state handed to the CPU's before each: the
  scenario the shell hands to ``Controller.step`` is the same on both, the
  twist agrees within 5e-4 where both converged, and every cycle launches
  K1 once per SQP iteration of its budget (80 cold, 8 warm) and the fused
  kernel never.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time, random_ensemble
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda, riccati_cuda
from mpc_local_planner_tpu_torch.planner import LocalPlanner, load_config
from mpc_local_planner_tpu_torch.planner.local_planner import Costmap
from mpc_local_planner_tpu_torch.planner.serving import JourneyStream, StreamState
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp
from mpc_local_planner_tpu_torch.solvers.al_sqp import SolveResult, SolverSettings

pytestmark = pytest.mark.gpu
E = 16


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stream's and the shell's K1 has no CPU mode")
    return torch.device("cuda", 0)


def _launches():
    return riccati_cuda.lqr_solve_cuda.launches, fused_al_sqp_cuda.fused_solve_cuda.launches


class _SqpCount:
    def __init__(self, monkeypatch):
        self.n = 0
        orig = al_sqp._sqp_iteration

        def counted(*args, **kwargs):
            self.n += 1
            return orig(*args, **kwargs)

        monkeypatch.setattr(al_sqp, "_sqp_iteration", counted)


def _to(state, device):
    """A stream state on another device, through numpy."""
    return StreamState(
        scen=convert.from_numpy(Scenario, convert.to_numpy(state.scen), device),
        result=convert.from_numpy(SolveResult, convert.to_numpy(state.result), device),
        stuck=state.stuck.to(device), generator=state.generator,
    )


def test_torch_journey_stream_on_the_card_matches_the_cpu(monkeypatch):
    dev = _card()
    spec = config3_carlike_min_time(N=30, obstacle_cap=8)
    warm = SolverSettings(n_al=8, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
                          alphas=(1.0, 0.5, 0.22), early_exit=True)

    def stream(device):
        return JourneyStream(spec, warm, device=device, redraw_fn=lambda gen, n: random_ensemble(
            spec, n, gen, device=device))

    card, cpu = stream(dev), stream("cpu")
    sqp = _SqpCount(monkeypatch)
    before = _launches()
    state = card.init(E, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    cold = card.cold.n_al * card.cold.n_sqp
    assert sqp.n == cold and _launches() == (before[0] + cold, before[1])
    for seed in (1, 2):
        # both draw the same fresh journeys (the generator lies on the host)
        s_card = dataclasses.replace(state, generator=torch.Generator().manual_seed(seed))
        s_cpu = dataclasses.replace(_to(state, "cpu"),
                                    generator=torch.Generator().manual_seed(seed))
        n0, before = sqp.n, _launches()
        next_card, st_card = card.cycle(s_card)
        torch.cuda.synchronize()
        n_card = sqp.n - n0
        assert n_card >= warm.n_sqp
        assert _launches() == (before[0] + n_card, before[1])
        next_cpu, st_cpu = cpu.cycle(s_cpu)
        assert _launches()[0] == before[0] + n_card  # the CPU's KKT solve is the plain one
        info, passed = agreement.gate(_to(next_card, "cpu").result, next_cpu.result,
                                      warm.n_al * warm.n_sqp)
        assert passed, info
        for name in ("converged", "reached", "abandoned"):
            assert torch.equal(getattr(st_card, name).cpu(), getattr(st_cpu, name)), name
        assert next_card.result.primal.xs.device == dev
        state = next_card


def test_torch_local_planner_on_the_card_matches_the_cpu(monkeypatch):
    dev = _card()
    cfg = load_config({
        "robot": {"type": "unicycle", "unicycle": {
            "max_vel_x": 0.4, "max_vel_x_backwards": 0.2, "max_vel_theta": 0.3}},
        "grid": {"grid_size_ref": 20, "dt_ref": 0.3, "variable_grid": {"enable": False}},
        "planning": {
            "objective": {"type": "quadratic_form", "quadratic_form": {
                "state_weights": [2.0, 2.0, 2.0], "control_weights": [1.0, 1.0],
                "integral_form": False}},
            "terminal_cost": {"type": "quadratic", "quadratic": {
                "final_state_weights": [10.0, 10.0, 10.0]}},
            "terminal_constraint": {"type": "none"}},
        "collision": {"min_obstacle_dist": 0.2, "obstacle_capacity": 30},
        "footprint_model": {"type": "circular", "radius": 0.2},
    })
    t = np.linspace(0, 1, 40)
    plan = np.stack([3.0 * t, 0.5 * (1 - np.cos(np.pi * t)), np.zeros_like(t)], axis=1)
    data = np.zeros((60, 80), dtype=np.uint8)
    data[24:26, 19:22] = 254
    data[32:36, 55:58] = 254
    cm = Costmap(data=data, origin=(-0.5, -1.5), resolution=0.1)
    planners = {"card": LocalPlanner(cfg, device=dev), "cpu": LocalPlanner(cfg, device="cpu")}
    seen = {}
    for name, lp in planners.items():
        lp.set_plan(plan)
        step, seen[name] = lp.controller.step, []

        def spy(scen, plan=None, _step=step, _seen=seen[name], **kw):
            _seen.append(scen)
            return _step(scen, plan=plan, **kw)

        lp.controller.step = spy
    sqp = _SqpCount(monkeypatch)
    ctrl = planners["card"].controller
    x, u = np.zeros(3), np.zeros(2)
    compared = 0
    for k in range(5):
        convert.controller_state_from_numpy(planners["cpu"].controller,
                                            convert.controller_state_to_numpy(ctrl))
        budget = ctrl.settings if ctrl._primal is None else ctrl.warm_settings
        n0, before = sqp.n, _launches()
        twist, res = planners["card"].compute_velocity_commands(x, u, costmap=cm)
        torch.cuda.synchronize()
        assert sqp.n - n0 == budget.n_al * budget.n_sqp
        assert _launches() == (before[0] + sqp.n - n0, before[1])
        twist_cpu, res_cpu = planners["cpu"].compute_velocity_commands(x, u, costmap=cm)
        got, want = seen["card"][-1], seen["cpu"][-1]
        for a, b in zip(convert.to_numpy(got).values(), convert.to_numpy(want).values()):
            if isinstance(a, dict):
                for aa, bb in zip(a.values(), b.values()):
                    np.testing.assert_array_equal(aa, bb)
            else:
                np.testing.assert_array_equal(a, b)
        assert (res is None) == (res_cpu is None)
        if res is None:
            continue
        assert res.solve.primal.xs.device == dev
        conv = bool(res.solve.converged) and bool(res_cpu.solve.converged)
        if conv:
            compared += 1
            np.testing.assert_allclose(twist, twist_cpu, atol=5e-4, rtol=0)
        x = res.solve.primal.xs[1].double().cpu().numpy()
        u = res.u0.double().cpu().numpy()
    assert compared >= 2
