"""The Controller on the card: the batched Controller on CUDA against the same
Controller on the CPU, and the kernels each Controller launches.

These run the hand-written kernels (the fused kernel and K1), so they skip
without a CUDA card. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_controller_gpu.py

* A batched Controller (B=256, the fleet demo's car at N=30, 8 circle slots,
  a 64-slot rescue) takes its cold step on CUDA, where K1 carries every SQP
  iteration and the fused kernel does not launch; its warm state then goes
  to the same Controller on the CPU (``convert``), and one warm step on
  each is held together with bench.py's gate (``agreement.gate``: conv flags
  equal on 99.5% of the lanes, a quarter converged on both, max |Δxs| on
  those within the budget's bound). On the card the warm step is two fused
  launches (the warm solve and the rescue) and no K1 launch.
* An unbatched Controller (one robot) launches K1 once per SQP iteration
  and never the fused kernel, as the JAX Controller runs plain
  ``solve_single``.
"""

import pytest
import torch

from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.benchmarks import random_ensemble
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda, riccati_cuda
from mpc_local_planner_tpu_torch.planner import Controller, load_config
from mpc_local_planner_tpu_torch.solvers import agreement

pytestmark = pytest.mark.gpu
B = 256


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Controller's kernels have no CPU mode")
    return torch.device("cuda", 0)


def _config(N=30, slots=8, **solver):
    return load_config({
        "robot": {"type": "simple_car", "simple_car": {
            "wheelbase": 0.5, "max_vel_x": 0.4, "max_vel_x_backwards": 0.2,
            "max_steering_angle": 1.0, "acc_lim_x": 0.5}},
        "grid": {"grid_size_ref": N, "dt_ref": 0.3, "xf_fixed": [True, True, True],
                 "variable_grid": {"enable": True, "min_dt": 0.001, "max_dt": 0.5}},
        "planning": {"objective": {"type": "minimum_time"}},
        "collision": {"min_obstacle_dist": 0.1, "obstacle_capacity": slots},
        "footprint_model": {"type": "circular", "radius": 0.2},
        "solver": {"tol_eq": 1e-3, "tol_ineq": 1e-3, **solver},
    })


def _launches():
    return riccati_cuda.lqr_solve_cuda.launches, fused_al_sqp_cuda.fused_solve_cuda.launches


def _moved(before):
    now = _launches()
    return now[0] - before[0], now[1] - before[1]


def test_torch_batched_controller_on_the_card_matches_the_cpu():
    dev = _card()
    cfg = _config(rescue_slots=64)
    card = Controller(cfg, batch=B, device=dev)
    scen = random_ensemble(card.spec, B, torch.Generator().manual_seed(0), device=dev)
    before = _launches()
    cold = card.step(scen)
    torch.cuda.synchronize()
    assert _moved(before) == (card.settings.n_al * card.settings.n_sqp, 0)
    # the demo's feedback: converged lanes move to their planned stage 1
    conv = cold.solve.converged[:, None]
    scen = Scenario(
        x0=torch.where(conv, cold.solve.primal.xs[:, 1], scen.x0), xf=scen.xf,
        obstacles=scen.obstacles, via_points=scen.via_points, via_mask=scen.via_mask,
        u_prev=torch.where(conv, cold.u0, scen.u_prev))
    cpu = Controller(cfg, batch=B, device="cpu")
    convert.controller_state_from_numpy(cpu, convert.controller_state_to_numpy(card))
    before = _launches()
    warm = card.step(scen, elapsed=0.3)
    torch.cuda.synchronize()
    assert _moved(before) == (0, 2)  # the warm solve and the rescue, fused
    ref = cpu.step(convert.from_numpy(Scenario, convert.to_numpy(scen), "cpu"), elapsed=0.3)
    w = card.warm_settings
    info, passed = agreement.gate(
        convert.from_numpy(type(warm.solve), convert.to_numpy(warm.solve), "cpu"), ref.solve,
        w.n_al * w.n_sqp)
    assert passed, info
    assert warm.u0.device.type == "cuda" and bool(torch.isfinite(warm.u0).all())


def test_torch_unbatched_controller_launches_k1_and_never_the_fused_kernel():
    dev = _card()
    ctrl = Controller(_config(N=50, slots=30), device=dev)
    obs = ObstacleSet.from_lists(circles=[(1.0, 0.3, 0.2), (1.8, -0.4, 0.2)], device=dev)
    scen = Scenario.goal_only([0.0, 0.0, 0.0], [2.5, 0.5, 0.3], obstacle_set=obs, device=dev)
    before = _launches()
    ctrl.step(scen)
    assert _moved(before) == (ctrl.settings.n_al * ctrl.settings.n_sqp, 0)
    before = _launches()
    res = ctrl.step(scen, elapsed=0.3)
    torch.cuda.synchronize()
    w = ctrl.warm_settings
    assert _moved(before) == (w.n_al * w.n_sqp, 0)
    assert res.u0.shape == (2,) and bool(torch.isfinite(res.u0).all())
