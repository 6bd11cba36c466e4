"""The Controller's grid adaptation and ``reconfigure``: the port against the
JAX package's ``Controller`` (CPU, f64).

One robot at N=8 with budgets of 2×2, cycle by cycle from the same warm
state (handed over through numpy, as in ``tests/test_torch_controller.py``):

* the time-based modes (``time_based_single_step``,
  ``time_based_aggressive_estimate``) on the uniform grid, a goal far enough
  that the optimized dt sits above the band and N grows, and
  ``redundant_controls`` on the non-uniform grid: the sequence of N is
  equal, and so is every cycle's result;
* ``reconfigure``: a tolerance and clearance retune keeps the warm state
  (and the next cycle matches JAX's under the new config), a new horizon
  resets it, and a rejected update raises and leaves the Controller as it
  was.

Tolerance: ``assert_cycle_matches`` (flags, horizons and counters exact;
floats within 1e-9 plus ten times JAX's own one-ulp move on the lane).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpc_local_planner_tpu.planner.config import load_config as j_load
from mpc_local_planner_tpu.planner.controller import Controller as JController

from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.planner import Controller as TController
from mpc_local_planner_tpu_torch.planner import load_config as t_load

from test_torch_controller import (
    N,
    assert_same_state,
    carlike,
    controllers,
    single_np,
    step_both,
    with_state,
)


def adaptive(mode, nonuniform=False):
    cfg = carlike(slots=2)
    cfg["grid"] = {**cfg["grid"], "variable_grid": {
        "enable": True, "min_dt": 0.001, "max_dt": 0.5,
        "grid_adaptation": {"enable": True, "min_grid_size": 5, "max_grid_size": 12,
                            "dt_hyst_ratio": 0.1, "mode": mode,
                            "redundant_controls_epsilon": 0.05}}}
    if nonuniform:
        cfg["grid"]["type"] = "non_uniform_fd_grid"
    return cfg


@pytest.mark.parametrize("mode, nonuniform, goal", [
    ("time_based_single_step", False, [2.4, 0.4, 0.2]),
    ("time_based_aggressive_estimate", False, [2.4, 0.4, 0.2]),
    ("redundant_controls", True, [1.2, 0.5, 0.6]),
])
def test_torch_grid_adaptation_takes_the_horizons_jax_takes(mode, nonuniform, goal):
    j_ctrl, t_ctrl = controllers(adaptive(mode, nonuniform))
    tree = single_np([0.0, 0.0, 0.0], goal, [(1.0, -0.4, 0.15)], 2)
    horizons = []
    for _k in range(4):
        j_res, t_res = step_both(j_ctrl, t_ctrl, tree, elapsed=0.3)
        horizons.append((j_ctrl._spec.N, t_ctrl._spec.N))
        assert t_res.u_seq.values.shape == (t_ctrl._spec.N, 2)
        tree = with_state(tree, x0=np.asarray(j_res.solve.primal.xs[1]),
                          u_prev=np.asarray(j_res.u0))
    ns = [n for n, _ in horizons]
    assert [n for _, n in horizons] == ns
    assert len(set(ns)) > 1, ns  # the horizon moved
    # one cached solve per (N, warm) the cycles reached
    assert sorted(t_ctrl._cache) == sorted(j_ctrl._cache)


def test_torch_reconfigure_keeps_resets_and_refuses_like_jax():
    j_ctrl, t_ctrl = controllers(carlike(slots=2))
    tree = single_np([0.0, 0.0, 0.0], [1.2, 0.3, 0.2], [(0.6, -0.3, 0.12)], 2)
    j_res, _ = step_both(j_ctrl, t_ctrl, tree)
    tree = with_state(tree, x0=np.asarray(j_res.solve.primal.xs[1]))

    # a rejected update raises and leaves the Controller as it was
    before = convert.controller_state_to_numpy(t_ctrl)
    config, cache = t_ctrl.config, dict(t_ctrl._cache)
    bad = {"grid": {"variable_grid": {"grid_adaptation": {
        "enable": True, "min_grid_size": 10, "max_grid_size": 20}}}}
    with pytest.raises(ValueError) as j_err:
        j_ctrl.reconfigure(bad)
    with pytest.raises(ValueError) as t_err:
        t_ctrl.reconfigure(bad)
    assert str(t_err.value) == str(j_err.value)
    assert t_ctrl.config is config and t_ctrl._cache == cache
    assert_same_state(convert.controller_state_to_numpy(t_ctrl), before)

    # a retune of tolerances and clearance keeps the warm state
    retune = {"solver": {"tol_eq": 2e-3, "tol_ineq": 2e-3},
              "collision": {"min_obstacle_dist": 0.12}}
    assert t_ctrl.reconfigure(retune) is j_ctrl.reconfigure(retune) is True
    assert t_ctrl._cache == {} and t_ctrl.config.collision.min_obstacle_dist == 0.12
    assert dataclasses.asdict(t_ctrl.warm_settings) == dataclasses.asdict(j_ctrl.warm_settings)
    assert_same_state(convert.controller_state_to_numpy(t_ctrl), before)
    step_both(j_ctrl, t_ctrl, tree, elapsed=0.3)

    # a new horizon resets it
    assert t_ctrl.reconfigure({"grid": {"grid_size_ref": N + 1}}) is j_ctrl.reconfigure(
        {"grid": {"grid_size_ref": N + 1}}) is False
    state = convert.controller_state_to_numpy(t_ctrl)
    assert state["primal"] is None and state["N"] == N + 1
    assert_same_state(state, convert.controller_state_to_numpy(j_ctrl))

    # a fresh Controller has no warm state to keep; a full PlannerConfig is taken too
    fresh = TController(t_load(carlike(slots=2)), dtype=torch.float64, device="cpu")
    assert fresh.reconfigure(t_load(carlike(slots=2, tol_eq=5e-3))) is (
        JController(j_load(carlike(slots=2))).reconfigure(j_load(carlike(slots=2, tol_eq=5e-3))))
    assert fresh.settings.tol_eq == 5e-3
