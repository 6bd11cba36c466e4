"""Message-type records (port of ``mpc_local_planner_tpu.msgs``).

mpc_local_planner_msgs' OptimalControlResult.msg (dims, time_states[],
flattened states[], time_controls[], controls[], optimal_solution_found,
cpu_time) and StateFeedback.msg (header + state[]) as plain dataclasses of
numpy arrays, laid out flat as the ROS messages are; ``from_control_result``
bridges from the Controller's ``ControlResult`` on any device.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from mpc_local_planner_tpu_torch.core.tree import leaf_numpy


@dataclasses.dataclass
class OptimalControlResult:
    """Flattened solve result (the OptimalControlResult.msg fields)."""

    dim_states: int
    dim_controls: int
    time_states: np.ndarray     # (N+1,)
    states: np.ndarray          # (N+1)*dim_states flattened
    time_controls: np.ndarray   # (N,)
    controls: np.ndarray        # N*dim_controls flattened
    optimal_solution_found: bool
    cpu_time: float             # seconds (per-solve wall time)

    @staticmethod
    def from_control_result(res, cpu_time: float = 0.0) -> "OptimalControlResult":
        xs = leaf_numpy(res.x_seq.values)
        us = leaf_numpy(res.u_seq.values)
        return OptimalControlResult(
            dim_states=xs.shape[-1],
            dim_controls=us.shape[-1],
            time_states=leaf_numpy(res.x_seq.times),
            states=xs.reshape(-1),
            time_controls=leaf_numpy(res.u_seq.times),
            controls=us.reshape(-1),
            optimal_solution_found=bool(leaf_numpy(res.solve.converged).all()),
            cpu_time=cpu_time,
        )

    def unflatten(self):
        """(states (N+1, nx), controls (N, nu))."""
        return (
            self.states.reshape(-1, self.dim_states),
            self.controls.reshape(-1, self.dim_controls),
        )


@dataclasses.dataclass
class StateFeedback:
    """External state feedback (StateFeedback.msg: header + state[]), merged
    with odometry under ``prefer_x_feedback``
    (RobotDynamicsInterface::mergeStateFeedbackAndOdomFeedback)."""

    stamp: float
    state: List[float]
