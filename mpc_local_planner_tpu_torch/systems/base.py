"""SE(2) robot dynamics base (port of ``mpc_local_planner_tpu.systems.base``).

A model is a frozen dataclass whose ``f(x, u)`` is a pure, batch-polymorphic
continuous-time dynamics function. Jacobians come from ``torch.func.jacfwd``.
"""

from __future__ import annotations

import torch


class BaseRobotSE2:
    """Mixin for SE(2) models: state x = (px, py, theta) IS the pose."""

    state_dim: int = 3

    # --- pose/state conversions (trivial for SE(2) state = pose) ---
    def position_from_state(self, x):
        return x[..., :2]

    def pose_from_state(self, x):
        return x

    def steady_state_from_pose(self, pose):
        return pose

    def merge_state_feedback_and_odom(self, x_feedback, x_odom, prefer_feedback: bool):
        """RobotDynamicsInterface::mergeStateFeedbackAndOdomFeedback: for
        3-dim SE(2) models the two sources are the same quantity, so one is
        taken wholesale (the prefer_x_feedback parameter)."""
        return x_feedback if prefer_feedback else x_odom

    # --- linearization (single sample; vmap for batches) ---
    def jac_x(self, x, u):
        return torch.func.jacfwd(self.f, argnums=0)(x, u)

    def jac_u(self, x, u):
        return torch.func.jacfwd(self.f, argnums=1)(x, u)

    def linearize(self, x, u):
        """(A, B) of the continuous-time dynamics at (x, u); single sample."""
        return self.jac_x(x, u), self.jac_u(x, u)
