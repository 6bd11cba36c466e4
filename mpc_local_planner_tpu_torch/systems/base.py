"""SE(2) robot dynamics base (port of ``mpc_local_planner_tpu.systems.base``).

A model is a frozen dataclass whose ``f(x, u)`` is a pure, batch-polymorphic
continuous-time dynamics function. Jacobians come from ``torch.func.jacfwd``.
"""

from __future__ import annotations

import torch


class BaseRobotSE2:
    """Mixin for SE(2) models: state x = (px, py, theta) IS the pose."""

    state_dim: int = 3

    # --- linearization (single sample; vmap for batches) ---
    def jac_x(self, x, u):
        return torch.func.jacfwd(self.f, argnums=0)(x, u)

    def jac_u(self, x, u):
        return torch.func.jacfwd(self.f, argnums=1)(x, u)

    def linearize(self, x, u):
        """(A, B) of the continuous-time dynamics at (x, u); single sample."""
        return self.jac_x(x, u), self.jac_u(x, u)
