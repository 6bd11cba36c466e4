"""Dual-mode controller: MPC far from the target, local LQR inside a
terminal region (port of ``mpc_local_planner_tpu.controllers.dual_mode``).

Parity: cbr:controllers/dual_mode_controller.h :: DualModeController. The
switch is a weighted-norm ball test on (x ⊖ xref), per scenario, so a batch
mixes modes freely.
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_local_planner_tpu_torch.controllers.lqr import LqrController
from mpc_local_planner_tpu_torch.core.so2 import se2_boxminus


@dataclasses.dataclass(frozen=True)
class DualModeController:
    """Combine a predictive control result with a terminal LQR law."""

    lqr: LqrController            # shares xref
    ball_weights: torch.Tensor    # (nx,)
    ball_radius: float = dataclasses.field(metadata=dict(static=True))

    def in_terminal_region(self, x):
        x = torch.as_tensor(x, device=self.ball_weights.device)
        dtype = torch.promote_types(x.dtype, self.lqr.xref.dtype)
        dx = se2_boxminus(x.to(dtype), self.lqr.xref.to(dtype))
        return torch.sum(dx * dx * self.ball_weights, dim=-1) <= self.ball_radius**2

    def select(self, x, u_mpc):
        """LQR control inside the terminal ball, MPC control outside."""
        u_lqr = self.lqr.control(x)
        inside = self.in_terminal_region(x)
        return torch.where(inside[..., None], u_lqr, torch.as_tensor(u_mpc).to(u_lqr)), inside
