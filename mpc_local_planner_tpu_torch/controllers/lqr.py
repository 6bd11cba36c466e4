"""LQR state-feedback controller (port of
``mpc_local_planner_tpu.controllers.lqr``).

Parity: cbr:controllers/lqr_controller.h :: LqrController — linearizes the
system at the reference, solves the (discrete or continuous) algebraic
Riccati equation, applies u = uref − K (x ⊖ xref). ``make`` works in
float64, as the JAX controller does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mpc_local_planner_tpu_torch.controllers.simple_state import state_feedback
from mpc_local_planner_tpu_torch.device import resolve_device
from mpc_local_planner_tpu_torch.numerics.control_theory import (
    lqr_gain_continuous,
    lqr_gain_discrete,
)


@dataclasses.dataclass(frozen=True)
class LqrController:
    """u = uref − K·(x ⊖ xref). Build with ``make`` (solves the ARE)."""

    K: torch.Tensor      # (nu, nx)
    xref: torch.Tensor   # (nx,)
    uref: torch.Tensor   # (nu,)
    se2_state: bool = dataclasses.field(default=False, metadata=dict(static=True))

    @staticmethod
    def make(
        model,
        xref,
        uref=None,
        q_diag: Tuple[float, ...] = (1.0, 1.0, 1.0),
        r_diag: Tuple[float, ...] = (1.0, 1.0),
        dt: Optional[float] = None,
        se2_state: bool = True,
        device=None,
    ) -> "LqrController":
        """Linearize ``model`` at (xref, uref) and solve the ARE, in float64
        on ``device`` (CUDA unless the caller passes ``"cpu"``).

        dt=None → continuous-time CARE (the reference models are continuous);
        dt given → discretize A, B (Euler) and solve the DARE.
        """
        dev = resolve_device(device)
        xref = torch.as_tensor(xref, dtype=torch.float64).to(dev)
        if uref is None:
            uref = torch.zeros((model.control_dim,), dtype=torch.float64, device=dev)
        uref = torch.as_tensor(uref, dtype=torch.float64).to(dev)
        A, B = model.linearize(xref, uref)
        Q = torch.diag(torch.tensor(q_diag, dtype=torch.float64, device=dev))
        R = torch.diag(torch.tensor(r_diag, dtype=torch.float64, device=dev))
        if dt is None:
            K = lqr_gain_continuous(A, B, Q, R)
        else:
            Ad = torch.eye(A.shape[-1], dtype=A.dtype, device=dev) + dt * A
            K = lqr_gain_discrete(Ad, dt * B, Q, R)
        return LqrController(K=K, xref=xref, uref=uref, se2_state=se2_state)

    def control(self, x):
        return state_feedback(self.K, self.xref, self.uref, self.se2_state, x)
