"""Static state-feedback controller (port of
``mpc_local_planner_tpu.controllers.simple_state``).

Parity: cbr:controllers/simple_state_controller.h :: SimpleStateController —
u = uref − K (x − xref) with a user-provided constant gain matrix.
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_local_planner_tpu_torch.core.so2 import se2_boxminus


def state_feedback(K, xref, uref, se2_state: bool, x):
    """uref − K·(x ⊖ xref) over the leading axes of ``x``, in the promoted
    dtype of ``x`` and ``K`` (as JAX promotes)."""
    x = torch.as_tensor(x, device=K.device)
    dtype = torch.promote_types(x.dtype, K.dtype)
    x, xref = x.to(dtype), xref.to(dtype)
    dx = se2_boxminus(x, xref) if se2_state else x - xref
    return uref.to(dtype) - torch.einsum("ij,...j->...i", K.to(dtype), dx)


@dataclasses.dataclass(frozen=True)
class SimpleStateController:
    K: torch.Tensor      # (nu, nx)
    xref: torch.Tensor   # (nx,)
    uref: torch.Tensor   # (nu,)
    se2_state: bool = dataclasses.field(default=False, metadata=dict(static=True))

    def control(self, x):
        return state_feedback(self.K, self.xref, self.uref, self.se2_state, x)
