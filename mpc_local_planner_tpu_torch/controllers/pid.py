"""PID controller (port of ``mpc_local_planner_tpu.controllers.pid``).

Parity: cbr:controllers/pid_controller.h :: PidController — independent
P/I/D gains per channel on the (reference − state) error; anti-windup by
integral clamping. The state is an explicit ``PidState`` threaded through
``step``; a batch of loops is the leading axes of the error.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mpc_local_planner_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PidState:
    integral: torch.Tensor
    prev_error: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PidController:
    kp: torch.Tensor
    ki: torch.Tensor
    kd: torch.Tensor
    integral_limit: float = dataclasses.field(default=1.0e6, metadata=dict(static=True))

    @staticmethod
    def make(kp, ki=0.0, kd=0.0, dim: int = 1, integral_limit: float = 1.0e6,
             dtype=torch.float32, device=None) -> "PidController":
        """Gains as scalars (the same on every channel) or per channel, in
        ``dtype`` on ``device`` (CUDA unless the caller passes ``"cpu"``)."""
        dev = resolve_device(device)

        def full(v):
            v = torch.as_tensor(v, dtype=dtype)
            return (torch.full((dim,), float(v), dtype=dtype) if v.dim() == 0 else v).to(dev)

        return PidController(kp=full(kp), ki=full(ki), kd=full(kd),
                             integral_limit=float(integral_limit))

    def init_state(self, dim: int = None) -> PidState:
        d = self.kp.shape[-1] if dim is None else dim
        z = torch.zeros((d,), dtype=self.kp.dtype, device=self.kp.device)
        return PidState(integral=z, prev_error=z.clone())

    def step(self, state: PidState, error, dt) -> Tuple[PidState, torch.Tensor]:
        # the clip as jnp.clip computes it: maximum, then minimum
        lim = state.integral.new_tensor(self.integral_limit)
        integral = torch.minimum(torch.maximum(state.integral + error * dt, -lim), lim)
        deriv = (error - state.prev_error) / dt
        u = self.kp * error + self.ki * integral + self.kd * deriv
        return PidState(integral=integral, prev_error=error), u
