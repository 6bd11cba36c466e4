"""Simulated plant: the closed-loop testing target (port of
``mpc_local_planner_tpu.plants.simulated_plant``).

Parity: cbr:plants/simulated_plant.h :: SimulatedPlant — integrates the
system dynamics with a selectable integrator, optional input dead time
(cbr:systems/time_value_buffer.h :: TimeValueBuffer, here a FIFO of the
last D controls), additive process noise and measurement noise. The noise
is drawn from an explicit ``torch.Generator`` where the JAX plant takes a
key; without one there is none. ``step`` returns the new ``PlantState``; a
fleet of plants is the leading axes of the state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mpc_local_planner_tpu_torch.numerics.integrators import integrate


@dataclasses.dataclass(frozen=True)
class PlantState:
    x: torch.Tensor          # (..., nx) true state
    u_buffer: torch.Tensor   # (..., D, nu) dead-time FIFO (D = dead-time steps)


def _normal(like, generator):
    """Standard normal noise of ``like``'s shape and dtype, drawn on the
    generator's device and moved to ``like``'s."""
    n = torch.randn(like.shape, generator=generator, dtype=like.dtype, device=generator.device)
    return n.to(like.device)


@dataclasses.dataclass(frozen=True)
class SimulatedPlant:
    model: object  # dynamics (BaseRobotSE2 or any f(x, u) with control_dim)
    method: str = "rk4"
    substeps: int = 1
    dead_time_steps: int = 0
    process_noise_std: float = 0.0
    measurement_noise_std: float = 0.0

    def init_state(self, x0) -> PlantState:
        x0 = torch.as_tensor(x0)
        nu = self.model.control_dim
        return PlantState(
            x=x0,
            u_buffer=torch.zeros(x0.shape[:-1] + (max(self.dead_time_steps, 1), nu),
                                 dtype=x0.dtype, device=x0.device),
        )

    def step(self, state: PlantState, u, dt,
             generator: Optional[torch.Generator] = None) -> PlantState:
        """Advance one control interval (parity: SimulatedPlant::control)."""
        u = torch.as_tensor(u, device=state.x.device)
        if self.dead_time_steps > 0:
            # FIFO: the applied control is the oldest buffered one
            u_eff = state.u_buffer[..., 0, :]
            buf = torch.cat([state.u_buffer[..., 1:, :], u[..., None, :].to(state.u_buffer)],
                            dim=-2)
        else:
            u_eff = u
            buf = state.u_buffer
        x_new = integrate(self.model.f, state.x, u_eff, dt, method=self.method,
                          substeps=self.substeps)
        if self.process_noise_std > 0.0 and generator is not None:
            x_new = x_new + self.process_noise_std * _normal(x_new, generator)
        return PlantState(x=x_new, u_buffer=buf)

    def output(self, state: PlantState, generator: Optional[torch.Generator] = None):
        """Measured state (parity: SimulatedPlant::output; full-state output)."""
        y = state.x
        if self.measurement_noise_std > 0.0 and generator is not None:
            y = y + self.measurement_noise_std * _normal(y, generator)
        return y
