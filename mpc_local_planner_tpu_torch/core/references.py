"""Reference trajectories (port of ``mpc_local_planner_tpu.core.references``).

Parity: cbr:core ``reference_trajectory.h`` (StaticReference, ZeroReference).
A reference maps stage times to reference state or control values.
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_local_planner_tpu_torch.core.time_series import TimeSeries


@dataclasses.dataclass(frozen=True)
class StaticReference:
    """Constant reference value (parity: corbo::StaticReference)."""

    value: torch.Tensor  # (..., D)

    def at_time(self, t):
        t = torch.as_tensor(t)
        return torch.broadcast_to(self.value, t.shape + self.value.shape)

    def at_stages(self, times):
        return self.at_time(times)


@dataclasses.dataclass(frozen=True)
class ZeroReference:
    """All-zeros reference (parity: corbo::ZeroReference), in the dtype and on
    the device of the times asked for (the default dtype for integer times)."""

    dim: int = dataclasses.field(metadata=dict(static=True))

    def at_time(self, t):
        t = torch.as_tensor(t)
        dtype = t.dtype if t.is_floating_point() else torch.get_default_dtype()
        return torch.zeros(t.shape + (self.dim,), dtype=dtype, device=t.device)

    def at_stages(self, times):
        return self.at_time(times)


@dataclasses.dataclass(frozen=True)
class TrajectoryReference:
    """Time-varying reference backed by a TimeSeries (linear interpolation)."""

    series: TimeSeries

    def at_time(self, t):
        return self.series.interpolate(t)

    def at_stages(self, times):
        return self.series.interpolate(times)
