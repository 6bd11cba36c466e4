"""Time series containers (port of ``mpc_local_planner_tpu.core.time_series``).

A ``TimeSeries`` holds times (T,) and values (..., T, D), sampled by
zero-order hold or linear interpolation; ``TimeSeriesSE2`` blends its
component 2 as an angle on the short arc. The Controller returns its planned
state and control sequences in this form.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mpc_local_planner_tpu_torch.core.so2 import interpolate_angle
from mpc_local_planner_tpu_torch.core.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TimeSeries:
    """times: (..., T); values: (..., T, D). ZOH or linear interpolation."""

    times: torch.Tensor
    values: torch.Tensor

    @property
    def num_samples(self) -> int:
        return self.times.shape[-1]

    @property
    def value_dim(self) -> int:
        return self.values.shape[-1]

    def interpolate(self, t, mode: str = "linear"):
        """Sample the values at time(s) ``t`` (a scalar or (...,)) on a 1-D
        ``times``; outside the support the endpoint values are held."""
        times, values = self.times, self.values
        t = torch.as_tensor(t, dtype=times.dtype, device=times.device)
        idx = torch.searchsorted(times, t, right=True) - 1
        idx = torch.clamp(idx, 0, times.shape[-1] - 2)
        t0, t1 = times[idx], times[idx + 1]
        v0, v1 = values[..., idx, :], values[..., idx + 1, :]
        if mode == "zoh":
            return torch.where((t >= times[-1])[..., None], values[..., -1, :], v0)
        denom = torch.where(t1 - t0 > 0, t1 - t0, torch.ones_like(t0))
        alpha = torch.clamp((t - t0) / denom, 0.0, 1.0)[..., None]
        return self._blend(v0, v1, alpha)

    def _blend(self, v0, v1, alpha):
        return v0 + alpha * (v1 - v0)

    def first(self) -> torch.Tensor:
        return self.values[..., 0, :]

    def last(self) -> torch.Tensor:
        return self.values[..., -1, :]

    def shifted(self, dt) -> "TimeSeries":
        """The series shifted in time by -dt."""
        return dataclasses.replace(self, times=self.times - dt)


@dataclasses.dataclass(frozen=True)
class TimeSeriesSE2(TimeSeries):
    """A TimeSeries whose component 2 is an angle, blended on the short arc."""

    def _blend(self, v0, v1, alpha):
        out = v0 + alpha * (v1 - v0)
        th = interpolate_angle(v0[..., 2], v1[..., 2], alpha[..., 0])
        return torch.cat([out[..., :2], th[..., None], out[..., 3:]], dim=-1)


def stack_time_series(ts_list: Tuple[TimeSeries, ...]) -> TimeSeries:
    """Stack same-shape series along a new leading batch axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *ts_list)
