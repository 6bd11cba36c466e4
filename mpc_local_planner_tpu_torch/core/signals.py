"""Signal recording (port of ``mpc_local_planner_tpu.core.signals``).

Parity: cbr:core/signal_target_interface.h + signals.h
(SignalTargetInterface — named measurement streams). A host-side recorder of
named scalar or vector streams with ``TimeSeries`` export.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from mpc_local_planner_tpu_torch.core.time_series import TimeSeries


@dataclasses.dataclass
class SignalRecorder:
    """Append-only named measurement streams."""

    _times: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    _values: Dict[str, List[np.ndarray]] = dataclasses.field(default_factory=dict)

    def send_measurement(self, name: str, t: float, value) -> None:
        """Parity: SignalTargetInterface::sendMeasurement."""
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        v = np.atleast_1d(np.asarray(value, dtype=np.float64))
        self._times.setdefault(name, []).append(float(t))
        self._values.setdefault(name, []).append(v)

    def names(self):
        return sorted(self._times)

    def series(self, name: str) -> TimeSeries:
        """One stream as a float64 TimeSeries on the CPU (parity: getTimeSeries)."""
        return TimeSeries(
            times=torch.from_numpy(np.asarray(self._times[name], dtype=np.float64)),
            values=torch.from_numpy(np.stack(self._values[name])),
        )

    def clear(self) -> None:
        self._times.clear()
        self._values.clear()
