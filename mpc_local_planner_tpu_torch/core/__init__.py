"""Core math and containers (port of ``mpc_local_planner_tpu.core``; parity:
cbr:core — time.h, time_series.h, references)."""

from mpc_local_planner_tpu_torch.core.so2 import (  # noqa: F401
    normalize_angle,
    angle_diff,
    interpolate_angle,
    average_angles,
    distance_points2d,
    se2_boxminus,
    se2_boxplus,
    se2_interpolate,
    rot2d,
)
from mpc_local_planner_tpu_torch.core.time_series import TimeSeries, TimeSeriesSE2  # noqa: F401
from mpc_local_planner_tpu_torch.core.references import (  # noqa: F401
    StaticReference,
    ZeroReference,
    TrajectoryReference,
)
