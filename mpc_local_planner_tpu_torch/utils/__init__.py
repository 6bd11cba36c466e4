"""Host-side helpers (port of ``mpc_local_planner_tpu.utils``): the
publisher, the conversions, the worlds and the native libraries' build
cache."""

from mpc_local_planner_tpu_torch.utils.publisher import Publisher
from mpc_local_planner_tpu_torch.utils.conversion import (
    time_series_to_poses,
    poses_to_plan_array,
)

__all__ = ["Publisher", "time_series_to_poses", "poses_to_plan_array"]
