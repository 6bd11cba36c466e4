"""Planner layer of the PyTorch port: the config tree, the Controller, the
fleet cycle, the planner shell (``LocalPlanner``) and the serving stream
(``JourneyStream``).
"""

from mpc_local_planner_tpu_torch.planner.config import (
    PlannerConfig,
    load_config,
    reconfigure_config,
)
from mpc_local_planner_tpu_torch.planner.controller import Controller, ControlResult
from mpc_local_planner_tpu_torch.planner.local_planner import LocalPlanner
from mpc_local_planner_tpu_torch.planner.serving import JourneyStream, StreamSettings

__all__ = [
    "PlannerConfig",
    "load_config",
    "reconfigure_config",
    "Controller",
    "ControlResult",
    "LocalPlanner",
    "JourneyStream",
    "StreamSettings",
]
