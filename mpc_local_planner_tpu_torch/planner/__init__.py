"""Planner layer of the PyTorch port: the config tree, the Controller and
the fleet cycle (the planner shell, ``LocalPlanner``, is ROADMAP item M13).
"""

from mpc_local_planner_tpu_torch.planner.config import (
    PlannerConfig,
    load_config,
    reconfigure_config,
)
from mpc_local_planner_tpu_torch.planner.controller import Controller, ControlResult

__all__ = [
    "PlannerConfig",
    "load_config",
    "reconfigure_config",
    "Controller",
    "ControlResult",
]
