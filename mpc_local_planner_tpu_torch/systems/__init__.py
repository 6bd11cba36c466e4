"""Robot dynamics models (port of ``mpc_local_planner_tpu.systems``)."""

from mpc_local_planner_tpu_torch.systems.base import BaseRobotSE2  # noqa: F401
from mpc_local_planner_tpu_torch.systems.models import (  # noqa: F401
    UnicycleModel,
    SimpleCarModel,
    SimpleCarFrontWheelDrivingModel,
    KinematicBicycleModelVelocityInput,
    make_robot_dynamics,
    ROBOT_TYPES,
)
