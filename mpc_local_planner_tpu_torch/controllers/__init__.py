"""Controller library (port of ``mpc_local_planner_tpu.controllers``).

Parity: cbr:controllers (corbo-controllers) — lqr_controller.h,
pid_controller.h, simple_state_controller.h, dual_mode_controller.h (the
predictive controller is ``planner/controller.py``). Each controller is a
frozen dataclass of tensors on an explicit device; a stateful one threads
its state through ``step``: ``(state, u) = step(state, error, dt)``.
"""

from mpc_local_planner_tpu_torch.controllers.lqr import LqrController
from mpc_local_planner_tpu_torch.controllers.pid import PidController, PidState
from mpc_local_planner_tpu_torch.controllers.simple_state import SimpleStateController
from mpc_local_planner_tpu_torch.controllers.dual_mode import DualModeController

__all__ = [
    "LqrController",
    "PidController",
    "PidState",
    "SimpleStateController",
    "DualModeController",
]
