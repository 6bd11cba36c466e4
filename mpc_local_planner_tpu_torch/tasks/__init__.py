"""Tasks: closed-loop simulation harnesses (port of
``mpc_local_planner_tpu.tasks``; parity: cbr:tasks — closed_loop_control_task.h)."""

from mpc_local_planner_tpu_torch.tasks.closed_loop import (
    ClosedLoopControlTask,
    ClosedLoopLog,
    run_feedback_loop,
)

__all__ = ["ClosedLoopControlTask", "ClosedLoopLog", "run_feedback_loop"]
