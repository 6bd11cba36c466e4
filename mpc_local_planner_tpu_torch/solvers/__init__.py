"""Solvers (port of ``mpc_local_planner_tpu.solvers``): the batched AL-SQP
with its Riccati KKT solve, the rescue, the float64 tier and the float64
golden anchor.
"""

from mpc_local_planner_tpu_torch.solvers.golden import solve_golden
from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings, SolveResult, make_solver
from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue
from mpc_local_planner_tpu_torch.solvers.f64_fallback import make_f64_fallback

__all__ = [
    "solve_golden", "SolverSettings", "SolveResult", "make_solver",
    "make_rescue", "make_f64_fallback",
]
