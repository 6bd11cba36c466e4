"""PyTorch / CUDA port of ``mpc_local_planner_tpu`` for one NVIDIA H100.

The module paths mirror the JAX package's. The port runs the warm fleet
cycle of BASELINE configs #1-#3 and the specs ``OcpSpec`` admits:
``make_solver``, ``make_fleet_cycle``, ``make_rescue`` and
``random_ensemble`` run on CUDA unless the caller passes ``device="cpu"``.
The warm solve and the rescue run as one launch each of the hand-written
CUDA fused kernel (``ops/fused_al_sqp_cuda.py``); the other solves take the
un-fused path, whose KKT solve is the hand-written CUDA kernel K1
(``ops/riccati_cuda.py``).
"""

from mpc_local_planner_tpu_torch.benchmarks import (
    config1_unicycle_quadratic,
    config2_diffdrive_obstacles,
    config3_carlike_min_time,
    random_ensemble,
)
from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle
from mpc_local_planner_tpu_torch.solvers.al_sqp import (
    SolverSettings,
    default_init,
    make_solver,
)
from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

__all__ = [
    "SolverSettings",
    "config1_unicycle_quadratic",
    "config2_diffdrive_obstacles",
    "config3_carlike_min_time",
    "default_init",
    "make_fleet_cycle",
    "make_rescue",
    "make_solver",
    "random_ensemble",
]
