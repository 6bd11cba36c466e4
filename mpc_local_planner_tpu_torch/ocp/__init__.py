"""OCP layer: transcription, costs, constraints, problem assembly (port of
``mpc_local_planner_tpu.ocp``)."""

from mpc_local_planner_tpu_torch.ocp.collocation import (
    COLLOCATION_METHODS,
    collocation_defects,
)
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec, Scenario
from mpc_local_planner_tpu_torch.ocp.problem import OcpFunctions, make_ocp_functions
from mpc_local_planner_tpu_torch.ocp.grid import (
    Primal,
    initial_primal,
    primal_from_plan,
    warm_start_shift,
)

__all__ = [
    "COLLOCATION_METHODS",
    "collocation_defects",
    "OcpSpec",
    "Scenario",
    "OcpFunctions",
    "make_ocp_functions",
    "Primal",
    "initial_primal",
    "primal_from_plan",
    "warm_start_shift",
]
