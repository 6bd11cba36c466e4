"""OCP assembly: the cost and collocation-defect evaluators of a spec (port
of ``mpc_local_planner_tpu.ocp.problem``). The constraint residuals live in
``ocp.constraints``."""

from __future__ import annotations

import dataclasses

import torch

from mpc_local_planner_tpu_torch.ocp.collocation import collocation_defects
from mpc_local_planner_tpu_torch.ocp.costs import total_cost
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec


@dataclasses.dataclass(frozen=True)
class OcpFunctions:
    """Pure evaluators over (Primal, Scenario); all shapes static per spec."""

    spec: OcpSpec

    def cost(self, primal: Primal, scenario) -> torch.Tensor:
        return total_cost(self.spec, primal.xs, primal.us, primal.dt, scenario)

    def defects(self, primal: Primal) -> torch.Tensor:
        return collocation_defects(
            self.spec.model, self.spec.collocation, primal.xs, primal.us, primal.dt
        )


def make_ocp_functions(spec: OcpSpec) -> OcpFunctions:
    return OcpFunctions(spec=spec)
