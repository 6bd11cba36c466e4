"""OCP specification (static) and per-solve scenario data (port of
``mpc_local_planner_tpu.ocp.spec``).

``OcpSpec`` takes the JAX package's constructor arguments. This slice ports
the flagship family — ``SimpleCarModel``, forward differences, a point or
disc footprint, point and circle obstacle slots, minimum time with a uniform
variable dt — and raises ``NotImplementedError`` naming the ROADMAP item for
anything else.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mpc_local_planner_tpu_torch.geometry.footprints import (
    CircularFootprint,
    PointFootprint,
)
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
from mpc_local_planner_tpu_torch.systems.models import RobotLimits, SimpleCarModel


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP M9)")


@dataclasses.dataclass(frozen=True)
class OcpSpec:
    """Static problem definition; same fields and defaults as the JAX spec."""

    model: object
    footprint: object
    N: int = 20
    collocation: str = "forward_differences"
    objective: str = "quadratic_form"
    q_diag: Tuple[float, ...] = (2.0, 2.0, 2.0)
    r_diag: Tuple[float, ...] = (1.0, 1.0)
    integral_form: bool = False
    cost_integration: str = "left_sum"
    hybrid_time_weight: float = 0.0
    qf_diag: Optional[Tuple[float, ...]] = None
    ball_weights: Tuple[float, ...] = (1.0, 1.0, 1.0)
    ball_radius: float = 0.0
    xf_fixed: Tuple[bool, bool, bool] = (False, False, False)
    dt_ref: float = 0.3
    dt_min: float = 0.0
    dt_max: float = 10.0
    variable_dt: bool = False
    nonuniform_dt: bool = False
    limits: RobotLimits = dataclasses.field(default_factory=RobotLimits)
    min_obstacle_dist: float = 0.5
    obstacle_cap: int = 0
    via_cap: int = 0
    via_position_weight: float = 1.0
    via_orientation_weight: float = 0.0
    via_points_ordered: bool = False
    enable_dynamic_obstacles: bool = False

    def __post_init__(self):
        if self.nonuniform_dt and not self.variable_dt:
            raise ValueError("nonuniform_dt requires variable_dt")
        if type(self.model) is not SimpleCarModel:
            _not_ported(f"model {type(self.model).__name__}")
        if type(self.footprint) not in (PointFootprint, CircularFootprint):
            _not_ported(f"footprint {type(self.footprint).__name__}")
        if self.collocation != "forward_differences":
            _not_ported(f"collocation {self.collocation!r}")
        if self.objective != "minimum_time":
            _not_ported(f"objective {self.objective!r}")
        if self.qf_diag is not None:
            _not_ported("the terminal quadratic cost (qf_diag)")
        if not self.variable_dt:
            _not_ported("minimum time on a fixed dt")
        if self.nonuniform_dt:
            _not_ported("the non-uniform per-stage dt grid")
        if self.via_cap:
            _not_ported("via points")
        if self.enable_dynamic_obstacles:
            _not_ported("dynamic obstacles")

    @property
    def nx(self) -> int:
        return 3

    @property
    def nu(self) -> int:
        return self.model.control_dim

    @property
    def min_time(self) -> bool:
        return self.objective in ("minimum_time", "minimum_time_via_points")

    def control_box(self):
        return self.model.control_bounds(self.limits)

    def control_rate_box(self):
        return self.model.control_rate_bounds(self.limits)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Per-solve runtime data. Leading batch dims on every leaf."""

    x0: torch.Tensor          # (..., 3) current state
    xf: torch.Tensor          # (..., 3) goal / terminal reference
    obstacles: ObstacleSet
    via_points: torch.Tensor  # (..., Mv, 3)
    via_mask: torch.Tensor    # (..., Mv) bool
    u_prev: torch.Tensor      # (..., nu) control applied in the previous cycle
