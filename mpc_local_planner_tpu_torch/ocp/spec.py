"""OCP specification (static) and per-solve scenario data (port of
``mpc_local_planner_tpu.ocp.spec``).

``OcpSpec`` takes the JAX package's constructor arguments. The port runs the
unicycle, both Ackermann cars and the kinematic bicycle with forward,
midpoint or Crank–Nicolson differences or on a shooting grid
("shooting_<integrator>[_<substeps>]"), every footprint of the JAX package
(point, disc, line, two discs, polygon), point, circle, line and polygon
obstacle slots, static or dynamic (constant velocity), minimum time,
minimum time with via points (ordered or unordered, with an optional
orientation weight) or the quadratic form (plain or integral, left-sum or
trapezoidal, with the hybrid time weight), the terminal quadratic cost and
the terminal ball, on a uniform grid with a fixed or variable dt or on the
non-uniform grid of a per-stage dt. It raises ``ValueError`` for an unknown
collocation rule, as the JAX spec does, and ``NotImplementedError`` naming
the ROADMAP item for a model or footprint outside the port. A
``hybrid_time_weight`` of 0 or below leaves the hybrid term out, as in the
JAX package (every use gates on a weight above 0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mpc_local_planner_tpu_torch.geometry.footprints import FOOTPRINT_TYPES
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
from mpc_local_planner_tpu_torch.systems.models import (
    KinematicBicycleModelVelocityInput,
    RobotLimits,
    SimpleCarFrontWheelDrivingModel,
    SimpleCarModel,
    UnicycleModel,
)

MODELS = (
    UnicycleModel,
    SimpleCarModel,
    SimpleCarFrontWheelDrivingModel,
    KinematicBicycleModelVelocityInput,
)


OBJECTIVES = ("quadratic_form", "minimum_time", "minimum_time_via_points")


def _not_ported(what: str, item: str = "M9"):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


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
        if type(self.model) not in MODELS:
            _not_ported(f"model {type(self.model).__name__}")
        if type(self.footprint) not in FOOTPRINT_TYPES.values():
            _not_ported(f"footprint {type(self.footprint).__name__}")
        if self.collocation not in (
            "forward_differences",
            "midpoint_differences",
            "crank_nicolson_differences",
        ) and not self.collocation.startswith("shooting_"):
            raise ValueError(f"unknown collocation {self.collocation!r}")
        if self.objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {self.objective!r}")
        if self.cost_integration not in ("left_sum", "trapezoidal"):
            raise ValueError(f"unknown cost_integration {self.cost_integration!r}")

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

    @staticmethod
    def goal_only(x0, xf, nu: int = 2, obstacle_set: Optional[ObstacleSet] = None,
                  via_cap: int = 0, dtype=torch.float32, device="cpu") -> "Scenario":
        """A point-to-point scenario on ``device``: no via point, u_prev = 0 and
        ``obstacle_set`` (none by default), an unbatched set broadcast over
        the scenario batch."""
        x0 = torch.as_tensor(x0, dtype=dtype).to(device)
        xf = torch.as_tensor(xf, dtype=dtype).to(device)
        if obstacle_set is None:
            obstacle_set = ObstacleSet.empty(dtype=dtype, device=device)
        batch = tuple(x0.shape[:-1])
        if batch and obstacle_set.batch_ndim == 0:
            obstacle_set = obstacle_set._map(
                lambda _n, a: a.expand(batch + a.shape).contiguous()
            )
        return Scenario(
            x0=x0,
            xf=xf,
            obstacles=obstacle_set,
            via_points=torch.zeros(batch + (via_cap, 3), dtype=dtype, device=device),
            via_mask=torch.zeros(batch + (via_cap,), dtype=torch.bool, device=device),
            u_prev=torch.zeros(batch + (nu,), dtype=dtype, device=device),
        )
