"""Benchmark problem definitions (port of ``mpc_local_planner_tpu.benchmarks``:
BASELINE.json configs #1-#3 and the scenario ensemble)."""

from __future__ import annotations

from typing import Optional

import torch

from mpc_local_planner_tpu_torch.device import resolve_device
from mpc_local_planner_tpu_torch.geometry.footprints import CircularFootprint, PointFootprint
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec, Scenario
from mpc_local_planner_tpu_torch.systems.models import (
    RobotLimits,
    SimpleCarModel,
    UnicycleModel,
)

DIFF_DRIVE_LIMITS = RobotLimits(
    max_vel_x=0.4, max_vel_x_backwards=0.2, max_vel_theta=0.3,
    acc_lim_x=0.5, acc_lim_theta=0.5,
)
CARLIKE_LIMITS = RobotLimits(
    max_vel_x=0.4, max_vel_x_backwards=0.2, max_steering_angle=1.0,
    acc_lim_x=0.5,
)


def config1_unicycle_quadratic(N: int = 20) -> OcpSpec:
    """BASELINE config #1: unicycle, quadratic form, no obstacles."""
    return OcpSpec(
        model=UnicycleModel(), footprint=PointFootprint(), N=N,
        objective="quadratic_form", q_diag=(2.0, 2.0, 2.0), r_diag=(1.0, 1.0),
        qf_diag=(10.0, 10.0, 10.0), dt_ref=0.3, limits=DIFF_DRIVE_LIMITS,
    )


def config2_diffdrive_obstacles(N: int = 30, obstacle_cap: int = 10) -> OcpSpec:
    """BASELINE config #2: diff-drive, 10 circular obstacles, terminal ball."""
    return OcpSpec(
        model=UnicycleModel(), footprint=CircularFootprint(radius=0.2), N=N,
        objective="quadratic_form", q_diag=(2.0, 2.0, 2.0), r_diag=(1.0, 1.0),
        qf_diag=(20.0, 20.0, 20.0), ball_weights=(1.0, 1.0, 0.0),
        ball_radius=0.2, dt_ref=0.3, min_obstacle_dist=0.1,
        obstacle_cap=obstacle_cap, limits=DIFF_DRIVE_LIMITS,
    )


def config3_carlike_min_time(N: int = 50, obstacle_cap: int = 10) -> OcpSpec:
    """BASELINE config #3: car-like (Ackermann) time-optimal with obstacles."""
    return OcpSpec(
        model=SimpleCarModel(wheelbase=0.5), footprint=CircularFootprint(radius=0.2),
        N=N, objective="minimum_time", variable_dt=True, dt_min=1e-3, dt_max=0.5,
        dt_ref=0.3, xf_fixed=(True, True, True), min_obstacle_dist=0.1,
        obstacle_cap=obstacle_cap, limits=CARLIKE_LIMITS,
    )


def random_ensemble(
    spec: OcpSpec,
    batch: int,
    generator: torch.Generator,
    dtype=torch.float32,
    device=None,
    goal_radius: float = 3.0,
    n_obstacles: Optional[int] = None,
) -> Scenario:
    """Random (start pose × goal × obstacle field) scenario ensemble.

    Obstacles are circles sampled between start and goal, kept clear of both
    endpoints so every instance is feasible. The numbers are drawn from
    ``generator`` on its own device and moved to ``device`` (CUDA unless the
    caller asks for the CPU); they differ from the JAX package's streams.
    """
    dev = resolve_device(device)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
        return (lo + (hi - lo) * u).to(dev)

    x0 = torch.zeros((batch, 3), dtype=dtype, device=dev)
    ang = uniform((batch,), -0.8, 0.8)
    dist = uniform((batch,), 0.6 * goal_radius, goal_radius)
    xf = torch.stack([dist * torch.cos(ang), dist * torch.sin(ang), ang], dim=-1)

    M = spec.obstacle_cap
    u_prev = torch.zeros((batch, spec.nu), dtype=dtype, device=dev)
    via_points = torch.zeros((batch, spec.via_cap, 3), dtype=dtype, device=dev)
    via_mask = torch.zeros((batch, spec.via_cap), dtype=torch.bool, device=dev)
    if M == 0:
        obstacles = ObstacleSet.empty(dtype=dtype, device=dev, batch=(batch,))
        return Scenario(x0, xf, obstacles, via_points, via_mask, u_prev)

    n_act = M if n_obstacles is None else min(n_obstacles, M)
    frac = uniform((batch, M), 0.25, 0.75)
    lateral = uniform((batch, M), -1.0, 1.0)
    heading = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    normal = torch.stack([-torch.sin(ang), torch.cos(ang)], dim=-1)
    centers = (
        frac[..., None] * dist[:, None, None] * heading[:, None, :]
        + lateral[..., None] * normal[:, None, :]
    )
    mask = (torch.arange(M, device=dev) < n_act)[None, :] & (torch.abs(lateral) > 0.45)
    empty = ObstacleSet.empty(dtype=dtype, device=dev, batch=(batch,), max_polygon_vertices=3)
    obstacles = ObstacleSet(
        points=empty.points, point_vels=empty.point_vels, point_mask=empty.point_mask,
        circles=centers,
        circle_radii=torch.full((batch, M), 0.25, dtype=dtype, device=dev),
        circle_vels=torch.zeros((batch, M, 2), dtype=dtype, device=dev),
        circle_mask=mask,
        lines=empty.lines, line_vels=empty.line_vels, line_mask=empty.line_mask,
        polygons=empty.polygons, polygon_nv=empty.polygon_nv,
        polygon_vels=empty.polygon_vels, polygon_mask=empty.polygon_mask,
    )
    return Scenario(x0, xf, obstacles, via_points, via_mask, u_prev)
