"""Concrete SE(2) kinematic robot models (port of
``mpc_local_planner_tpu.systems.models``).

This slice ports the flagship model, ``SimpleCarModel``. The unicycle,
front-wheel-drive car and kinematic bicycle come with ROADMAP item M9.
Bounds are returned as float64 CPU tensors, like ``jnp.array`` of Python
floats under x64; callers cast them to their working dtype and device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mpc_local_planner_tpu_torch.systems.base import BaseRobotSE2


@dataclasses.dataclass(frozen=True)
class RobotLimits:
    """Input/rate limits. Zero-valued acc/dec/rate limits mean unbounded."""

    max_vel_x: float = 0.4
    max_vel_x_backwards: float = 0.2
    max_vel_theta: float = 0.3
    acc_lim_x: float = 0.0
    dec_lim_x: float = 0.0
    acc_lim_theta: float = 0.0
    max_steering_angle: float = 1.5
    max_steering_rate: float = 0.0


def _f64(values):
    return torch.tensor(values, dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class SimpleCarModel(BaseRobotSE2):
    """Rear-wheel-driven Ackermann car: u = (v, phi).

    xdot = (v cos th, v sin th, v tan(phi) / wheelbase).
    """

    wheelbase: float = 0.5
    control_dim = 2

    def f(self, x, u):
        th = x[..., 2]
        v, phi = u[..., 0], u[..., 1]
        # divide by a tensor: under torch.func.jacfwd, dividing by a Python
        # float yields float64 tangents (seen on torch 2.13)
        wb = torch.full_like(v, self.wheelbase)
        return torch.stack(
            [v * torch.cos(th), v * torch.sin(th), v * torch.tan(phi) / wb], dim=-1
        )

    def control_bounds(self, limits: RobotLimits):
        lo = _f64([-limits.max_vel_x_backwards, -limits.max_steering_angle])
        hi = _f64([limits.max_vel_x, limits.max_steering_angle])
        return lo, hi

    def control_rate_bounds(self, limits: RobotLimits):
        big = math.inf
        dec = limits.dec_lim_x if limits.dec_lim_x > 0 else big
        acc = limits.acc_lim_x if limits.acc_lim_x > 0 else big
        rate = limits.max_steering_rate if limits.max_steering_rate > 0 else big
        return _f64([-dec, -rate]), _f64([acc, rate])
