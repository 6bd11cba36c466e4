"""Concrete SE(2) kinematic robot models (port of
``mpc_local_planner_tpu.systems.models``): the unicycle, the rear- and
front-wheel-driven Ackermann cars and the kinematic bicycle.

Bounds are returned as float64 CPU tensors, like ``jnp.array`` of Python
floats under x64; callers cast them to their working dtype and device.

Under ``torch.func.jacfwd``, a 0-d tensor combined with a Python float gets
a float64 tangent (seen on torch 2.13), so every model parameter enters
``f`` as a tensor of the control's dtype (``_param``).
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


def _param(like, value):
    return torch.full_like(like, value)


def _unbounded_if_zero(value):
    return value if value > 0 else math.inf


def _steered_bounds(limits: RobotLimits):
    """(v, steering) box of the car-like models."""
    lo = _f64([-limits.max_vel_x_backwards, -limits.max_steering_angle])
    hi = _f64([limits.max_vel_x, limits.max_steering_angle])
    return lo, hi


def _steered_rate_bounds(limits: RobotLimits):
    """(acceleration, steering rate) box of the car-like models."""
    dec = _unbounded_if_zero(limits.dec_lim_x)
    acc = _unbounded_if_zero(limits.acc_lim_x)
    rate = _unbounded_if_zero(limits.max_steering_rate)
    return _f64([-dec, -rate]), _f64([acc, rate])


@dataclasses.dataclass(frozen=True)
class UnicycleModel(BaseRobotSE2):
    """Differential drive / unicycle: u = (v, omega).

    xdot = (v cos th, v sin th, omega).
    """

    control_dim = 2

    def f(self, x, u):
        th = x[..., 2]
        v, om = u[..., 0], u[..., 1]
        return torch.stack([v * torch.cos(th), v * torch.sin(th), om], dim=-1)

    def control_bounds(self, limits: RobotLimits):
        lo = _f64([-limits.max_vel_x_backwards, -limits.max_vel_theta])
        hi = _f64([limits.max_vel_x, limits.max_vel_theta])
        return lo, hi

    def control_rate_bounds(self, limits: RobotLimits):
        dec = _unbounded_if_zero(limits.dec_lim_x)
        acc = _unbounded_if_zero(limits.acc_lim_x)
        acc_th = _unbounded_if_zero(limits.acc_lim_theta)
        return _f64([-dec, -acc_th]), _f64([acc, acc_th])


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
        wb = _param(v, self.wheelbase)
        return torch.stack(
            [v * torch.cos(th), v * torch.sin(th), v * torch.tan(phi) / wb], dim=-1
        )

    def control_bounds(self, limits: RobotLimits):
        return _steered_bounds(limits)

    def control_rate_bounds(self, limits: RobotLimits):
        return _steered_rate_bounds(limits)


@dataclasses.dataclass(frozen=True)
class SimpleCarFrontWheelDrivingModel(SimpleCarModel):
    """Front-wheel-driven Ackermann car: the speed is measured at the steered
    front axle, so the body-frame speed scales by cos(phi):

    xdot = (v cos phi cos th, v cos phi sin th, v sin(phi) / wheelbase).
    """

    def f(self, x, u):
        th = x[..., 2]
        v, phi = u[..., 0], u[..., 1]
        wb = _param(v, self.wheelbase)
        vl = v * torch.cos(phi)
        return torch.stack(
            [vl * torch.cos(th), vl * torch.sin(th), v * torch.sin(phi) / wb], dim=-1
        )


@dataclasses.dataclass(frozen=True)
class KinematicBicycleModelVelocityInput(BaseRobotSE2):
    """Kinematic bicycle with velocity input: u = (v, delta), slip angle
    beta = atan(lr tan(delta) / (lf + lr)),

    xdot = (v cos(th + beta), v sin(th + beta), v sin(beta) / lr).
    """

    lf: float = 0.25
    lr: float = 0.25
    control_dim = 2

    def f(self, x, u):
        th = x[..., 2]
        v, delta = u[..., 0], u[..., 1]
        lr = _param(v, self.lr)
        beta = torch.atan(lr * torch.tan(delta) / _param(v, self.lf + self.lr))
        return torch.stack(
            [v * torch.cos(th + beta), v * torch.sin(th + beta), v * torch.sin(beta) / lr],
            dim=-1,
        )

    def control_bounds(self, limits: RobotLimits):
        return _steered_bounds(limits)

    def control_rate_bounds(self, limits: RobotLimits):
        return _steered_rate_bounds(limits)
