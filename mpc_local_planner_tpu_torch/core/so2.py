"""SO(2)/SE(2) math helpers (PyTorch port of ``mpc_local_planner_tpu.core.so2``).

Every function vectorizes over arbitrary leading batch dimensions and is safe
under ``torch.func`` transforms (no data-dependent control flow).
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 2.0 * math.pi


def normalize_angle(theta):
    """Wrap angle(s) to [-pi, pi).

    ``torch.remainder`` has the sign rule of ``jnp.mod`` (the result takes the
    divisor's sign); ``torch.fmod`` does not. Its derivative is exactly 1 away
    from the wrap point.
    """
    return torch.remainder(theta + math.pi, _TWO_PI) - math.pi


def angle_diff(a, b):
    """Smallest signed difference a - b on SO(2), in [-pi, pi)."""
    return normalize_angle(a - b)


def interpolate_angle(a, b, t):
    """Interpolate from angle a to b along the shortest arc; t in [0, 1]."""
    return normalize_angle(a + t * angle_diff(b, a))


def average_angles(angles, axis=None, weights=None):
    """Circular mean of angles (parity: math_utils.h::average_angles); over
    every element when ``axis`` is None."""
    angles = torch.as_tensor(angles)
    s, c = torch.sin(angles), torch.cos(angles)
    if weights is not None:
        s, c = s * weights, c * weights
    if axis is None:
        return torch.atan2(s.sum(), c.sum())
    return torch.atan2(s.sum(dim=axis), c.sum(dim=axis))


def distance_points2d(p1, p2):
    """Euclidean distance between 2D points (last dim = 2)."""
    return torch.linalg.norm(torch.as_tensor(p1) - torch.as_tensor(p2), dim=-1)


def rot2d(theta):
    """2x2 rotation matrix(es); theta (...,) -> (..., 2, 2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def _wrap_theta(x):
    """Wrap component 2 of (..., 3) states (out of place)."""
    return torch.cat([x[..., :2], normalize_angle(x[..., 2:3])], dim=-1)


def se2_boxminus(xa, xb):
    """SE(2)-aware difference xa ⊖ xb for states (..., 3) = (px, py, theta)."""
    return _wrap_theta(xa - xb)


def se2_boxplus(x, delta):
    """SE(2)-aware increment x ⊞ delta with angle wrap on component 2."""
    return _wrap_theta(x + delta)


def se2_interpolate(xa, xb, t):
    """Linear interpolation of SE(2) states with shortest-arc angle blending.

    ``t`` is a Python float or a tensor broadcastable against ``xa[..., 0]``.
    """
    if isinstance(t, torch.Tensor) and t.dim() == xa.dim() - 1:
        t = t[..., None]
    d = se2_boxminus(xb, xa)
    return _wrap_theta(xa + t * d)
