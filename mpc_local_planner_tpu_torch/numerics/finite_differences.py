"""Finite-difference derivatives (port of
``mpc_local_planner_tpu.numerics.finite_differences``).

Parity: cbr:numerics/finite_differences.h — ForwardDifferences /
CentralDifferences. AD (``torch.func``) is the production derivative path;
these are an independent cross-check of it. One column per coordinate of
the last axis; leading axes of ``x`` are batch axes.
"""

from __future__ import annotations

import torch


def _basis(x):
    return torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)


def forward_jacobian(f, x, eps: float = 1e-6):
    """J[i, j] = (f(x + eps e_j) − f(x)) / eps."""
    x = torch.as_tensor(x)
    f0 = f(x)
    return torch.stack([(f(x + eps * e) - f0) / eps for e in _basis(x)], dim=-1)


def central_jacobian(f, x, eps: float = 1e-6):
    """J[i, j] = (f(x + eps e_j) − f(x − eps e_j)) / (2 eps)."""
    x = torch.as_tensor(x)
    return torch.stack(
        [(f(x + eps * e) - f(x - eps * e)) / (2.0 * eps) for e in _basis(x)], dim=-1
    )


def central_hessian(f, x, eps: float = 1e-4):
    """Hessian of a scalar f by nested central differences."""
    return central_jacobian(lambda y: central_jacobian(f, y, eps), x, eps)
