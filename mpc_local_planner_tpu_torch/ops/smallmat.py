"""Closed-form batched small-matrix inverses and solves (port of
``mpc_local_planner_tpu.ops.smallmat``).

The KKT blocks are 2×2 (Quu) and 3×3 (∂c/∂x_{k+1}); adjugate formulas are
exact, branch-free and vectorize over arbitrary leading batch dims.
"""

from __future__ import annotations

import torch


def det2(A):
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2(A):
    """Inverse of (..., 2, 2)."""
    inv_d = 1.0 / det2(A)
    out = torch.stack(
        [
            torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
            torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
        ],
        dim=-2,
    )
    return out * inv_d[..., None, None]


def _cof3(A, i0, i1, j0, j1):
    return A[..., i0, j0] * A[..., i1, j1] - A[..., i0, j1] * A[..., i1, j0]


def det3(A):
    return (
        A[..., 0, 0] * _cof3(A, 1, 2, 1, 2)
        - A[..., 0, 1] * _cof3(A, 1, 2, 0, 2)
        + A[..., 0, 2] * _cof3(A, 1, 2, 0, 1)
    )


def inv3(A):
    """Inverse of (..., 3, 3) via the adjugate."""
    inv_d = 1.0 / det3(A)
    c00 = _cof3(A, 1, 2, 1, 2)
    c01 = -_cof3(A, 1, 2, 0, 2)
    c02 = _cof3(A, 1, 2, 0, 1)
    c10 = -_cof3(A, 0, 2, 1, 2)
    c11 = _cof3(A, 0, 2, 0, 2)
    c12 = -_cof3(A, 0, 2, 0, 1)
    c20 = _cof3(A, 0, 1, 1, 2)
    c21 = -_cof3(A, 0, 1, 0, 2)
    c22 = _cof3(A, 0, 1, 0, 1)
    adjT = torch.stack(
        [
            torch.stack([c00, c10, c20], dim=-1),
            torch.stack([c01, c11, c21], dim=-1),
            torch.stack([c02, c12, c22], dim=-1),
        ],
        dim=-2,
    )
    return adjT * inv_d[..., None, None]


def _solve_with(inv, A, b):
    if b.dim() == A.dim() - 1:
        return torch.einsum("...ij,...j->...i", inv(A), b)
    return inv(A) @ b


def solve_psd(A, b):
    """Solve A x = b for small SPD A (n ≤ 3 in closed form, Cholesky above);
    b is (..., n) or (..., n, k)."""
    n = A.shape[-1]
    if n == 1:
        return b / (A[..., 0, :] if b.dim() == A.dim() - 1 else A[..., 0, 0:1])
    if n == 2:
        return _solve_with(inv2, A, b)
    if n == 3:
        return _solve_with(inv3, A, b)
    L = torch.linalg.cholesky(A)
    if b.dim() == A.dim() - 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cholesky_solve(b, L)
