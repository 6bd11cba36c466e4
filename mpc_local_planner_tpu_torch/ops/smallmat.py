"""Closed-form batched small-matrix inverses and solves (port of
``mpc_local_planner_tpu.ops.smallmat``).

The KKT blocks are 2×2 (Quu) and 3×3 (∂c/∂x_{k+1}); adjugate formulas are
exact, branch-free and vectorize over arbitrary leading batch dims.
"""

from __future__ import annotations

import torch


def det2(A):
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2(A, eps: float = 0.0):
    """Inverse of (..., 2, 2); eps regularizes the determinant."""
    d = det2(A)
    if eps:
        d = torch.where(d.abs() > eps, d, torch.where(d >= 0, d + eps, d - eps))
    inv_d = 1.0 / d
    out = torch.stack(
        [
            torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
            torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
        ],
        dim=-2,
    )
    return out * inv_d[..., None, None]


def solve2(A, b):
    """Solve (..., 2, 2) @ x = b for b (..., 2) or (..., 2, k)."""
    if b.shape[-1] == 2 and b.dim() == A.dim() - 1:
        return torch.einsum("...ij,...j->...i", inv2(A), b)
    return inv2(A) @ b


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


def solve3(A, b):
    """Solve (..., 3, 3) @ x = b for b (..., 3) or (..., 3, k)."""
    if b.shape[-1] == 3 and b.dim() == A.dim() - 1:
        return torch.einsum("...ij,...j->...i", inv3(A), b)
    return inv3(A) @ b


def solve_unrolled(A, B):
    """Batched solve A X = B for small n by unrolled Gaussian elimination
    without pivoting (elementwise ops only).

    A: (..., n, n); B: (..., n, m). Meant for well-conditioned systems with
    dominant diagonals (e.g. M = I + PSD·PSD products in the
    horizon-parallel Riccati compositions).
    """
    n, m = A.shape[-1], B.shape[-1]
    a = [[A[..., i, j] for j in range(n)] for i in range(n)]
    b = [[B[..., i, j] for j in range(m)] for i in range(n)]
    for k in range(n):
        inv_piv = 1.0 / a[k][k]
        for i in range(k + 1, n):
            f = a[i][k] * inv_piv
            for j in range(k + 1, n):
                a[i][j] = a[i][j] - f * a[k][j]
            for j in range(m):
                b[i][j] = b[i][j] - f * b[k][j]
    x = [[None] * m for _ in range(n)]
    for i in range(n - 1, -1, -1):
        inv_piv = 1.0 / a[i][i]
        for j in range(m):
            acc = b[i][j]
            for l in range(i + 1, n):
                acc = acc - a[i][l] * x[l][j]
            x[i][j] = acc * inv_piv
    return torch.stack([torch.stack(row, dim=-1) for row in x], dim=-2)


def solve_psd(A, b):
    """Solve A x = b for small SPD A (n ≤ 3 in closed form, Cholesky above);
    b is (..., n) or (..., n, k)."""
    n = A.shape[-1]
    if n == 1:
        return b / (A[..., 0, :] if b.dim() == A.dim() - 1 else A[..., 0, 0:1])
    if n == 2:
        return solve2(A, b)
    if n == 3:
        return solve3(A, b)
    L = torch.linalg.cholesky(A)
    if b.dim() == A.dim() - 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cholesky_solve(b, L)
