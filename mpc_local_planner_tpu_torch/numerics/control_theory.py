"""Control-theory solvers: Riccati, Lyapunov, Sylvester, ctrb/obsv (port of
``mpc_local_planner_tpu.numerics.control_theory``).

Parity: cbr:numerics/{algebraic_riccati_discrete, algebraic_riccati_continuous,
lyapunov_discrete, lyapunov_continuous, sylvester, controllability,
observability}.h — used by the LQR controller (not on the planner hot path).

The reference solves these with Schur decompositions; the JAX package uses
fixed-iteration methods instead, and so does the port, with the same
iteration counts and no early stop (each ``lax.scan`` is a Python loop):
  - DARE: structure-preserving doubling (SDA).
  - CARE: the determinant-scaled matrix sign function of the Hamiltonian.
  - discrete Lyapunov: Smith doubling (A ← A², Q ← Q + AQAᵀ).
  - continuous Lyapunov / Sylvester: the Kronecker linear solve.
Leading axes are batch axes. ``torch.linalg.solve`` reads a right-hand side
of one dimension fewer than the matrix as a batch of vectors, where NumPy
(and JAX) read it as a matrix; every solve here passes matrices, the
Kronecker solves a vector as an explicit column.
"""

from __future__ import annotations

import torch


def _t(a):
    return a.transpose(-1, -2)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _kron(a, b):
    """Kronecker product over the last two axes (the rest broadcast)."""
    m, n = a.shape[-2:]
    p, q = b.shape[-2:]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(out.shape[:-4] + (m * p, n * q))


def _as_tensors(*args):
    return [torch.as_tensor(a) for a in args]


def _doubling_dare(A, B, Q, R, iters: int):
    """Structure-preserving doubling for AᵀXA − X − AᵀXB(R+BᵀXB)⁻¹BᵀXA + Q = 0."""
    I = _eye(A.shape[-1], A)
    Ak, Gk, Hk = A, B @ torch.linalg.solve(R, _t(B)), Q
    for _ in range(iters):
        # SDA recursion with W = I + G H:
        #   A₁ = A W⁻¹ A ;  G₁ = G + A G W⁻ᵀ Aᵀ ;  H₁ = H + Aᵀ H W⁻¹ A
        W = I + Gk @ Hk
        Winv_A = torch.linalg.solve(W, Ak)
        Ak, Gk, Hk = (
            Ak @ Winv_A,
            Gk + Ak @ Gk @ torch.linalg.solve(_t(W), _t(Ak)),
            Hk + _t(Ak) @ Hk @ Winv_A,
        )
    return Hk


def are_discrete(A, B, Q, R, iters: int = 30):
    """Solve the DARE (parity: AlgebraicRiccatiDiscrete::solve). Returns X."""
    A, B, Q, R = _as_tensors(A, B, Q, R)
    X = _doubling_dare(A, B, Q, R, iters)
    return 0.5 * (X + _t(X))


def lqr_gain_discrete(A, B, Q, R, iters: int = 30):
    """K minimizing Σ xᵀQx + uᵀRu for x⁺ = Ax + Bu; u = −Kx."""
    A, B, Q, R = _as_tensors(A, B, Q, R)
    X = are_discrete(A, B, Q, R, iters)
    Bt = _t(B)
    return torch.linalg.solve(R + Bt @ X @ B, Bt @ X @ A)


def are_continuous(A, B, Q, R, iters: int = 30):
    """Solve the CARE AᵀX + XA − XBR⁻¹BᵀX + Q = 0 (parity:
    AlgebraicRiccatiContinuous::solve) by the matrix sign function of the
    Hamiltonian H = [[A, −G], [−Q, −Aᵀ]]: its stable invariant subspace is
    span([I; X]); the iteration S ← ½(cS + (cS)⁻¹) is determinant-scaled."""
    A, B, Q, R = _as_tensors(A, B, Q, R)
    n = A.shape[-1]
    G = B @ torch.linalg.solve(R, _t(B))
    S = torch.cat([torch.cat([A, -G], dim=-1), torch.cat([-Q, -_t(A)], dim=-1)], dim=-2)
    for _ in range(iters):
        d = torch.abs(torch.linalg.det(S)) ** (1.0 / (2 * n))
        Sc = S / d[..., None, None]
        S = 0.5 * (Sc + torch.linalg.inv(Sc))
    # stable projector P₋ = (I − S)/2; its columns lie in span([I; X])
    P = 0.5 * (_eye(2 * n, A) - S)
    X = P[..., n:, :n] @ torch.linalg.inv(P[..., :n, :n])
    return 0.5 * (X + _t(X))


def lqr_gain_continuous(A, B, Q, R, iters: int = 40):
    """K for ẋ = Ax + Bu with u = −Kx (parity: LqrController continuous)."""
    A, B, Q, R = _as_tensors(A, B, Q, R)
    X = are_continuous(A, B, Q, R, iters)
    return torch.linalg.solve(R, _t(B) @ X)


def lyapunov_discrete(A, Q, iters: int = 25):
    """Solve A X Aᵀ − X + Q = 0 by Smith doubling (parity: LyapunovDiscrete)."""
    Ak, X = _as_tensors(A, Q)
    for _ in range(iters):
        Ak, X = Ak @ Ak, X + Ak @ X @ _t(Ak)
    return 0.5 * (X + _t(X))


def _kron_solve(L, rhs_vec, n, m):
    X = torch.linalg.solve(L, rhs_vec[..., None])[..., 0]
    return X.reshape(rhs_vec.shape[:-1] + (n, m))


def lyapunov_continuous(A, Q):
    """Solve A X + X Aᵀ + Q = 0 via the Kronecker linear system (parity:
    LyapunovContinuous; the reference uses Bartels–Stewart)."""
    A, Q = _as_tensors(A, Q)
    n = A.shape[-1]
    I = _eye(n, A)
    # with a row-major vec: vec(AX + XAᵀ) = (I⊗A + A⊗I) vec(X)
    L = _kron(I, A) + _kron(A, I)
    return _kron_solve(L, -Q.reshape(Q.shape[:-2] + (n * n,)), n, n)


def sylvester_continuous(A, B, C):
    """Solve A X + X B + C = 0 (parity: cbr sylvester.h)."""
    A, B, C = _as_tensors(A, B, C)
    n, m = A.shape[-1], B.shape[-1]
    # row-major vec: vec(AX) = (A ⊗ I_m) vec(X); vec(XB) = (I_n ⊗ Bᵀ) vec(X)
    L = _kron(A, _eye(m, A)) + _kron(_eye(n, A), _t(B))
    return _kron_solve(L, -C.reshape(C.shape[:-2] + (n * m,)), n, m)


def controllability_matrix(A, B):
    """[B, AB, ..., A^{n−1}B] (parity: cbr controllability.h)."""
    A, B = _as_tensors(A, B)
    blocks = [B]
    for _ in range(A.shape[-1] - 1):
        blocks.append(A @ blocks[-1])
    return torch.cat(blocks, dim=-1)


def _full_rank(M, n, tol):
    s = torch.linalg.svdvals(M)
    return torch.sum(s > tol * s[..., :1], dim=-1) == n


def is_controllable(A, B, tol: float = 1e-9):
    A = torch.as_tensor(A)
    return _full_rank(controllability_matrix(A, B), A.shape[-1], tol)


def observability_matrix(A, C):
    """[C; CA; ...; CA^{n−1}] (parity: cbr observability.h)."""
    A, C = _as_tensors(A, C)
    blocks = [C]
    for _ in range(A.shape[-1] - 1):
        blocks.append(blocks[-1] @ A)
    return torch.cat(blocks, dim=-2)


def is_observable(A, C, tol: float = 1e-9):
    A = torch.as_tensor(A)
    return _full_rank(observability_matrix(A, C), A.shape[-1], tol)
