"""Horizon-parallel Riccati solve by associative scans (port of
``mpc_local_planner_tpu.solvers.riccati_pscan``).

The sequential sweep (``solvers/riccati.py``) has N dependent steps. Here
both sweeps are associative scans over the stage axis, written out as
log-depth rounds of compositions (each round composes every element with the
one ``d`` stages away, d = 1, 2, 4, ...), in plain PyTorch.

A horizon segment's conditional value function

    S(x, z) = sup_λ [ λᵀ(z − A x − b) − ½ λᵀ C λ ] + ½ xᵀ J x − ηᵀ x

(x the entry state, z the exit state) composes associatively with
D = (I + C₁J₂)⁻¹:

    A₁₂ = A₂ D A₁                 C₁₂ = A₂ D C₁ A₂ᵀ + C₂
    b₁₂ = A₂ D (b₁ + C₁ η₂) + b₂  J₁₂ = A₁ᵀ J₂ D A₁ + J₁
    η₁₂ = A₁ᵀ (I + J₂C₁)⁻¹ (η₂ − J₂ b₁) + η₁

A stage eliminates u by convex duality (Hi = Huu⁻¹): A = F − G·Hi·Hzuᵀ,
b = r − G·Hi·hu, C = G·Hi·Gᵀ, J = Hzz − Hzu·Hi·Hzuᵀ, η = −(hz − Hzu·Hi·hu);
the terminal cost is the segment (I, 0, 0, −pN, PN). The suffix scan gives
P_{k+1} = J and p_{k+1} = −η at every stage; the gains follow stage-parallel,
and the closed-loop rollout is a prefix scan of affine maps. The solution is
``lqr_solve``'s.
"""

from __future__ import annotations

import torch

from mpc_local_planner_tpu_torch.ops.smallmat import solve_psd
from mpc_local_planner_tpu_torch.solvers.riccati import LqrStep


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _sym(J):
    """The symmetric part. The sweep reads a stage's Hzz only through its
    symmetrized value function, so an AD Hessian's rounding-level asymmetry
    (1e-5 in float32) never reaches its step; an unsymmetrized J would carry
    it through every composition (1e-8 from the sweep's step in float64)."""
    return 0.5 * (J + J.mT)


def _compose(e1, e2):
    """Segment e1 (earlier) followed by e2 (later)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    n = A1.shape[-1]
    M = torch.eye(n, dtype=A1.dtype, device=A1.device) + C1 @ J2
    # D·[A1, b1 + C1 η2, C1] in one multi-right-hand-side solve
    sol = torch.linalg.solve(M, torch.cat([A1, (b1 + _mv(C1, eta2))[..., None], C1], dim=-1))
    DA1, Db1, DC1 = sol[..., :n], sol[..., n], sol[..., n + 1 :]
    A12 = A2 @ DA1
    b12 = _mv(A2, Db1) + b2
    C12 = A2 @ DC1 @ A2.mT + C2
    y = torch.linalg.solve(M.mT, (eta2 - _mv(J2, b1))[..., None])[..., 0]
    eta12 = _mv(A1.mT, y) + eta1
    J12 = A1.mT @ J2 @ DA1 + J1
    return (A12, b12, C12, eta12, _sym(J12))


def _narrow(elems, a, b, mats):
    """Stages a..b−1 of every part (matrices (..., L, n, n), vectors (..., L, n))."""
    return tuple(t.narrow(-3 if m else -2, a, b - a) for t, m in zip(elems, mats))


def _cat(x, y, mats):
    return tuple(torch.cat([u, v], dim=-3 if m else -2) for u, v, m in zip(x, y, mats))


def _suffix_scan(elems, length, mats):
    """suffix[k] = e_k ⊗ e_{k+1} ⊗ … ⊗ e_{L−1}: after the round of offset d,
    element k holds the composition of stages k .. k+2d−1."""
    d = 1
    while d < length:
        head = _compose(_narrow(elems, 0, length - d, mats), _narrow(elems, d, length, mats))
        elems = _cat(head, _narrow(elems, length - d, length, mats), mats)
        d *= 2
    return elems


def _prefix_affine(Ms, vs, length):
    """Prefix compositions of the affine maps z → M_k z + v_k: element k
    becomes the map of stages 0..k."""
    d = 1
    while d < length:
        M1, v1 = Ms[..., : length - d, :, :], vs[..., : length - d, :]
        M2, v2 = Ms[..., d:, :, :], vs[..., d:, :]
        Ms = torch.cat([Ms[..., :d, :, :], M2 @ M1], dim=-3)
        vs = torch.cat([vs[..., :d, :], _mv(M2, v1) + v2], dim=-2)
        d *= 2
    return Ms, vs


def lqr_solve_pscan(
    Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN, reg, *, nx: int, free_tau: bool
) -> LqrStep:
    """Drop-in replacement for ``riccati.lqr_solve``: the same arguments
    (every one with the same leading batch dims, the stage axis next), the
    same solution."""
    N, na, nu = Fz.shape[-3], Fz.shape[-1], Gz.shape[-1]
    dtype, dev = Fz.dtype, Fz.device
    lead = Fz.shape[:-3]

    # ---- stage elements (parallel in N) --------------------------------- #
    Huu_r = Huu + reg[..., None, None, None] * torch.eye(nu, dtype=dtype, device=dev)
    Hi_Gt = solve_psd(Huu_r, Gz.mT)            # Huu⁻¹ Gᵀ (..., N, nu, na)
    Hi_Hzut = solve_psd(Huu_r, Hzu.mT)         # Huu⁻¹ Hzuᵀ
    Hi_hu = solve_psd(Huu_r, hu)               # (..., N, nu)
    eye = torch.eye(na, dtype=dtype, device=dev).expand(lead + (1, na, na))
    zeros_v = Fz.new_zeros(lead + (1, na))
    elems = (
        torch.cat([Fz - Gz @ Hi_Hzut, eye], dim=-3),
        torch.cat([rz - _mv(Gz, Hi_hu), zeros_v], dim=-2),
        torch.cat([Gz @ Hi_Gt, torch.zeros_like(eye)], dim=-3),
        torch.cat([-(hz - _mv(Hzu, Hi_hu)), -pN[..., None, :]], dim=-2),
        _sym(torch.cat([Hzz - Hzu @ Hi_Hzut, PN[..., None, :, :]], dim=-3)),
    )
    mats = (True, False, True, False, True)

    # ---- suffix compositions: the value function after every stage ------- #
    suffix = _suffix_scan(elems, N + 1, mats)
    J_suf, eta_suf = suffix[4], suffix[3]
    P_next = J_suf[..., 1:, :, :]   # P_{k+1}
    p_next = -eta_suf[..., 1:, :]

    # ---- per-stage gains (parallel in N) -------------------------------- #
    PG = P_next @ Gz
    Quu = Huu + Gz.mT @ PG + reg[..., None, None, None] * torch.eye(nu, dtype=dtype, device=dev)
    Qzu = Hzu + Fz.mT @ PG
    qu = hu + _mv(Gz.mT, _mv(P_next, rz) + p_next)
    K = -solve_psd(Quu, Qzu.mT)   # (..., N, nu, na)
    kff = -solve_psd(Quu, qu)     # (..., N, nu)
    dvs = -0.5 * torch.sum(qu * kff, dim=-1)

    # ---- the initial δτ ------------------------------------------------- #
    P0, p0 = J_suf[..., 0, :, :], -eta_suf[..., 0, :]
    ptau = p0[..., na - 1]
    Ptau = P0[..., na - 1, na - 1] + reg
    if free_tau:
        dtau = -ptau / torch.clamp(Ptau, min=torch.finfo(dtype).tiny)
        dv_tau = 0.5 * Ptau * dtau * dtau
    else:
        dtau = torch.zeros_like(ptau)
        dv_tau = torch.zeros_like(ptau)

    # ---- the closed-loop rollout as a prefix scan of affine maps --------- #
    Ms, vs = _prefix_affine(Fz + Gz @ K, rz + _mv(Gz, kff), N)
    z0 = torch.cat([torch.zeros_like(p0[..., : na - 1]), dtau[..., None]], dim=-1)
    zs = torch.cat([z0[..., None, :], _mv(Ms, z0[..., None, :]) + vs], dim=-2)  # (..., N+1, na)
    us = _mv(K, zs[..., :-1, :]) + kff
    return LqrStep(dxs=zs[..., :nx], dus=us, dtau=dtau, dV=torch.sum(dvs, dim=-1) + dv_tau)
