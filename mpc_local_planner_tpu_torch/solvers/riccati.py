"""Batched Riccati (LQR) sweep: the structured KKT solve of the SQP (port of
``mpc_local_planner_tpu.solvers.riccati``).

``lqr_solve`` is the plain PyTorch version of kernel K1
(``ops/riccati_cuda.py``): the CPU path, and the yardstick the kernel is held
against on the card. The shared dt is folded into the augmented stage state
z_k = [δx_k, δu_{k-1}, δτ] (na = nx + nu + 1), which keeps the KKT
block-tridiagonal. Every argument carries the same leading batch dims.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpc_local_planner_tpu_torch.ops.smallmat import solve_psd


class LqrStep(NamedTuple):
    """Solution of one equality-constrained QP subproblem."""

    dxs: torch.Tensor   # (..., N+1, nx) state step
    dus: torch.Tensor   # (..., N, nu) control step
    dtau: torch.Tensor  # (...,) dt step
    dV: torch.Tensor    # (...,) predicted merit decrease


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def lqr_solve(
    Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN, reg, *, nx: int, free_tau: bool
) -> LqrStep:
    """Solve min Σ_k [½ zᵀHzz z + zᵀHzu u + ½ uᵀHuu u + hzᵀz + huᵀu] + terminal
    s.t. z_{k+1} = Fz_k z_k + Gz_k u_k + rz_k,  z_0 = [0, 0, δτ] (δτ free iff
    free_tau).

    Shapes: Fz (..., N, na, na), Gz (..., N, na, nu), rz (..., N, na),
    Hzz (..., N, na, na), Hzu (..., N, na, nu), Huu (..., N, nu, nu),
    hz (..., N, na), hu (..., N, nu), PN (..., na, na), pN (..., na),
    reg (...,) — the Levenberg regularizer on Quu and on the δτ minimization.
    """
    na, nu, N = Fz.shape[-1], Gz.shape[-1], Fz.shape[-3]
    dtype = Fz.dtype
    W = torch.cat([Fz, Gz], dim=-1)                                # (..., N, na, nw)
    Huu_r = Huu + reg[..., None, None, None] * torch.eye(nu, dtype=dtype, device=Fz.device)
    Hfull = torch.cat(
        [torch.cat([Hzz, Hzu], dim=-1), torch.cat([Hzu.mT, Huu_r], dim=-1)], dim=-2
    )
    hfull = torch.cat([hz, hu], dim=-1)

    P, p = PN, pN
    Ks, kffs, dvs = [None] * N, [None] * N, []
    for k in reversed(range(N)):
        Wk = W[..., k, :, :]
        PW = P @ Wk
        Q = Hfull[..., k, :, :] + Wk.mT @ PW
        q = hfull[..., k, :] + _mv(Wk.mT, _mv(P, rz[..., k, :]) + p)
        Quu = Q[..., na:, na:]
        Kk = -solve_psd(Quu, torch.cat([Q[..., na:, :na], q[..., na:, None]], dim=-1))
        K, kff = Kk[..., :na], Kk[..., na]
        Pn = Q[..., :na, :na] + Q[..., :na, na:] @ K
        P = 0.5 * (Pn + Pn.mT)
        p = q[..., :na] + _mv(Q[..., :na, na:], kff)
        dvs.append(-0.5 * torch.sum(q[..., na:] * kff, dim=-1))
        Ks[k], kffs[k] = K, kff

    # initial stage: δx_0 = 0, δu_{-1} = 0; minimize over δτ when free.
    ptau = p[..., na - 1]
    Ptau = P[..., na - 1, na - 1] + reg
    if free_tau:
        dtau = -ptau / torch.clamp(Ptau, min=torch.finfo(dtype).tiny)
        dv_tau = 0.5 * Ptau * dtau * dtau
    else:
        dtau = torch.zeros_like(ptau)
        dv_tau = torch.zeros_like(ptau)

    z = torch.cat([torch.zeros_like(p[..., : na - 1]), dtau[..., None]], dim=-1)
    zs, us = [z], []
    for k in range(N):
        u = _mv(Ks[k], z) + kffs[k]
        z = _mv(Fz[..., k, :, :], z) + _mv(Gz[..., k, :, :], u) + rz[..., k, :]
        zs.append(z)
        us.append(u)
    zs_all = torch.stack(zs, dim=-2)
    return LqrStep(
        dxs=zs_all[..., :nx],
        dus=torch.stack(us, dim=-2),
        dtau=dtau,
        dV=torch.stack(dvs, dim=-1).sum(dim=-1) + dv_tau,
    )


def build_augmented_transition(F, G, m, r, *, nu: int):
    """Augmented-state transition matrices over z = [δx, δu_prev, δτ]:
        δx rows:      [F, 0, m]·z + G·δu + r
        δu_prev rows: δu_k
        δτ row:       δτ_k
    F (..., N, nx, nx), G (..., N, nx, nu), m (..., N, nx), r (..., N, nx).
    """
    nx = F.shape[-2]
    lead = F.shape[:-2]  # (..., N)
    na = nx + nu + 1
    eye_na = torch.eye(na, dtype=F.dtype, device=F.device)
    top = torch.cat([F, F.new_zeros(lead + (nx, nu)), m[..., None]], dim=-1)
    mid = F.new_zeros(lead + (nu, na))
    bot = eye_na[na - 1 : na].expand(lead + (1, na))
    Fz = torch.cat([top, mid, bot], dim=-2)
    Gz = torch.cat(
        [
            G,
            torch.eye(nu, dtype=F.dtype, device=F.device).expand(lead + (nu, nu)),
            F.new_zeros(lead + (1, nu)),
        ],
        dim=-2,
    )
    rz = torch.cat([r, F.new_zeros(lead + (nu + 1,))], dim=-1)
    return Fz, Gz, rz
