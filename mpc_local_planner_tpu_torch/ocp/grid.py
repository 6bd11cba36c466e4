"""Decision-variable container (the "grid") and warm-start logic (port of
``mpc_local_planner_tpu.ocp.grid``).

``Primal`` holds xs (..., N+1, 3), us (..., N, nu) and dt: (...,) on a
uniform grid, (..., N) per stage on the non-uniform grid
(``spec.nonuniform_dt``). The per-lane (tensor ``steps``) warm starts and
the grid adaptation come with ROADMAP item M10.
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_local_planner_tpu_torch.core.so2 import (
    _wrap_theta,
    se2_boxminus,
    se2_boxplus,
    se2_interpolate,
)


@dataclasses.dataclass(frozen=True)
class Primal:
    """OCP decision variables. xs: (..., N+1, 3); us: (..., N, nu); dt: (...,)
    shared by every stage, or (..., N) per stage on the non-uniform grid."""

    xs: torch.Tensor
    us: torch.Tensor
    dt: torch.Tensor

    @property
    def n_stages(self) -> int:
        return self.us.shape[-2]


def _set_first_state(xs, x0):
    return torch.cat([x0[..., None, :], xs[..., 1:, :]], dim=-2)


def _per_stage(primal: Primal) -> bool:
    """dt is per stage (..., N), not one per trajectory (...,)."""
    return primal.dt.dim() == primal.us.dim() - 1


def _seed_controls(spec, xs, dt):
    """Initial controls from the interpolated state path: channel 0 (forward
    velocity) gets the signed body-frame displacement per stage; u = 0 would
    give min-time problems no pushback against shrinking dt. dt: (...,) or
    per stage (..., N)."""
    p = xs[..., :2]
    th = xs[..., :-1, 2]
    heading = torch.stack([torch.cos(th), torch.sin(th)], dim=-1)
    disp = p[..., 1:, :] - p[..., :-1, :]
    dtb = dt if dt.dim() == disp.dim() - 1 else dt[..., None]
    v = torch.sum(disp * heading, dim=-1) / dtb
    lo, hi = spec.control_box()
    v = torch.clamp(v, float(lo[0]), float(hi[0])).to(xs.dtype)
    rest = xs.new_zeros(v.shape + (spec.nu - 1,))
    return torch.cat([v[..., None], rest], dim=-1)


def initial_primal(spec, scenario) -> Primal:
    """Straight-line SE(2) interpolation x0 → xf, path-seeded controls,
    dt = dt_ref (at every stage on the non-uniform grid)."""
    x0, xf = scenario.x0, scenario.xf
    alphas = torch.linspace(0.0, 1.0, spec.N + 1, dtype=x0.dtype, device=x0.device)
    # se2_interpolate(x0, xf, a) for every a, written out over the stage axis
    d = se2_boxminus(xf, x0)[..., None, :]
    xs = _wrap_theta(x0[..., None, :] + alphas[:, None] * d)
    dt_shape = x0.shape[:-1] + ((spec.N,) if spec.nonuniform_dt else ())
    dt = torch.full(dt_shape, spec.dt_ref, dtype=x0.dtype, device=x0.device)
    return Primal(xs=xs, us=_seed_controls(spec, xs, dt), dt=dt)


def primal_from_plan(spec, plan_xy_theta, x0, dt=None) -> Primal:
    """Seed from a global plan (..., P, 3): the plan's poses resampled onto
    the N+1 grid states by arc index with shortest-arc angle blending, x_0
    pinned to the measured state ``x0``, dt = ``dt`` (dt_ref by default; at
    every stage on the non-uniform grid), path-seeded controls."""
    P = plan_xy_theta.shape[-2]
    dev = plan_xy_theta.device
    pos = torch.linspace(0.0, float(P - 1), spec.N + 1, dtype=torch.float64, device=dev)
    idx0 = torch.clamp(torch.floor(pos).long(), 0, P - 2)
    frac = (pos - idx0.to(pos.dtype)).to(plan_xy_theta.dtype)
    pa = plan_xy_theta[..., idx0, :]
    pb = plan_xy_theta[..., idx0 + 1, :]
    # the stage fractions broadcast over every leading batch dim of the plan
    xs = se2_interpolate(pa, pb, frac.expand(pa.shape[:-1]))
    xs = _set_first_state(xs, x0)
    dt_shape = xs.shape[:-2] + ((spec.N,) if spec.nonuniform_dt else ())
    dtv = torch.full(dt_shape, spec.dt_ref if dt is None else dt, dtype=xs.dtype, device=dev)
    return Primal(xs=xs, us=_seed_controls(spec, xs, dtv), dt=dtv)


def _take_stages(a, src):
    """Per-lane gather along the stage axis: a (..., S) or (..., S, d); src
    (..., S') integer indices with the same leading (batch) dims."""
    if a.dim() == src.dim():
        return torch.take_along_dim(a, src, dim=-1)
    idx = src[..., None].expand(src.shape + (a.shape[-1],))
    return torch.take_along_dim(a, idx, dim=-2)


def _static_steps(steps):
    if not isinstance(steps, int):
        raise NotImplementedError(
            "per-lane (tensor) warm-start steps are not ported yet (ROADMAP M10)"
        )


def warm_start_shift(primal: Primal, x0, steps: int = 1, spec=None) -> Primal:
    """Shift the previous solution by ``steps`` stages and re-anchor x_0; with
    ``spec`` the appended tail states follow the dynamics x ⊞ dt·f(x, u_last)
    (the last interval's dt on the non-uniform grid, whose per-stage dt
    shifts with the controls)."""
    _static_steps(steps)
    N = primal.n_stages
    dev = primal.xs.device
    src = torch.clamp(torch.arange(N + 1, device=dev) + steps, max=N)
    xs = primal.xs[..., src, :]
    src_u = torch.clamp(torch.arange(N, device=dev) + steps, max=N - 1)
    us = primal.us[..., src_u, :]
    if spec is not None and steps > 0:
        u_last = primal.us[..., -1, :]
        x_tail = primal.xs[..., -1, :]
        dtb = primal.dt[..., -1, None] if _per_stage(primal) else primal.dt[..., None]
        tail = []
        for _s in range(steps):
            x_tail = se2_boxplus(x_tail, dtb * spec.model.f(x_tail, u_last))
            tail.append(x_tail)
        xs = torch.cat([xs[..., : N - steps + 1, :], torch.stack(tail, dim=-2)], dim=-2)
    dt = primal.dt[..., src_u] if _per_stage(primal) else primal.dt
    return Primal(xs=_set_first_state(xs, x0), us=us, dt=dt)


def warm_start_resample(primal: Primal, x0, steps: int = 1, spec=None) -> Primal:
    """Warm start for shrinking-horizon (min-time, xf-fixed) problems: stretch
    the remaining trajectory over the full N-stage grid with
    dt' = dt·(N−steps)/N (terminal-feasible by construction). A per-stage
    dt is gathered at the controls' stages, then scaled."""
    _static_steps(steps)
    N = primal.n_stages
    dtype, dev = primal.xs.dtype, primal.xs.device
    pos = steps + torch.arange(N + 1, dtype=dtype, device=dev) * (N - steps) / N
    i0 = torch.clamp(torch.floor(pos).long(), 0, N - 1)
    frac = (pos - i0.to(dtype))[:, None]
    xa = primal.xs[..., i0, :]
    xb = primal.xs[..., i0 + 1, :]
    xs = _set_first_state(_wrap_theta(xa + frac * se2_boxminus(xb, xa)), x0)
    pos_u = steps + torch.arange(N, dtype=dtype, device=dev) * (N - steps) / N
    iu = torch.clamp(torch.round(pos_u).long(), 0, N - 1)
    us = primal.us[..., iu, :]
    dt_min = 1e-3 if spec is None else max(spec.dt_min, 1e-3)
    dt = primal.dt[..., iu] if _per_stage(primal) else primal.dt
    dt = torch.clamp(dt * (N - steps) / N, min=dt_min)
    return Primal(xs=xs, us=us, dt=dt)
