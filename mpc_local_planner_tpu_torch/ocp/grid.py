"""Decision-variable container (the "grid") and warm-start logic (port of
``mpc_local_planner_tpu.ocp.grid``).

``Primal`` holds xs (..., N+1, 3), us (..., N, nu) and dt: (...,) on a
uniform grid, (..., N) per stage on the non-uniform grid
(``spec.nonuniform_dt``). The warm starts take a Python int ``steps`` (one
shift for every lane) or an integer tensor of the primal's batch shape (a
shift per lane, clipped to [1, N//2]). The grid adaptation decides between
solves on the host and carries the primal and the stage duals onto the new
horizon.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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

    def batch_shape(self):
        """The shape of ``dt``: the batch shape, and N after it on the
        non-uniform grid."""
        return tuple(self.dt.shape)


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


def _lane_steps(primal: Primal, steps):
    """Per-lane ``steps`` as indices of the primal's batch shape, clipped to
    [1, N//2] (the dual shift clips the same way, so a lane's multipliers
    stay aligned with its constraints)."""
    steps = torch.as_tensor(steps, device=primal.xs.device).long()
    return torch.clamp(torch.broadcast_to(steps, primal.xs.shape[:-2]), 1,
                       max(1, primal.n_stages // 2))


def warm_start_shift(primal: Primal, x0, steps=1, spec=None) -> Primal:
    """Shift the previous solution by ``steps`` stages and re-anchor x_0; with
    ``spec`` the appended tail states follow the dynamics x ⊞ dt·f(x, u_last)
    (the last interval's dt on the non-uniform grid, whose per-stage dt
    shifts with the controls).

    ``steps`` is a Python int (one shift for every lane) or an integer tensor
    with the primal's batch shape (a shift per lane: the same wall-clock
    interval covers a different number of stages on each lane's own dt)."""
    if not isinstance(steps, int):
        return _warm_start_shift_dynamic(primal, x0, steps, spec)
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


def _warm_start_shift_dynamic(primal: Primal, x0, steps, spec) -> Primal:
    """Per-lane ``steps`` of :func:`warm_start_shift`: the state sequence is
    extended once by S_max = max(1, N//2) dynamics steps from the last state,
    and lane b reads stages k + steps_b of it (beyond N, the extrapolated
    tail, as the static loop appends it); the controls and a per-stage dt
    repeat their last stage."""
    N = primal.n_stages
    s_max = max(1, N // 2)
    steps = _lane_steps(primal, steps)
    dev = primal.xs.device
    u_last = primal.us[..., -1, :]
    dtb = primal.dt[..., -1, None] if _per_stage(primal) else primal.dt[..., None]
    x, tail = primal.xs[..., -1, :], []
    for _s in range(s_max):
        if spec is not None:
            x = se2_boxplus(x, dtb * spec.model.f(x, u_last))
        tail.append(x)
    ext_xs = torch.cat([primal.xs, torch.stack(tail, dim=-2)], dim=-2)
    src = torch.clamp(torch.arange(N + 1, device=dev) + steps[..., None], max=N + s_max)
    xs = _take_stages(ext_xs, src)
    src_u = torch.clamp(torch.arange(N, device=dev) + steps[..., None], max=N - 1)
    us = _take_stages(primal.us, src_u)
    dt = _take_stages(primal.dt, src_u) if _per_stage(primal) else primal.dt
    return Primal(xs=_set_first_state(xs, x0), us=us, dt=dt)


def warm_start_resample(primal: Primal, x0, steps=1, spec=None) -> Primal:
    """Warm start for shrinking-horizon (min-time, xf-fixed) problems: stretch
    the remaining trajectory over the full N-stage grid with
    dt' = dt·(N−steps)/N (terminal-feasible by construction). A per-stage
    dt is gathered at the controls' stages, then scaled. ``steps``: a Python
    int, or an integer tensor with the primal's batch shape (a shift per
    lane, see :func:`warm_start_shift`)."""
    if not isinstance(steps, int):
        return _warm_start_resample_dynamic(primal, x0, steps, spec)
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


def _warm_start_resample_dynamic(primal: Primal, x0, steps, spec) -> Primal:
    """Per-lane ``steps`` of :func:`warm_start_resample`: the resample
    positions are computed per lane and gathered with ``_take_stages``."""
    N = primal.n_stages
    dtype, dev = primal.xs.dtype, primal.xs.device
    steps = _lane_steps(primal, steps)
    sf = steps.to(dtype)[..., None]  # (..., 1) broadcasts over the stages
    pos = sf + torch.arange(N + 1, dtype=dtype, device=dev) * (N - sf) / N
    i0 = torch.clamp(torch.floor(pos).long(), 0, N - 1)
    frac = (pos - i0.to(dtype))[..., None]
    xa = _take_stages(primal.xs, i0)
    xb = _take_stages(primal.xs, i0 + 1)
    xs = _set_first_state(_wrap_theta(xa + frac * se2_boxminus(xb, xa)), x0)
    pos_u = sf + torch.arange(N, dtype=dtype, device=dev) * (N - sf) / N
    iu = torch.clamp(torch.round(pos_u).long(), 0, N - 1)
    us = _take_stages(primal.us, iu)
    dt_min = 1e-3 if spec is None else max(spec.dt_min, 1e-3)
    if _per_stage(primal):
        dt = torch.clamp(_take_stages(primal.dt, iu) * (N - sf) / N, min=dt_min)
    else:
        dt = torch.clamp(primal.dt * (N - steps.to(dtype)) / N, min=dt_min)
    return Primal(xs=xs, us=us, dt=dt)


# --------------------------------------------------------------------------- #
# grid adaptation (variable horizon N)
# --------------------------------------------------------------------------- #
def adapt_grid_size(dt: float, N: int, *, dt_ref: float, dt_hyst_ratio: float,
                    min_grid_size: int, max_grid_size: int,
                    mode: str = "time_based_single_step") -> int:
    """Time-based grid adaptation decision (parity: cbr
    ``FiniteDifferencesVariableGrid::adaptGrid``): when the optimized dt
    leaves the hysteresis band around dt_ref, ``time_based_single_step``
    grows or shrinks N by one stage, ``time_based_aggressive_estimate``
    jumps to N* = round(N·dt / dt_ref), within [min, max]_grid_size."""
    in_band = dt_ref * (1.0 - dt_hyst_ratio) <= dt <= dt_ref * (1.0 + dt_hyst_ratio)
    if in_band:
        return N
    if mode == "time_based_aggressive_estimate":
        est = int(round(N * dt / dt_ref))
        return max(min_grid_size, min(max_grid_size, est))
    if dt > dt_ref and N < max_grid_size:
        return N + 1
    if dt < dt_ref and N > min_grid_size:
        return N - 1
    return N


def adapt_grid_nonuniform(primal: Primal, duals, *, control_box,
                          epsilon: float, dt_max: float,
                          min_grid_size: int, max_grid_size: int):
    """Redundant-controls adaptation of the non-uniform per-stage-dt grid
    (parity: cbr ``NonUniformFiniteDifferencesVariableGrid``), one structural
    edit per cycle, decided on the host with numpy. An interval whose
    control change (normalized by the control box ranges) is below
    ``epsilon`` is merged into its neighbour, if their summed dt stays
    within ``dt_max``; otherwise the interval across the largest change
    above 2·epsilon is split in half. The primal, the stage duals and the
    2N dt-box multipliers are carried through the same index map. Returns
    (primal, duals, new_N); new_N == N means no edit."""
    us = primal.us.detach().cpu().numpy()  # (N, nu)
    dt = primal.dt.detach().cpu().numpy()  # (N,)
    N = us.shape[0]
    lo, hi = control_box
    rng = np.maximum(np.asarray(hi, dtype=float) - np.asarray(lo, dtype=float), 1e-9)
    e = np.max(np.abs(np.diff(us, axis=0)) / rng[None, :], axis=1)  # (N-1,)

    remove_k = split_k = None
    if N > min_grid_size and e.size and float(e.min()) < epsilon:
        k = int(np.argmin(e))  # merge interval k+1 into k
        if float(dt[k] + dt[k + 1]) <= dt_max:
            remove_k = k
    if remove_k is None and N < max_grid_size and e.size and float(e.max()) > 2.0 * epsilon:
        split_k = int(np.argmax(e))

    if remove_k is None and split_k is None:
        return primal, duals, N

    dev = primal.xs.device
    if remove_k is not None:
        k = remove_k
        keep_x = np.concatenate([np.arange(k + 1), np.arange(k + 2, N + 1)])
        keep_u = np.concatenate([np.arange(k + 1), np.arange(k + 2, N)])
        xs = primal.xs[..., torch.as_tensor(keep_x, device=dev), :]
        us_n = primal.us[..., torch.as_tensor(keep_u, device=dev), :]
        dt_n = np.concatenate([dt[:k], [dt[k] + dt[k + 1]], dt[k + 2:]])
        dual_ix = keep_u
        new_N = N - 1
    else:
        k = split_k
        xm = se2_interpolate(primal.xs[..., k, :], primal.xs[..., k + 1, :], 0.5)
        xs = torch.cat(
            [primal.xs[..., : k + 1, :], xm[..., None, :], primal.xs[..., k + 1:, :]],
            dim=-2,
        )
        us_n = torch.cat(
            [primal.us[..., : k + 1, :], primal.us[..., k: k + 1, :],
             primal.us[..., k + 1:, :]],
            dim=-2,
        )
        dt_n = np.concatenate([dt[:k], [dt[k] / 2, dt[k] / 2], dt[k + 1:]])
        dual_ix = np.concatenate([np.arange(k + 1), [k], np.arange(k + 1, N)])
        new_N = N + 1
    dt_n = torch.as_tensor(dt_n).to(device=dev, dtype=primal.dt.dtype)

    ix = torch.as_tensor(dual_ix, device=dev)

    def rs(a):
        return a[..., ix, :]

    # the per-interval dt-box multipliers are stage-indexed [hi, lo] pairs
    # flattened to (..., 2N): remapped through the same index map
    mu_dt = duals.mu_dt
    if mu_dt.shape[-1] == 2 * N:
        mu_dt = rs(mu_dt.unflatten(-1, (N, 2))).flatten(-2)
    duals = dataclasses.replace(
        duals,
        lam_def=rs(duals.lam_def),
        mu_obs=rs(duals.mu_obs),
        mu_rate=rs(duals.mu_rate),
        mu_box=rs(duals.mu_box),
        mu_dt=mu_dt,
    )
    return Primal(xs=xs, us=us_n, dt=dt_n), duals, new_N


def resize_primal(primal: Primal, new_N: int, spec=None) -> Primal:
    """Resample the trajectory onto a ``new_N``-stage uniform grid, keeping
    the horizon time T = N·dt (dt' = dt·N/N', within the spec's dt box): the
    states SE(2)-interpolated with shortest-arc angle blending, the controls
    sampled at the nearest stage."""
    N = primal.n_stages
    if new_N == N:
        return primal
    dtype, dev = primal.xs.dtype, primal.xs.device
    pos = torch.arange(new_N + 1, dtype=dtype, device=dev) * (N / new_N)
    i0 = torch.clamp(torch.floor(pos).long(), 0, N - 1)
    frac = (pos - i0.to(dtype))[:, None]
    xa = primal.xs[..., i0, :]
    xb = primal.xs[..., i0 + 1, :]
    xs = _wrap_theta(xa + frac * se2_boxminus(xb, xa))
    iu = torch.clamp(
        torch.round(torch.arange(new_N, dtype=dtype, device=dev) * (N / new_N)).long(),
        0, N - 1,
    )
    us = primal.us[..., iu, :]
    dt = primal.dt * (N / new_N)
    if spec is not None:
        dt = torch.clamp(dt, max(spec.dt_min, 1e-3), spec.dt_max)
    return Primal(xs=xs, us=us, dt=dt)


def resize_duals(duals, new_N: int):
    """Nearest-stage resample of the stage-indexed AL multipliers onto a
    ``new_N``-stage grid (the dual side of :func:`resize_primal`); the
    terminal, dt and ball multipliers and ρ carry over unchanged."""
    N = duals.lam_def.shape[-2]
    if new_N == N:
        return duals
    dev = duals.lam_def.device
    idx = torch.clamp(
        torch.round(torch.arange(new_N, dtype=torch.float64, device=dev) * (N / new_N)).long(),
        0, N - 1,
    )

    def rs(a):
        return a[..., idx, :]

    return dataclasses.replace(
        duals,
        lam_def=rs(duals.lam_def),
        mu_obs=rs(duals.mu_obs),
        mu_rate=rs(duals.mu_rate),
        mu_box=rs(duals.mu_box),
    )
