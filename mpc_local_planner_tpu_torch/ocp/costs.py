"""Objective terms (port of ``mpc_local_planner_tpu.ocp.costs``): minimum
time, the quadratic form with its integral rules and hybrid time weight, and
the terminal quadratic cost and the via-point attraction, on the uniform
grid (dt (...,)) and the non-uniform one (a per-stage dt (..., N)).

State differences use ``se2_boxminus`` (θ wrapped). Each function returns a
scalar per trajectory and broadcasts over leading batch dims.
"""

from __future__ import annotations

import torch

from mpc_local_planner_tpu_torch.core.so2 import angle_diff, se2_boxminus
from mpc_local_planner_tpu_torch.device import const


def trapezoidal(spec) -> bool:
    """The quadratic form's integral trapezoidal rule: stage 0 weighs ½ and
    the ½·dt·lx(x_N) tail is a terminal term."""
    return (
        spec.objective == "quadratic_form"
        and spec.integral_form
        and spec.cost_integration == "trapezoidal"
    )


def quadratic_form_cost(spec, xs, us, dt, xref):
    """(x ⊖ xref)ᵀQ(x ⊖ xref) + uᵀRu summed over stages k = 0..N-1.

    integral_form=False sums the stage terms; integral_form=True weighs them
    by dt, with ``spec.cost_integration``: left_sum = left rectangle;
    trapezoidal = dt·[½lx_0 + Σ_{1..N-1} lx_k + ½lx_N] + dt·Σ lu_k, on the
    non-uniform grid Σ_k dt_k·½(lx_k + lx_{k+1}) + Σ_k dt_k·lu_k. The
    terminal quadratic cost (qf_diag) stays separate.
    """
    q = const(spec.q_diag, xs)
    r = const(spec.r_diag, xs)
    dx = se2_boxminus(xs[..., :-1, :], xref[..., None, :])
    x_term = torch.sum(dx * dx * q, dim=-1)
    u_term = torch.sum(us * us * r, dim=-1)
    if trapezoidal(spec) and spec.nonuniform_dt:
        dx_all = se2_boxminus(xs, xref[..., None, :])
        lx = torch.sum(dx_all * dx_all * q, dim=-1)
        x_int = 0.5 * torch.sum(dt * (lx[..., :-1] + lx[..., 1:]), dim=-1)
        return x_int + torch.sum(dt * u_term, dim=-1)
    if trapezoidal(spec):
        w = torch.ones(x_term.shape[-1], dtype=xs.dtype, device=xs.device)
        w[0] = 0.5
        dxN = se2_boxminus(xs[..., -1, :], xref)
        tail = 0.5 * torch.sum(dxN * dxN * q, dim=-1)
        return (torch.sum(w * x_term + u_term, dim=-1) + tail) * dt
    term = x_term + u_term
    if spec.integral_form:
        term = term * (dt if spec.nonuniform_dt else dt[..., None])
    return torch.sum(term, dim=-1)


def quadratic_final_state_cost(spec, xs, xref):
    """(x_N ⊖ xref)ᵀ Qf (x_N ⊖ xref); zero when qf_diag is None."""
    if spec.qf_diag is None:
        return xs.new_zeros(xs.shape[:-2])
    qf = const(spec.qf_diag, xs)
    dx = se2_boxminus(xs[..., -1, :], xref)
    return torch.sum(dx * dx * qf, dim=-1)


def minimum_time_cost(spec, dt):
    """Σ_k dt_k (parity: corbo MinimumTime): N·dt on a uniform grid, the
    per-stage sum on the non-uniform one."""
    if spec.nonuniform_dt:
        return torch.sum(dt, dim=-1)
    return spec.N * dt


def _via_d2(xs, via_points):
    """Squared position distance of each via point to each state: (..., Mv,
    N+1)."""
    d = xs[..., None, :, :2] - via_points[..., :, None, :2]
    return torch.sum(d * d, dim=-1)


def via_stage_assignment(spec, xs, via_points, via_mask):
    """The stage each via point claims: (..., Mv) int64.

    Unordered: each via point's nearest stage, the first of equal distances
    (``torch.argmin``, as ``jnp.argmin``). Ordered (``spec.via_points_ordered``):
    via point j may only claim a stage at or after the one the previous
    active via point claimed; an inactive (masked) slot never moves that
    cursor (parity: minimum_time_via_points.via_points_ordered).
    """
    d2 = _via_d2(xs, via_points)
    if not spec.via_points_ordered:
        return torch.argmin(d2, dim=-1)
    stages = torch.arange(d2.shape[-1], device=d2.device)
    cursor = torch.zeros(d2.shape[:-2], dtype=torch.long, device=d2.device)
    ks = []
    for j in range(d2.shape[-2]):
        allowed = stages >= cursor[..., None]
        k_j = torch.argmin(torch.where(allowed, d2[..., j, :], torch.inf), dim=-1)
        cursor = torch.where(via_mask[..., j], k_j, cursor)
        ks.append(k_j)
    return torch.stack(ks, dim=-1)


def via_points_cost(spec, xs, via_points, via_mask):
    """Attraction of the trajectory to its via points (parity:
    MinTimeViaPointsCost): per active via point, ``via_position_weight``
    times the squared distance to its assigned state, plus
    ``via_orientation_weight`` times the squared wrapped heading error where
    that weight is positive. Masked slots add exactly zero."""
    if spec.via_cap == 0:
        return xs.new_zeros(xs.shape[:-2])
    d2 = _via_d2(xs, via_points)
    k = via_stage_assignment(spec, xs, via_points, via_mask)
    cost = spec.via_position_weight * torch.gather(d2, -1, k[..., None])[..., 0]
    if spec.via_orientation_weight > 0.0:
        th = xs[..., 2]
        th_k = torch.gather(th[..., None, :].expand(d2.shape), -1, k[..., None])[..., 0]
        dth = angle_diff(th_k, via_points[..., 2])
        cost = cost + spec.via_orientation_weight * dth * dth
    return torch.sum(torch.where(via_mask, cost, 0.0), dim=-1)


def total_cost(spec, xs, us, dt, scenario):
    """Full objective for a trajectory (scalar per batch element): the
    quadratic form (+ the hybrid minimum-time term), minimum time, or
    minimum time plus the via-point attraction, plus the terminal quadratic
    cost."""
    if spec.objective == "quadratic_form":
        c = quadratic_form_cost(spec, xs, us, dt, scenario.xf)
        if spec.hybrid_time_weight > 0.0:
            c = c + spec.hybrid_time_weight * minimum_time_cost(spec, dt)
    elif spec.objective == "minimum_time":
        c = minimum_time_cost(spec, dt)
    else:  # minimum_time_via_points
        c = minimum_time_cost(spec, dt) + via_points_cost(
            spec, xs, scenario.via_points, scenario.via_mask
        )
    if spec.qf_diag is None:
        return c
    return c + quadratic_final_state_cost(spec, xs, scenario.xf)
