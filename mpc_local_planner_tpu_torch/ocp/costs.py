"""Objective terms (port of ``mpc_local_planner_tpu.ocp.costs``): minimum
time, the quadratic form with its integral rules and hybrid time weight, and
the terminal quadratic cost, on the uniform grid.

State differences use ``se2_boxminus`` (θ wrapped). Each function returns a
scalar per trajectory and broadcasts over leading batch dims. Via points
come with ROADMAP item M9 (K2d); ``OcpSpec`` refuses them.
"""

from __future__ import annotations

import torch

from mpc_local_planner_tpu_torch.core.so2 import se2_boxminus
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
    trapezoidal = dt·[½lx_0 + Σ_{1..N-1} lx_k + ½lx_N] + dt·Σ lu_k. The
    terminal quadratic cost (qf_diag) stays separate.
    """
    q = const(spec.q_diag, xs)
    r = const(spec.r_diag, xs)
    dx = se2_boxminus(xs[..., :-1, :], xref[..., None, :])
    x_term = torch.sum(dx * dx * q, dim=-1)
    u_term = torch.sum(us * us * r, dim=-1)
    if trapezoidal(spec):
        w = torch.ones(x_term.shape[-1], dtype=xs.dtype, device=xs.device)
        w[0] = 0.5
        dxN = se2_boxminus(xs[..., -1, :], xref)
        tail = 0.5 * torch.sum(dxN * dxN * q, dim=-1)
        return (torch.sum(w * x_term + u_term, dim=-1) + tail) * dt
    term = x_term + u_term
    if spec.integral_form:
        term = term * dt[..., None]
    return torch.sum(term, dim=-1)


def quadratic_final_state_cost(spec, xs, xref):
    """(x_N ⊖ xref)ᵀ Qf (x_N ⊖ xref); zero when qf_diag is None."""
    if spec.qf_diag is None:
        return xs.new_zeros(xs.shape[:-2])
    qf = const(spec.qf_diag, xs)
    dx = se2_boxminus(xs[..., -1, :], xref)
    return torch.sum(dx * dx * qf, dim=-1)


def minimum_time_cost(spec, dt):
    """Σ_k dt_k = N·dt on a uniform grid (parity: corbo MinimumTime)."""
    return spec.N * dt


def total_cost(spec, xs, us, dt, scenario):
    """Full objective for a trajectory (scalar per batch element): the
    quadratic form (+ the hybrid minimum-time term) or minimum time, plus
    the terminal quadratic cost."""
    if spec.objective == "quadratic_form":
        c = quadratic_form_cost(spec, xs, us, dt, scenario.xf)
        if spec.hybrid_time_weight > 0.0:
            c = c + spec.hybrid_time_weight * minimum_time_cost(spec, dt)
    else:
        c = minimum_time_cost(spec, dt)
    if spec.qf_diag is None:
        return c
    return c + quadratic_final_state_cost(spec, xs, scenario.xf)
