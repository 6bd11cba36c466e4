"""Inequality and equality constraint residuals (port of
``mpc_local_planner_tpu.ocp.constraints``).

Every inequality is g(z) ≤ 0; padded slots evaluate to a large negative
constant. The trajectory arguments may carry more leading dims than the
scenario (line-search candidates in front of the lane axis); they broadcast.
"""

from __future__ import annotations

import torch

from mpc_local_planner_tpu_torch.core.so2 import se2_boxminus
from mpc_local_planner_tpu_torch.device import const
from mpc_local_planner_tpu_torch.geometry.obstacles import BIG_DISTANCE


def obstacle_inequalities(spec, xs, dt, scenario):
    """Per-stage obstacle terms, stages k = 1..N (x_0 is fixed): (..., N, M).
    Dynamic obstacles are predicted to t_k = k·dt (on the non-uniform grid
    the cumulative Σ_{j<k} dt_j) at this trajectory's dt (a line-search
    candidate's, a dual update's current one)."""
    if spec.obstacle_cap == 0:
        return xs.new_zeros(xs.shape[:-2] + (spec.N, 0))
    poses = xs[..., 1:, :]
    obs = scenario.obstacles.with_stage_axis()
    if spec.enable_dynamic_obstacles:
        # constant-velocity extrapolation to the stage times, dt detached:
        # predicted positions are stage data, not decision-dependent
        if spec.nonuniform_dt:
            t = torch.cumsum(dt.detach(), dim=-1)
        else:
            k = torch.arange(1, spec.N + 1, dtype=xs.dtype, device=xs.device)
            t = k * dt.detach()[..., None]
        obs = obs.predict(t)
    d = spec.footprint.distances(poses, obs)
    return spec.min_obstacle_dist - d


def control_rate_inequalities(spec, us, dt, u_prev):
    """dt-scaled acceleration bounds on control differences, stages 0..N-1:
    g_hi = (u_k − u_{k−1}) − hi·dt ≤ 0 ;  g_lo = lo·dt − (u_k − u_{k−1}) ≤ 0,
    with u_{−1} = u_prev and ±inf limits sanitized to ±BIG_DISTANCE first;
    dt is (...,) or per stage (..., N).
    """
    lo, hi = spec.control_rate_box()
    lo = torch.maximum(const(lo, us), const((-BIG_DISTANCE,), us))
    hi = torch.minimum(const(hi, us), const((BIG_DISTANCE,), us))
    u_prev = u_prev.expand(us.shape[:-2] + u_prev.shape[-1:])
    u_ext = torch.cat([u_prev[..., None, :], us], dim=-2)
    du = u_ext[..., 1:, :] - u_ext[..., :-1, :]
    dtb = dt[..., None] if dt.dim() == us.dim() - 1 else dt[..., None, None]
    g_hi = du - hi * dtb
    g_lo = lo * dtb - du
    return torch.cat([g_hi, g_lo], dim=-1)  # (..., N, 2*nu)


def control_box_inequalities(spec, us):
    """Input box u ∈ [u_min, u_max] as inequalities (..., N, 2*nu)."""
    lo, hi = spec.control_box()
    return torch.cat([us - const(hi, us), const(lo, us) - us], dim=-1)


def dt_inequalities(spec, dt, dtype):
    """dt ∈ [dt_min, dt_max] when dt is a decision variable; else inactive.
    (..., 2), or on the non-uniform grid every interval's box (..., 2N)
    flattened, [hi, lo] per interval."""
    dt = dt.to(dtype)
    if not spec.variable_dt:
        return torch.full(dt.shape + (2,), -BIG_DISTANCE, dtype=dtype, device=dt.device)
    g = torch.stack([dt - spec.dt_max, spec.dt_min - dt], dim=-1)
    return g.flatten(-2) if spec.nonuniform_dt else g


def terminal_ball_inequality(spec, xs, xf):
    """‖x_N ⊖ xf‖²_S − r² ≤ 0 (parity: TerminalBallSE2); inactive if r ≤ 0."""
    if spec.ball_radius <= 0.0:
        return torch.full(
            xs.shape[:-2] + (1,), -BIG_DISTANCE, dtype=xs.dtype, device=xs.device
        )
    s = const(spec.ball_weights, xs)
    dx = se2_boxminus(xs[..., -1, :], xf)
    return (torch.sum(dx * dx * s, dim=-1) - spec.ball_radius**2)[..., None]


def terminal_equality(spec, xs, xf):
    """Masked fixed-terminal-state equality: xf_fixed[i] → (x_N ⊖ xf)_i = 0."""
    mask = const(spec.xf_fixed, xs, dtype=torch.bool)
    dx = se2_boxminus(xs[..., -1, :], xf)
    return torch.where(mask, dx, 0.0)
