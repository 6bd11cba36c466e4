"""Levenberg–Marquardt soft-penalty least-squares solver, ``solver.type:
lsq_lm`` (port of ``mpc_local_planner_tpu.solvers.lsq_lm``).

The constraints become weighted quadratic penalties, the objective is cast
to least-squares form, and damped Gauss–Newton steps on the merit ½‖r‖² run
inside an outer loop that grows the penalty weights. Every accepted step
lowers the merit, so it never takes an infeasible KKT step.

The decision vector of a lane is small (n = N·(nx+nu) + n_dt), so the
normal equations are dense: JᵀJ per lane, a batched Cholesky solve, and
accept or reject as a per-lane select; the damping adapts per lane.

Least-squares forms (½‖r‖² equals ``total_cost``):
  quadratic_form      → √(2q)·(x ⊖ xref), √(2r)·u (dt-scaled when
                        integral_form; the trapezoidal weights), √(2w·Σdt)
                        for a hybrid time weight w > 0
  minimum_time        → √(2·N·dt), or √(2·dt_k) per interval
  min_time_via_points → + √(2w_via)·(p_k − p_via) per active via slot (and
                        the orientation term)
  terminal            → √(2qf)·(x_N ⊖ xf)
  equalities          → √w_eq·c(z)        (defects and terminal equality)
  inequalities        → √w_ineq·max(0, g(z))
"""

from __future__ import annotations

import math

import torch
from torch.func import jacfwd, vmap

from mpc_local_planner_tpu_torch.core.so2 import angle_diff, se2_boxminus
from mpc_local_planner_tpu_torch.device import const
from mpc_local_planner_tpu_torch.ocp.costs import via_stage_assignment
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.problem import make_ocp_functions
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec, Scenario
from mpc_local_planner_tpu_torch.solvers.al_sqp import SolveResult, SolverSettings


def _objective_residuals(spec: OcpSpec, primal: Primal, scenario) -> torch.Tensor:
    """The objective's least-squares residuals of one trajectory (leading
    batch dims allowed): ½‖r‖² equals ``total_cost``."""
    xs, us, dt = primal.xs, primal.us, primal.dt
    per_stage = spec.nonuniform_dt
    # (..., N) per stage, (..., 1) uniform: no 0-d tensor meets a Python
    # float under forward mode (its tangent would come out float64);
    # sanitize keeps dt ≥ 1e-4, so no tie at the bound
    dt_pos = torch.clamp(dt if per_stage else dt[..., None], min=1e-6)
    total_time = torch.sum(dt_pos, dim=-1, keepdim=True) if per_stage else spec.N * dt_pos
    parts = []
    if spec.objective == "quadratic_form":
        q = torch.sqrt(2.0 * const(spec.q_diag, xs))
        r = torch.sqrt(2.0 * const(spec.r_diag, xs))
        dx = se2_boxminus(xs[..., :-1, :], scenario.xf[..., None, :])
        rx = dx * q
        ru = us * r
        tail = []
        if spec.integral_form:
            s = torch.sqrt(dt_pos)[..., None]
            ru = ru * s
            if spec.cost_integration == "trapezoidal":
                if per_stage:
                    # Σ_k dt_k·½(lx_k + lx_{k+1}) regrouped per state j:
                    # w_j = ½(dt_{j−1} + dt_j), dt_{−1} = dt_N = 0
                    zero = torch.zeros_like(dt_pos[..., :1])
                    w = 0.5 * (torch.cat([zero, dt_pos], dim=-1) + torch.cat([dt_pos, zero], dim=-1))
                    dx_all = se2_boxminus(xs, scenario.xf[..., None, :])
                    rx = dx_all * q * torch.sqrt(w)[..., None]
                else:
                    w = torch.ones(rx.shape[-2], dtype=xs.dtype, device=xs.device)
                    w = torch.where(torch.arange(rx.shape[-2], device=xs.device) == 0,
                                    math.sqrt(0.5), w)
                    rx = rx * w[:, None] * s
                    dxN = se2_boxminus(xs[..., -1, :], scenario.xf)
                    tail.append(dxN * q * math.sqrt(0.5) * torch.sqrt(dt_pos))
            else:
                rx = rx * s
        parts = [rx.flatten(-2), ru.flatten(-2)] + tail
        if spec.hybrid_time_weight > 0.0:
            parts.append(torch.sqrt(2.0 * spec.hybrid_time_weight * total_time))
    else:  # minimum_time, minimum_time_via_points
        parts.append(torch.sqrt(2.0 * dt_pos) if per_stage else torch.sqrt(2.0 * spec.N * dt_pos))
        if spec.objective == "minimum_time_via_points" and spec.via_cap > 0:
            vp, vm = scenario.via_points, scenario.via_mask
            k = via_stage_assignment(spec, xs, vp, vm)
            pk = torch.take_along_dim(xs[..., :2], k[..., None].expand(k.shape + (2,)), dim=-2)
            w = math.sqrt(2.0 * spec.via_position_weight)
            rv = (pk - vp[..., :2]) * w * vm[..., None].to(xs.dtype)
            parts.append(rv.flatten(-2))
            if spec.via_orientation_weight > 0.0:
                thk = torch.take_along_dim(xs[..., 2], k, dim=-1)
                dth = angle_diff(thk, vp[..., 2])
                parts.append(dth * math.sqrt(2.0 * spec.via_orientation_weight) * vm.to(xs.dtype))
    if spec.qf_diag is not None:
        qf = torch.sqrt(2.0 * const(spec.qf_diag, xs))
        parts.append(se2_boxminus(xs[..., -1, :], scenario.xf) * qf)
    return torch.cat(parts, dim=-1)


def solve_single_lm(spec: OcpSpec, settings: SolverSettings, scenario, init: Primal,
                    duals) -> SolveResult:
    """A batch of lanes (one leading lane axis), on the device the tensors lie
    on; the JAX function's signature and its ``SolverSettings`` mapping:
    n_al → outer weight-adaptation steps, n_sqp → LM iterations per step,
    rho0 → the initial penalty weight (at least 1), rho_growth → its growth
    factor, rho_max → its cap. ``duals`` pass through untouched (this solver
    has no multipliers)."""
    fns = make_ocp_functions(spec)
    dtype, dev = init.xs.dtype, init.xs.device
    z0 = fns.flatten(init)
    B, n = z0.shape
    nX = spec.N * spec.nx
    ar = torch.arange(n, device=dev)
    theta_ix = (ar % spec.nx == spec.nx - 1) & (ar < nX)
    n_dt = fns.n_dt
    dt_lo, dt_hi = max(spec.dt_min, 1e-4), spec.dt_max

    def sanitize(z):
        z = torch.where(theta_ix, torch.atan2(torch.sin(z), torch.cos(z)), z)
        if n_dt:
            z = torch.cat([z[..., :-n_dt], torch.clamp(z[..., -n_dt:], dt_lo, dt_hi)], dim=-1)
        return z

    fields = (scenario.x0, scenario.xf, scenario.obstacles, scenario.via_points,
              scenario.via_mask, scenario.u_prev)

    def residual_one(z, w_eq, w_ineq, *scen_fields):
        scen = Scenario(*scen_fields)
        primal = fns.unflatten(z, scen.x0)
        r_obj = _objective_residuals(spec, primal, scen)
        r_eq = torch.sqrt(w_eq) * fns.eq(primal, scen)
        g = fns.ineq(primal, scen)
        r_in = torch.sqrt(w_ineq) * torch.maximum(torch.zeros_like(g), g)
        return torch.cat([r_obj, r_eq, r_in], dim=-1)

    in_dims = (0, None, None) + (0,) * len(fields)
    residual = vmap(residual_one, in_dims=in_dims)
    jacobian = vmap(jacfwd(residual_one), in_dims=in_dims)
    eye = torch.eye(n, dtype=dtype, device=dev)

    def merit(r):
        return 0.5 * torch.sum(r * r, dim=-1)

    z = sanitize(z0)
    w = torch.tensor(max(settings.rho0, 1.0), dtype=dtype, device=dev)
    w_eq = w_ineq = w
    for _outer in range(settings.n_al):
        # new weights: (r, J) rebuilt before the inner loop reuses them
        r = residual(z, w_eq, w_ineq, *fields)
        J = jacobian(z, w_eq, w_ineq, *fields)
        S = merit(r)
        lam = torch.full((B,), 1e-3, dtype=dtype, device=dev)
        for _it in range(settings.n_sqp):
            A = J.mT @ J
            g = (J.mT @ r[..., None])[..., 0]
            # Marquardt scaling: damping proportional to the curvature diagonal
            D = torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1)) + 1e-8 * eye
            L, info = torch.linalg.cholesky_ex(A + lam[:, None, None] * D + 1e-10 * eye)
            p = torch.cholesky_solve(-g[..., None], L)[..., 0]
            p = torch.where((info == 0)[:, None], p, math.nan)  # not positive definite: reject
            z_new = sanitize(z + p)
            r_new = residual(z_new, w_eq, w_ineq, *fields)
            S_new = merit(r_new)
            ok = (S_new < S) & torch.isfinite(S_new)
            # (r, J) follow z: rebuilt where the step is accepted
            J_new = jacobian(z_new, w_eq, w_ineq, *fields)
            z = torch.where(ok[:, None], z_new, z)
            S = torch.where(ok, S_new, S)
            r = torch.where(ok[:, None], r_new, r)
            J = torch.where(ok[:, None, None], J_new, J)
            lam = torch.clamp(torch.where(ok, lam / 3.0, lam * 4.0), 1e-10, 1e10)
        w_eq = torch.clamp(w_eq * settings.rho_growth, max=settings.rho_max)
        w_ineq = torch.clamp(w_ineq * settings.rho_growth, max=settings.rho_max)

    primal = fns.unflatten(z, scenario.x0)
    eq_norm = torch.abs(fns.eq(primal, scenario)).amax(dim=-1)
    ineq_viol = torch.clamp(fns.ineq(primal, scenario).amax(dim=-1), min=0.0)
    return SolveResult(
        primal=primal, duals=duals, cost=fns.cost(primal, scenario), eq_norm=eq_norm,
        ineq_viol=ineq_viol,
        converged=(eq_norm < settings.tol_eq) & (ineq_viol < settings.tol_ineq),
    )
