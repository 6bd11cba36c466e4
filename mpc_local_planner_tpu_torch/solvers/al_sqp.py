"""Augmented-Lagrangian Gauss-Newton SQP — the batched solver (port of
``mpc_local_planner_tpu.solvers.al_sqp``, un-fused path).

outer (AL)  : PHR multiplier / penalty updates on every constraint
middle (SQP): per iteration — exact AD stage gradients and Gauss-Newton
              surrogate Hessians of the AL merit (``torch.func`` under
              ``vmap`` over the lane and stage axes), linearized collocation
              defects, the Riccati KKT solve (kernel K1 on CUDA), a
              parallel-candidate line search on the AL merit, Levenberg
              regularization adapted on rejection.

Every tensor carries one leading lane (scenario) axis where the JAX package
``vmap``s ``solve_single``; lanes converge or fail independently, tracked
with masks. Ties of the PHR hinges go through ``torch.maximum``, whose
gradient splits 0.5/0.5 like ``jnp.maximum`` (``clamp`` and ``relu`` do not:
the Hessian of an exactly active hinge would come out ρ instead of ρ/4).
``make_solver`` sends a batched float32 CUDA solve of at most 16 iterations
in the fused kernel's scope (every spec ``OcpSpec`` admits) to the fused
kernel (``ops/fused_al_sqp_cuda.py``), which runs the whole solve in one
launch (``fused_dispatch_ok``); every other solve takes this un-fused path.
On the non-uniform grid (``spec.nonuniform_dt``) each stage owns its dt: δdt_k
is a third control column of the Riccati step, whose KKT solve is the plain
``lqr_solve`` on any device, as the JAX solver runs it on the scan whatever
``settings.kkt`` says (kernel K1 takes the uniform two-column shape only).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import grad, hessian, jacfwd, vmap

from mpc_local_planner_tpu_torch.core.so2 import angle_diff, se2_boxminus, se2_boxplus
from mpc_local_planner_tpu_torch.core.tree import tree_map, where_tree
from mpc_local_planner_tpu_torch.device import const, pin_matmul_precision, resolve_device
from mpc_local_planner_tpu_torch.geometry.obstacles import BIG_DISTANCE, ObstacleSet
from mpc_local_planner_tpu_torch.ocp import constraints as C
from mpc_local_planner_tpu_torch.ocp.collocation import stage_defect
from mpc_local_planner_tpu_torch.ocp.costs import trapezoidal, via_stage_assignment
from mpc_local_planner_tpu_torch.ocp.grid import Primal, _take_stages, initial_primal
from mpc_local_planner_tpu_torch.ocp.problem import OcpFunctions, make_ocp_functions
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec
from mpc_local_planner_tpu_torch.ops.riccati_cuda import lqr_solve_auto
from mpc_local_planner_tpu_torch.ops.smallmat import inv3
from mpc_local_planner_tpu_torch.solvers.riccati import (
    build_augmented_transition,
    build_augmented_transition_nonuniform,
    lqr_solve,
)
from mpc_local_planner_tpu_torch.solvers.riccati_pscan import lqr_solve_pscan


# --------------------------------------------------------------------------- #
# settings / state containers
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Static solver configuration; same fields and defaults as the JAX one.

    kkt: "auto" (or "pallas") = kernel K1 for CUDA tensors, the plain
    ``lqr_solve`` for CPU tensors; "scan" = the plain ``lqr_solve`` on any
    device; "pscan" (or ``horizon_parallel=True``) = the horizon-parallel
    ``lqr_solve_pscan`` (the same solution in log-depth composition rounds).
    fused: "auto" = the fused kernel for the solves ``fused_dispatch_ok``
    admits; "off" = always the un-fused path. early_exit: a lane stops at
    the end of the first AL phase whose iterate is feasible (converge or
    exhaust ``n_al``); the others run on.
    """

    n_al: int = 5
    n_sqp: int = 8
    rho0: float = 10.0
    rho_growth: float = 5.0
    rho_max: float = 1.0e6
    reg0: float = 1.0e-6
    reg_shrink: float = 0.5
    reg_grow: float = 100.0
    reg_min: float = 1.0e-9
    reg_max: float = 1.0e8
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03)
    dt_trust_frac: float = 0.3
    dt_prox: float = 1.0
    viol_decrease_req: float = 0.25
    tol_eq: float = 1.0e-4
    tol_ineq: float = 1.0e-4
    horizon_parallel: bool = False
    kkt: str = "auto"
    fused: str = "auto"
    early_exit: bool = False

    @staticmethod
    def for_spec(spec, **overrides) -> "SolverSettings":
        """Problem-family presets (cold start)."""
        if spec.min_time:
            base = dict(n_al=16, n_sqp=15, rho0=100.0, rho_growth=10.0)
        else:
            base = dict(n_al=8, n_sqp=10)
        base.update(overrides)
        return SolverSettings(**base)


class Decisions:
    """The comparisons of a solve that rounding can decide: near a solution
    the line search's pick among the candidates' merits and the
    penalty-growth test on the violation, and anywhere whether a candidate's
    dt that lands within rounding of its bound is clipped onto it (which
    decides whether its dt-box row is then exactly at zero). ``solve`` takes
    them exactly; ``solvers/agreement.py`` passes a rule that takes
    near-ties the other way, to measure how far such a tie moves the
    answer."""

    def pick(self, merits):
        """The winning candidate per lane of the (C, B) merits: the first
        least one."""
        return torch.argmin(merits, dim=0)

    def stalled(self, viol, bound):
        """The growth test viol > viol_decrease_req · viol_prev, per lane."""
        return viol > bound

    def clip_dt(self, dt, lo, hi):
        """The line search's candidate dt clipped to [lo, hi]."""
        return torch.clamp(dt, lo, hi)


def _check_settings(settings: SolverSettings):
    if settings.kkt not in ("auto", "pallas", "scan", "pscan"):
        raise ValueError(f"unknown kkt backend {settings.kkt!r}")
    if settings.fused not in ("auto", "off"):
        raise ValueError(f"unknown fused mode {settings.fused!r}")


@dataclasses.dataclass(frozen=True)
class DualState:
    """AL multipliers + penalty, with the lane axis in front."""

    lam_def: torch.Tensor   # (..., N, 3) collocation defect multipliers
    lam_term: torch.Tensor  # (..., 3) xf_fixed equality multipliers
    mu_obs: torch.Tensor    # (..., N, M) obstacle multipliers (stages 1..N)
    mu_rate: torch.Tensor   # (..., N, 2*nu)
    mu_box: torch.Tensor    # (..., N, 2*nu)
    mu_dt: torch.Tensor     # (..., 2); (..., 2N) [hi, lo] per interval, non-uniform grid
    mu_ball: torch.Tensor   # (..., 1)
    rho: torch.Tensor       # (...,) penalty parameter


@dataclasses.dataclass(frozen=True)
class SolveResult:
    primal: Primal
    duals: DualState
    cost: torch.Tensor       # objective (no AL terms)
    eq_norm: torch.Tensor    # max |equality residual|
    ineq_viol: torch.Tensor  # max(0, max g)
    converged: torch.Tensor  # bool per scenario


def shift_duals(duals: DualState, settings: SolverSettings, steps=1) -> DualState:
    """Shift stage-indexed multipliers with the warm-started grid (on the
    non-uniform grid the per-interval dt-box pairs too); ρ restarts at
    rho0. ``steps``: a Python int, or an integer tensor with the duals'
    batch shape (a shift per lane), clipped to [1, N//2] like the primal's
    per-lane warm starts, so a lane whose step is 0 shifts its multipliers
    with its constraints."""
    if isinstance(steps, int):
        def roll(a):
            n = a.shape[-2]
            src = torch.clamp(torch.arange(n, device=a.device) + steps, max=n - 1)
            return a[..., src, :]
    else:
        n_stages = duals.lam_def.shape[-2]
        lane_steps = torch.as_tensor(steps, device=duals.lam_def.device).long()
        lane_steps = torch.clamp(
            torch.broadcast_to(lane_steps, duals.rho.shape), 1, max(1, n_stages // 2)
        )

        def roll(a):
            n = a.shape[-2]
            src = torch.clamp(torch.arange(n, device=a.device) + lane_steps[..., None],
                              max=n - 1)
            return _take_stages(a, src)

    mu_dt = duals.mu_dt
    if mu_dt.shape[-1] > 2:
        mu_dt = roll(mu_dt.unflatten(-1, (-1, 2))).flatten(-2)
    return DualState(
        lam_def=roll(duals.lam_def),
        lam_term=duals.lam_term,
        mu_obs=roll(duals.mu_obs),
        mu_rate=roll(duals.mu_rate),
        mu_box=roll(duals.mu_box),
        mu_dt=mu_dt,
        mu_ball=duals.mu_ball,
        rho=torch.full_like(duals.rho, settings.rho0),
    )


def init_duals(
    spec: OcpSpec, settings: SolverSettings, dtype=torch.float32, device="cpu",
    batch: Tuple[int, ...] = (),
) -> DualState:
    N, nu, M = spec.N, spec.nu, spec.obstacle_cap
    batch = tuple(batch)

    def z(*s):
        return torch.zeros(batch + s, dtype=dtype, device=device)

    return DualState(
        lam_def=z(N, 3), lam_term=z(3), mu_obs=z(N, M), mu_rate=z(N, 2 * nu),
        mu_box=z(N, 2 * nu), mu_dt=z(2 * N) if spec.nonuniform_dt else z(2), mu_ball=z(1),
        rho=torch.full(batch, settings.rho0, dtype=dtype, device=device),
    )


# --------------------------------------------------------------------------- #
# AL penalty pieces (sums over the last axis; the rest are batch axes)
# --------------------------------------------------------------------------- #
def _hinge(x):
    """max(0, x) with jnp.maximum's 0.5/0.5 subgradient at the tie."""
    return torch.maximum(torch.zeros_like(x), x)


def _psi(g, mu, rho):
    """PHR inequality penalty Σ (max(0, μ + ρg)² − μ²) / (2ρ) for g ≤ 0."""
    a = _hinge(mu + rho[..., None] * g)
    return torch.sum(a * a - mu * mu, dim=-1) / (2.0 * rho)


def _phi(c, lam, rho):
    """Equality penalty λᵀc + (ρ/2)‖c‖²."""
    return torch.sum(lam * c, dim=-1) + 0.5 * rho * torch.sum(c * c, dim=-1)


# --------------------------------------------------------------------------- #
# stage merit functions (one stage; vmapped over lanes × stages)
# --------------------------------------------------------------------------- #
class StageData(NamedTuple):
    mu_obs: torch.Tensor   # (M,)
    obs_on: torch.Tensor   # () 1.0 if the obstacle term is active at this stage
    mu_rate: torch.Tensor  # (2*nu,)
    mu_box: torch.Tensor   # (2*nu,)
    obs: ObstacleSet       # this stage's obstacle set
    xref: Optional[torch.Tensor] = None  # (3,) the quadratic form's reference
    iw: Optional[torch.Tensor] = None    # (1,) integration weight of the stage
    via_pts: Optional[torch.Tensor] = None  # (Mv, 3) via poses
    via_w: Optional[torch.Tensor] = None    # (Mv,) each via point's weight on this stage
    mu_dt: Optional[torch.Tensor] = None    # (2,) the interval's dt-box multipliers (non-uniform)


class TermData(NamedTuple):
    xref: torch.Tensor
    mu_obs: torch.Tensor
    lam_term: torch.Tensor
    mu_ball: torch.Tensor
    mu_dt: torch.Tensor
    obs: ObstacleSet
    via_pts: object = ()  # (Mv, 3) via poses; () without via points
    via_w: object = ()    # (Mv,) each via point's weight on x_N; () without


def has_via(spec) -> bool:
    """The objective carries the via-point attraction."""
    return spec.via_cap > 0 and spec.objective == "minimum_time_via_points"


def _via_term(spec, x, via_pts, via_w):
    """The via attraction of one state x (3,): Σ_j w_j (pw ‖x_xy − v_j‖² +
    ow · wrap(θ − θ_j)²), the orientation term where ow > 0. ``via_w`` is
    the one-hot stage assignment times the mask (``_via_weights``), stage
    data that is not differentiated. Returns a (1,) tensor (see
    ``_make_stage_fns`` on 0-d tensors under forward mode)."""
    dp = x[None, 0:2] - via_pts[:, 0:2]
    t = spec.via_position_weight * torch.sum(dp * dp, dim=-1)
    if spec.via_orientation_weight > 0.0:
        dth = angle_diff(x[None, 2], via_pts[:, 2])
        t = t + spec.via_orientation_weight * dth * dth
    return torch.sum(via_w * t, dim=-1, keepdim=True)


def _obstacle_g(spec, x, obs):
    return spec.min_obstacle_dist - spec.footprint.distances(x, obs)


def _make_stage_fns(spec: OcpSpec):
    """Stage-local functions over w = [x (3), u_prev (nu), u (nu), dt (1)];
    on the non-uniform grid w = [x (3), u_prev (nu), dt_prev (1), u (nu),
    dt (1)] (dt_{-1} = 0): dt_k is the stage's own decision, dt_{k-1} rides
    along for the trapezoidal weight ½(dt_{k-1} + dt_k)·lx_k, and the
    interval's dt box joins the stage inequalities.

    Returns (objective, constraints_vec, merit, hess_surrogate, gn_weights),
    as in the JAX package: the merit is the exact AL merit; the surrogate's
    Hessian is exact for every smooth-PSD term and Gauss-Newton for the
    obstacle block (H = ∇²objective + Jgᵀ diag(a) Jg).

    Under ``torch.func`` forward mode, a 0-d tensor combined with a Python
    float gets a float64 tangent (torch 2.13), so these functions keep such
    arithmetic on 1-element or wider tensors (0.5·Σx is written Σ(0.5·x),
    which is exact in binary floating point).
    """
    nu = spec.nu
    M = spec.obstacle_cap
    nonu = spec.nonuniform_dt
    iu = 4 + nu if nonu else 3 + nu  # the first u column
    lo_u, hi_u = spec.control_box()
    lo_r, hi_r = spec.control_rate_box()

    def split(w):
        return w[0:3], w[3 : 3 + nu], w[iu : iu + nu], w[iu + nu]

    def objective(w, data: StageData):
        if spec.objective != "quadratic_form":
            c = split(w)[3]  # minimum time: Σ_k dt = N·dt
            if has_via(spec):
                c = torch.sum(_via_term(spec, w[0:3], data.via_pts, data.via_w) + c)
            return c
        x, u, dt = w[0:3], w[iu : iu + nu], w[iu + nu :]
        dx = se2_boxminus(x, data.xref)
        x_term = torch.sum(dx * dx * const(spec.q_diag, w), dim=-1, keepdim=True)
        u_term = torch.sum(u * u * const(spec.r_diag, w), dim=-1, keepdim=True)
        if spec.integral_form and nonu and spec.cost_integration == "trapezoidal":
            # ½(dt_{k-1} + dt_k)·lx_k + lu_k·dt_k; the ½·dt_{N-1}·lx_N tail
            # lives in the terminal stage
            dtp = w[3 + nu : 4 + nu]
            c = const((0.5,), w) * (dtp + dt) * x_term + u_term * dt
        elif spec.integral_form:
            # data.iw: the integration rule's stage weight (trapezoidal: ½ at
            # k = 0; the ½·dt·lx_N tail lives in the terminal stage)
            c = (data.iw * x_term + u_term) * dt
        else:
            c = x_term + u_term
        if spec.hybrid_time_weight > 0.0:
            c = c + const((spec.hybrid_time_weight,), w) * dt
        return torch.sum(c)

    def constraints_vec(w, data: StageData):
        x, up, u, dt = split(w)
        parts = []
        if M > 0:
            parts.append(_obstacle_g(spec, x, data.obs))
        du = u - up
        hi_s = torch.minimum(const(hi_r, w), const((BIG_DISTANCE,), w))
        lo_s = torch.maximum(const(lo_r, w), const((-BIG_DISTANCE,), w))
        parts.append(torch.cat([du - hi_s * dt, lo_s * dt - du]))
        parts.append(torch.cat([u - const(hi_u, w), const(lo_u, w) - u]))
        if nonu:  # the interval's dt box
            dtv = w[iu + nu :]
            parts.append(torch.cat([dtv - spec.dt_max, spec.dt_min - dtv]))
        return torch.cat(parts)

    def stage_mu(data: StageData):
        mus = [data.mu_obs] if M > 0 else []
        return torch.cat(mus + [data.mu_rate, data.mu_box] + ([data.mu_dt] if nonu else []))

    def active_mask(data: StageData, g):
        """Active-set weight pattern; zeroes the obstacle block at k = 0."""
        rest = torch.ones((4 * nu + 2 * nonu,), dtype=g.dtype, device=g.device)
        return torch.cat([data.obs_on.expand(M), rest]) if M > 0 else rest

    def merit(w, data: StageData, rho):
        g = constraints_vec(w, data)
        mu = stage_mu(data)
        on = active_mask(data, g)
        a = _hinge(mu + rho * g) * on
        return objective(w, data) + torch.sum(a * a - (mu * on) ** 2) / (2.0 * rho)

    def hess_surrogate(w, data: StageData, rho, g0, aw):
        g = constraints_vec(w, data)
        g_rest, mu_rest = g[M:], stage_mu(data)[M:]
        a = _hinge(mu_rest + rho * g_rest)
        c = objective(w, data) + torch.sum(a * a - mu_rest * mu_rest) / (2.0 * rho)
        return c + torch.sum(0.5 * aw * (g[:M] - g0[:M]) ** 2)

    def gn_weights(data: StageData, g0, rho):
        mu = stage_mu(data)
        on = active_mask(data, g0)
        return (rho * on * (mu + rho * g0 > 0.0).to(g0.dtype))[:M]

    return objective, constraints_vec, merit, hess_surrogate, gn_weights


def _make_terminal_fns(spec: OcpSpec):
    """Terminal counterparts over w = [x (3), u_prev (nu), dt (1)] (dt_{N-1}
    on the non-uniform grid, whose dt rows live in the stages); the
    terminal objective is Qf, the ½·dt·lx(x_N) tail of the trapezoidal
    quadratic form and the via attraction of x_N, and is left out of the
    merit where the spec has none of them."""
    nu = spec.nu
    M = spec.obstacle_cap
    tail = trapezoidal(spec)
    via = has_via(spec)
    has_objective = spec.qf_diag is not None or tail or via

    def objective(w, data: TermData):
        x, dt = w[0:3], w[3 + nu : 4 + nu]
        dx = se2_boxminus(x, data.xref)
        terms = []
        if spec.qf_diag is not None:
            terms.append(torch.sum(dx * dx * const(spec.qf_diag, w), dim=-1, keepdim=True))
        if tail:
            q = const(spec.q_diag, w)
            terms.append(const((0.5,), w) * dt * torch.sum(dx * dx * q, dim=-1, keepdim=True))
        if via:
            terms.append(_via_term(spec, x, data.via_pts, data.via_w))
        return torch.sum(torch.cat(terms))

    def with_objective(c, w, data: TermData):
        return c + objective(w, data) if has_objective else c

    def constraints_vec(w, data: TermData):
        x, dt = w[0:3], w[3 + nu : 4 + nu]  # dt as (1,): see _make_stage_fns
        parts = []
        if M > 0:
            parts.append(_obstacle_g(spec, x, data.obs))
        if spec.ball_radius > 0.0:
            dx = se2_boxminus(x, data.xref)
            s = const(spec.ball_weights, w)
            parts.append(torch.sum(dx * dx * s, dim=-1, keepdim=True) - spec.ball_radius**2)
        else:
            parts.append(torch.full((1,), -1.0, dtype=w.dtype, device=w.device))
        if spec.variable_dt and not spec.nonuniform_dt:
            parts.append(torch.cat([dt - spec.dt_max, spec.dt_min - dt]))
        else:  # fixed dt, or the non-uniform grid's stage boxes: rows inactive
            parts.append(torch.full((2,), -1.0, dtype=w.dtype, device=w.device))
        return torch.cat(parts)

    def eq_vec(w, data: TermData):
        dx = se2_boxminus(w[0:3], data.xref)
        return torch.where(const(spec.xf_fixed, w, dtype=torch.bool), dx, 0.0)

    def term_mu(data: TermData):
        mus = [data.mu_obs] if M > 0 else []
        return torch.cat(mus + [data.mu_ball, data.mu_dt])

    def merit(w, data: TermData, rho):
        c = with_objective(_psi(constraints_vec(w, data), term_mu(data), rho), w, data)
        return c + _phi(eq_vec(w, data), data.lam_term, rho)

    def hess_surrogate(w, data: TermData, rho, g0, aw):
        g = constraints_vec(w, data)
        g_rest, mu_rest = g[M:], term_mu(data)[M:]
        a = _hinge(mu_rest + rho * g_rest)
        c = with_objective(torch.sum(a * a - mu_rest * mu_rest) / (2.0 * rho), w, data)
        c = c + _phi(eq_vec(w, data), data.lam_term, rho)
        return c + torch.sum(0.5 * aw * (g[:M] - g0[:M]) ** 2)

    def gn_weights(data: TermData, g0, rho):
        mu = term_mu(data)
        return (rho * (mu + rho * g0 > 0.0).to(g0.dtype))[:M]

    return constraints_vec, eq_vec, merit, hess_surrogate, gn_weights


# --------------------------------------------------------------------------- #
# per-solve data assembly
# --------------------------------------------------------------------------- #
def _stage_obstacles(spec, scenario, dt, n):
    """Per-stage obstacle sets (..., n, M, ...): stage i holds the field at
    t = i·dt (on the non-uniform grid t_i = Σ_{j<i} dt_j) with dynamic
    obstacles (constant-velocity prediction, dt detached: stage data, not
    decision-dependent), at t = 0 without."""
    lead = dt.shape[:-1] if spec.nonuniform_dt else dt.shape
    if not spec.enable_dynamic_obstacles:
        t = torch.zeros(lead + (n,), dtype=dt.dtype, device=dt.device)
    elif spec.nonuniform_dt:
        cum = torch.cumsum(dt.detach(), dim=-1)
        t = torch.cat([torch.zeros_like(cum[..., :1]), cum], dim=-1)[..., :n]
    else:
        i = torch.arange(n, dtype=dt.dtype, device=dt.device)
        t = i * dt.detach()[..., None]
    return scenario.obstacles.predict_stages(t)


def _via_weights(spec, xs, scenario):
    """One-hot stage assignment of the via points times their mask: (B,
    N+1, Mv). Piecewise constant in xs: recomputed at each SQP iteration
    from the current states, not differentiated (parity:
    MinTimeViaPointsCost's discrete stage association)."""
    k = via_stage_assignment(spec, xs, scenario.via_points, scenario.via_mask)  # (B, Mv)
    stages = torch.arange(spec.N + 1, device=xs.device)
    onehot = (k[..., None, :] == stages[:, None]).to(xs.dtype)  # (B, N+1, Mv)
    return onehot * scenario.via_mask[..., None, :].to(xs.dtype)


def _flat2(a):
    """Merge the two leading (lane, stage) axes."""
    return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])


# --------------------------------------------------------------------------- #
# AL merit of a full trajectory (line-search objective)
# --------------------------------------------------------------------------- #
def _al_merit(funcs: OcpFunctions, primal: Primal, scenario, duals: DualState):
    """AL merit per trajectory; ``primal`` may carry candidate axes in front
    of the lane axis."""
    s = funcs.spec
    rho = duals.rho
    m = funcs.cost(primal, scenario)
    m = m + _phi(funcs.defects(primal).flatten(-2), duals.lam_def.flatten(-2), rho)
    te = C.terminal_equality(s, primal.xs, scenario.xf)
    m = m + _phi(te, duals.lam_term, rho)
    g_obs = C.obstacle_inequalities(s, primal.xs, primal.dt, scenario)
    m = m + _psi(g_obs.flatten(-2), duals.mu_obs.flatten(-2), rho)
    g_rate = C.control_rate_inequalities(s, primal.us, primal.dt, scenario.u_prev)
    m = m + _psi(g_rate.flatten(-2), duals.mu_rate.flatten(-2), rho)
    g_box = C.control_box_inequalities(s, primal.us)
    m = m + _psi(g_box.flatten(-2), duals.mu_box.flatten(-2), rho)
    if s.variable_dt:
        g_dt = C.dt_inequalities(s, primal.dt, primal.xs.dtype)
        m = m + _psi(g_dt, duals.mu_dt, rho)
    g_ball = C.terminal_ball_inequality(s, primal.xs, scenario.xf)
    return m + _psi(g_ball, duals.mu_ball, rho)


# --------------------------------------------------------------------------- #
# one SQP iteration: derivatives → Riccati → line search
# --------------------------------------------------------------------------- #
def dt_clip(spec) -> Tuple[float, float]:
    """The line search's dt interval: [max(dt_min, 1e-3), dt_max] for a
    variable dt, [dt_ref, dt_ref] for a fixed one."""
    if spec.variable_dt:
        return max(spec.dt_min, 1.0e-3), spec.dt_max
    return spec.dt_ref, spec.dt_ref


def dt_trust_cap(spec, settings, dt, dtau):
    """The relative trust region on dt, per lane: the step is scaled so that
    no dt moves by more than ``dt_trust_frac`` of its current value. On the
    non-uniform grid the tightest cap over the stages, each stage's scale
    floored at dt_ref: one interval at dt_min would otherwise cap every later
    step at frac·dt_min/|δdt| and stall the solve."""
    dt_scale = torch.clamp(dt, min=spec.dt_ref) if spec.nonuniform_dt else dt
    cap = torch.where(
        torch.abs(dtau) > 0.0,
        torch.clamp(
            settings.dt_trust_frac * dt_scale / torch.clamp(torch.abs(dtau), min=1e-30),
            max=1.0,
        ),
        1.0,
    )
    return cap.amin(dim=-1) if spec.nonuniform_dt else cap


_ZI = (0, 1, 2, 3, 4, 7)  # z = [x, u_prev, dt] columns of w (nu = 2)
_UI = (5, 6)              # u columns of w
# the non-uniform grid: z = [x, u_prev, dt_prev] and v = [u, dt] are
# contiguous in w
_ZI_NONU, _UI_NONU = (0, 1, 2, 3, 4, 5), (6, 7, 8)


def _kkt_system(spec, stage_fns, term_fns, primal, scenario, duals, obs_k,
                dt_prox: float = SolverSettings.dt_prox):
    """The Riccati inputs (Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN) of one
    SQP iteration, lanes in front, all contiguous (on the non-uniform grid
    with the control columns [u, dt] and ``settings.dt_prox`` on the δdt
    diagonal of Huu)."""
    N, nx, nu = spec.N, spec.nx, spec.nu
    nonu = spec.nonuniform_dt
    xs, us, dt = primal.xs, primal.us, primal.dt
    B = dt.shape[0]
    dtype = xs.dtype

    # ---- defect linearization ------------------------------------------ #
    def defect(xk, uk, xk1, dtv):
        return stage_defect(spec.model, spec.collocation, xk, uk, xk1, dtv)

    xk, xk1 = xs[:, :-1], xs[:, 1:]
    dt_b = dt if nonu else dt[:, None].expand(B, N)
    cvals = defect(xk, us, xk1, dt_b)
    jac = vmap(jacfwd(defect, argnums=(0, 1, 2, 3)))(
        _flat2(xk), _flat2(us), _flat2(xk1), _flat2(dt_b)
    )
    A, Bm, E, h = (j.reshape((B, N) + j.shape[1:]) for j in jac)
    Einv = inv3(E)  # closed-form: E ≈ −I + O(dt) is always well conditioned
    F = -Einv @ A
    G = -Einv @ Bm
    mcol = -torch.einsum("...ij,...j->...i", Einv, h)
    if not spec.variable_dt:
        mcol = torch.zeros_like(mcol)
    raff = -torch.einsum("...ij,...j->...i", Einv, cvals)
    transition = build_augmented_transition_nonuniform if nonu else build_augmented_transition
    Fz, Gz, rz = transition(F, G, mcol, raff, nu=nu)

    # ---- stage data ----------------------------------------------------- #
    M = spec.obstacle_cap
    obs_stages = tree_map(lambda a: _flat2(a[:, :N]), obs_k)
    obs_term = tree_map(lambda a: a[:, N], obs_k)
    # obstacle multiplier rows: stage k uses mu_obs[k-1]; k = 0 inactive.
    mu_obs_stage = torch.cat([duals.mu_obs.new_zeros(B, 1, M), duals.mu_obs[:, : N - 1]], dim=1)
    obs_on = torch.ones((B, N), dtype=dtype, device=xs.device)
    obs_on[:, 0] = 0.0
    xref = iw = via_pts = via_w = None  # the objective's stage data
    if has_via(spec):
        via_w = _via_weights(spec, xs, scenario)  # (B, N+1, Mv)
        via_pts = _flat2(scenario.via_points[:, None].expand(B, N, -1, -1))
    if spec.objective == "quadratic_form":
        xref = _flat2(scenario.xf[:, None].expand(B, N, 3))
        if spec.integral_form:
            iw = torch.ones((B * N, 1), dtype=dtype, device=xs.device)
            if trapezoidal(spec):
                iw.view(B, N)[:, 0] = 0.5
    sdata = StageData(
        mu_obs=_flat2(mu_obs_stage),
        obs_on=_flat2(obs_on),
        mu_rate=_flat2(duals.mu_rate),
        mu_box=_flat2(duals.mu_box),
        obs=obs_stages,
        xref=xref,
        iw=iw,
        via_pts=via_pts,
        via_w=None if via_w is None else _flat2(via_w[:, :N]),
        mu_dt=_flat2(duals.mu_dt.reshape(B, N, 2)) if nonu else None,
    )
    u_ext = torch.cat([scenario.u_prev[:, None], us], dim=1)  # (B, N+1, nu)
    if nonu:  # w = [x, u_prev, dt_prev, u, dt] with dt_{-1} = 0
        dtp = torch.cat([dt.new_zeros(B, 1), dt[:, :-1]], dim=1)
        ws = _flat2(torch.cat([xk, u_ext[:, :-1], dtp[..., None], us, dt[..., None]], dim=-1))
    else:
        ws = _flat2(torch.cat([xk, u_ext[:, :-1], us, dt_b[..., None]], dim=-1))
    rho_s = _flat2(duals.rho[:, None].expand(B, N))

    _, stage_cons, stage_merit, stage_hess, stage_gn_w = stage_fns
    sd = StageData(*(None if f is None else 0 for f in sdata))  # absent data: no vmap axis
    gstage = vmap(grad(stage_merit), in_dims=(0, sd, 0))(ws, sdata, rho_s)
    g0 = vmap(stage_cons, in_dims=(0, sd))(ws, sdata)
    aw = vmap(stage_gn_w, in_dims=(sd, 0, 0))(sdata, g0, rho_s)
    Hstage = vmap(hessian(stage_hess), in_dims=(0, sd, 0, 0, 0))(ws, sdata, rho_s, g0, aw)
    nw = ws.shape[-1]
    gstage = gstage.reshape(B, N, nw)
    Hstage = Hstage.reshape(B, N, nw, nw)
    zi = const(_ZI_NONU if nonu else _ZI, Hstage, dtype=torch.long)
    ui = const(_UI_NONU if nonu else _UI, Hstage, dtype=torch.long)
    Hz_rows = Hstage.index_select(-2, zi)
    Hzz = Hz_rows.index_select(-1, zi)
    Hzu = Hz_rows.index_select(-1, ui)
    Huu = Hstage.index_select(-2, ui).index_select(-1, ui)
    if nonu and dt_prox > 0.0:
        # proximal damping of the δdt column
        Huu = Huu + dt_prox * const((0.0,) * nu + (1.0,), Huu).diag()
    hz = gstage.index_select(-1, zi)
    hu = gstage.index_select(-1, ui)

    tdata = TermData(
        xref=scenario.xf,
        mu_obs=duals.mu_obs[:, N - 1],
        lam_term=duals.lam_term,
        mu_ball=duals.mu_ball,
        mu_dt=duals.mu_dt.new_zeros(B, 2) if nonu else duals.mu_dt,
        obs=obs_term,
        via_pts=() if via_w is None else scenario.via_points,
        via_w=() if via_w is None else via_w[:, N],
    )
    term_cons, _, term_merit, term_hess, term_gn_w = term_fns
    wN = torch.cat([xs[:, N], us[:, N - 1], dt[:, N - 1 :] if nonu else dt[:, None]], dim=-1)
    pN = vmap(grad(term_merit))(wN, tdata, duals.rho)
    gT0 = vmap(term_cons)(wN, tdata)
    awT = vmap(term_gn_w)(tdata, gT0, duals.rho)
    PN = vmap(hessian(term_hess))(wN, tdata, duals.rho, gT0, awT)
    return tuple(
        a.contiguous() for a in (Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN)
    )


def _sqp_iteration(spec, funcs, settings, kkt_system, primal, scenario, duals, reg, lqr,
                   decisions):
    xs, us, dt = primal.xs, primal.us, primal.dt
    dtype = xs.dtype
    B = dt.shape[0]
    kkt = kkt_system(primal, duals)
    if spec.nonuniform_dt:
        # δdt_k is control column nu: the plain KKT solve on any device (the
        # JAX solver runs this shape on the scan whatever settings.kkt says)
        step = lqr_solve(*kkt, reg, nx=spec.nx, free_tau=False)
        step = step._replace(dus=step.dus[..., : spec.nu], dtau=step.dus[..., spec.nu])
    else:
        step = lqr(*kkt, reg, nx=spec.nx, free_tau=spec.variable_dt)

    # NaN quarantine: a non-finite KKT solve becomes a zero step — the line
    # search then rejects it and the regularization ramps up, instead of
    # poisoning the iterate (0·NaN = NaN, so even α = 0 is unsafe without it).
    step_ok = (
        torch.isfinite(step.dxs).flatten(1).all(dim=1)
        & torch.isfinite(step.dus).flatten(1).all(dim=1)
        & torch.isfinite(step.dtau).reshape(B, -1).all(dim=1)
    )
    ok3 = step_ok[:, None, None]
    dxs = torch.where(ok3, step.dxs, 0.0)
    dus = torch.where(ok3, step.dus, 0.0)
    dtau = torch.where(step_ok.reshape((B,) + (1,) * (step.dtau.dim() - 1)), step.dtau, 0.0)

    # ---- parallel-candidate line search on the AL merit ------------------ #
    dt_lo, dt_hi = dt_clip(spec)
    alpha_cap = dt_trust_cap(spec, settings, dt, dtau)
    alphas = torch.cat(
        [const(settings.alphas, dt) * alpha_cap[:, None], dt.new_zeros(B, 1)], dim=1
    )  # (B, C)
    a_c = alphas.T  # (C, B): candidates in front of the lane axis
    a_dt = a_c[..., None] if spec.nonuniform_dt else a_c
    cands = Primal(
        xs=se2_boxplus(xs[None], a_c[..., None, None] * dxs[None]),
        us=us[None] + a_c[..., None, None] * dus[None],
        dt=decisions.clip_dt(dt[None] + a_dt * dtau[None], dt_lo, dt_hi),
    )
    merits = _al_merit(funcs, cands, scenario, duals)  # (C, B)
    # non-finite candidate merits lose the line search. The α = 0 candidate
    # keeps the current xs and us (the step is finite by construction above)
    # but its dt is clipped too: on a fixed dt it is dt_ref, even where the
    # warm start resampled the incoming dt (the JAX solver does the same)
    merits = torch.where(torch.isfinite(merits), merits, math.inf)
    merits = torch.cat(
        [merits[:-1], torch.clamp(merits[-1:], max=torch.finfo(dtype).max)], dim=0
    )
    best = decisions.pick(merits)  # (B,)
    lane = torch.arange(B, device=dt.device)
    accepted = alphas[lane, best] > 0.0
    new_primal = Primal(
        xs=cands.xs[best, lane], us=cands.us[best, lane], dt=cands.dt[best, lane]
    )
    # shrink on acceptance, grow on rejection (reset to reg0 each AL phase)
    new_reg = torch.where(
        accepted,
        torch.clamp(reg * settings.reg_shrink, min=settings.reg_min),
        torch.clamp(
            torch.clamp(reg, min=settings.reg0) * settings.reg_grow,
            max=settings.reg_max,
        ),
    )
    return new_primal, new_reg


# --------------------------------------------------------------------------- #
# dual (multiplier) updates
# --------------------------------------------------------------------------- #
def _update_duals(spec, funcs, primal, scenario, duals: DualState, settings, viol_prev,
                  decisions):
    """First-order multiplier update + conditional penalty growth (ρ grows
    when the violation stalls or is not yet well below tolerance)."""
    rho = duals.rho
    d = funcs.defects(primal)
    te = C.terminal_equality(spec, primal.xs, scenario.xf)
    g_obs = C.obstacle_inequalities(spec, primal.xs, primal.dt, scenario)
    g_rate = C.control_rate_inequalities(spec, primal.us, primal.dt, scenario.u_prev)
    g_box = C.control_box_inequalities(spec, primal.us)
    g_dt = C.dt_inequalities(spec, primal.dt, primal.xs.dtype)
    g_ball = C.terminal_ball_inequality(spec, primal.xs, scenario.xf)

    def upd(mu, g):
        return _hinge(mu + rho.reshape(rho.shape + (1,) * (g.dim() - 1)) * g)

    r2 = rho[:, None, None]
    eq_norm = torch.maximum(
        torch.abs(d).flatten(1).amax(dim=1), torch.abs(te).amax(dim=1)
    )
    g_all = torch.cat([g.flatten(1) for g in (g_obs, g_rate, g_box, g_dt, g_ball)], dim=1)
    ineq_max = torch.clamp(g_all.amax(dim=1), min=0.0)
    viol = torch.maximum(eq_norm, ineq_max)
    grow = decisions.stalled(viol, settings.viol_decrease_req * viol_prev) | (
        viol > 0.05 * settings.tol_eq
    )
    mask = const(spec.xf_fixed, te, dtype=torch.bool)
    new = DualState(
        lam_def=duals.lam_def + r2 * d,
        lam_term=torch.where(mask, duals.lam_term + rho[:, None] * te, 0.0),
        mu_obs=upd(duals.mu_obs, g_obs),
        mu_rate=upd(duals.mu_rate, g_rate),
        mu_box=upd(duals.mu_box, g_box),
        mu_dt=upd(duals.mu_dt, g_dt) if spec.variable_dt else duals.mu_dt,
        mu_ball=upd(duals.mu_ball, g_ball),
        rho=torch.where(
            grow, torch.clamp(rho * settings.rho_growth, max=settings.rho_max), rho
        ),
    )
    return new, viol, eq_norm, ineq_max


# --------------------------------------------------------------------------- #
# full solve
# --------------------------------------------------------------------------- #
def default_kkt_system(spec, settings, scenario, init):
    """``kkt_system(primal, duals)`` of the AD derivatives (``_kkt_system``)
    for a solve from ``init``."""
    stage_fns = _make_stage_fns(spec)
    term_fns = _make_terminal_fns(spec)
    # hoisted out of the iteration loops: the derivatives predict dynamic
    # obstacles at the solve's initial dt (the merit and the dual update
    # predict at the trajectory's own dt, in ``constraints``)
    obs_k = _stage_obstacles(spec, scenario, init.dt, spec.N + 1)

    def kkt_system(primal, duals):
        return _kkt_system(spec, stage_fns, term_fns, primal, scenario, duals, obs_k,
                           settings.dt_prox)

    return kkt_system


def kkt_backend(settings):
    """The Riccati KKT solve ``settings.kkt`` and ``horizon_parallel`` select."""
    if settings.horizon_parallel or settings.kkt == "pscan":
        return lqr_solve_pscan
    return lqr_solve if settings.kkt == "scan" else lqr_solve_auto


def solve(
    spec: OcpSpec,
    settings: SolverSettings,
    scenario,
    init: Primal,
    duals: DualState,
    kkt_system=None,
    decisions: Optional[Decisions] = None,
    funcs: Optional[OcpFunctions] = None,
) -> SolveResult:
    """Solve a batch of OCPs (one leading lane axis on every argument) on the
    device the tensors lie on, with the fixed n_al × n_sqp schedule.

    ``kkt_system(primal, duals)`` returns the Riccati inputs of one SQP
    iteration; by default the AD derivatives of ``_kkt_system``. The fused
    kernel's plain version passes its closed forms, and ``funcs`` with the
    kernel's defect values (the merit's and the dual update's; by default
    ``make_ocp_functions(spec)``). ``decisions`` takes the line search's
    pick and the growth test (exact by default).

    With ``settings.early_exit`` a lane freezes (its primal, duals, norms and
    best-feasible snapshot) at the end of the first AL phase that leaves it
    feasible, as JAX's ``while_loop`` under ``vmap`` keeps a lane whose
    condition is false; the phases run while any lane is active.
    """
    _check_settings(settings)
    decisions = decisions or Decisions()
    if init.xs.dim() != 3:
        raise ValueError("solve takes one leading lane axis: xs (B, N+1, 3)")
    funcs = funcs or make_ocp_functions(spec)
    if kkt_system is None:
        kkt_system = default_kkt_system(spec, settings, scenario, init)
    lqr = kkt_backend(settings)
    dtype = init.xs.dtype
    B = init.dt.shape[0]
    reg0 = torch.full((B,), settings.reg0, dtype=dtype, device=init.xs.device)
    inf = torch.full((B,), math.inf, dtype=dtype, device=init.xs.device)

    primal, viol_prev = init, inf
    eq_norm, viol = inf, inf
    b_primal, b_eq, b_in = init, inf, inf
    b_found = torch.zeros((B,), dtype=torch.bool, device=init.xs.device)
    active = torch.ones((B,), dtype=torch.bool, device=init.xs.device)
    for _al in range(settings.n_al):
        if settings.early_exit and not bool(active.any()):
            break
        reg = reg0  # reg restarts each phase: the dual update reshapes the merit
        p = primal
        for _sqp in range(settings.n_sqp):
            p, reg = _sqp_iteration(
                spec, funcs, settings, kkt_system, p, scenario, duals, reg, lqr,
                decisions,
            )
        d, vp, e, v = _update_duals(
            spec, funcs, p, scenario, duals, settings, viol_prev, decisions
        )
        # a lane frozen by early_exit keeps its phase-end state
        primal, duals = where_tree(active, p, primal), where_tree(active, d, duals)
        viol_prev = torch.where(active, vp, viol_prev)
        eq_norm, viol = torch.where(active, e, eq_norm), torch.where(active, v, viol)
        # best-feasible snapshot: a later dual update can push a feasible
        # iterate back out of tolerance
        ok = (eq_norm < settings.tol_eq) & (viol < settings.tol_ineq)
        snap = ok & active
        b_primal = where_tree(snap, primal, b_primal)
        b_eq = torch.where(snap, eq_norm, b_eq)
        b_in = torch.where(snap, viol, b_in)
        b_found = snap | b_found
        if settings.early_exit:
            active = active & ~ok

    final_ok = (eq_norm < settings.tol_eq) & (viol < settings.tol_ineq)
    use_best = b_found & ~final_ok
    primal = where_tree(use_best, b_primal, primal)
    eq_norm = torch.where(use_best, b_eq, eq_norm)
    viol = torch.where(use_best, b_in, viol)
    return SolveResult(
        primal=primal, duals=duals, cost=funcs.cost(primal, scenario),
        eq_norm=eq_norm, ineq_viol=viol, converged=final_ok | b_found,
    )


def _check_device(device, *trees):
    def check(a):
        if a.device != device:
            raise ValueError(f"input on {a.device}, solver built for {device}")
        return a

    for tree in trees:
        tree_map(check, tree)


def fused_dispatch_ok(spec, settings, scenario, dtype, device) -> bool:
    """The whole-solve-kernel admission decision of ``make_solver``: spec and
    obstacle slots in the fused kernel's scope (any grid length, slot count
    and candidate count, as JAX ``fused_dispatch_ok``), float32, a CUDA
    device, a budget of at most 16 iterations, and not ``early_exit`` (the
    kernel runs its schedule to the end). As on the TPU, CPU tensors take
    the un-fused path."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a

    return (
        settings.fused != "off"
        and k2a.fused_supported(spec)
        and k2a.fused_obstacles_supported(scenario)
        and dtype == torch.float32
        and torch.device(device).type == "cuda"
        and settings.n_al * settings.n_sqp <= 16
        and not settings.early_exit
    )


def add_lane(tree):
    """Add the one-lane axis the solvers take (None stays None)."""
    return None if tree is None else tree_map(lambda a: a[None], tree)


def drop_lane(tree):
    return None if tree is None else tree_map(lambda a: a[0], tree)


def make_solver(spec: OcpSpec, settings: Optional[SolverSettings] = None, device=None,
                batched: bool = True):
    """Build solve(scenario, init, duals) → SolveResult.

    With ``batched=True`` every argument carries one leading lane axis.
    Solves that ``fused_dispatch_ok`` admits launch the fused kernel (or
    raise); the rest take the un-fused ``solve``. With ``batched=False`` the
    arguments and the result are one scenario without a lane axis, solved by
    the un-fused ``solve`` on one lane (JAX ``solve_single``: K1 at B=1 on
    the card, never the fused kernel).

    ``device`` defaults to CUDA (raises without a card); pass ``"cpu"`` to run
    on the CPU. Inputs must lie on that device.
    """
    from mpc_local_planner_tpu_torch.ops.fused_al_sqp_cuda import fused_solve_cuda

    settings = settings or SolverSettings()
    _check_settings(settings)
    dev = resolve_device(device)
    pin_matmul_precision()

    if not batched:
        def solve_single(scenario, init, duals):
            _check_device(dev, scenario, init, duals)
            return drop_lane(solve(spec, settings, add_lane(scenario), add_lane(init),
                                   add_lane(duals)))

        return solve_single

    def solve_batch(scenario, init, duals):
        _check_device(dev, scenario, init, duals)
        if fused_dispatch_ok(spec, settings, scenario, init.xs.dtype, dev):
            return fused_solve_cuda(spec, settings, scenario, init, duals)
        return solve(spec, settings, scenario, init, duals)

    return solve_batch


def default_init(spec: OcpSpec, settings: SolverSettings, scenario, dtype=torch.float32):
    """(initial primal, fresh duals) for a scenario batch."""
    init = initial_primal(spec, scenario)
    duals = init_duals(
        spec, settings, dtype=dtype, device=scenario.x0.device,
        batch=scenario.x0.shape[:-1],
    )
    return init, duals
