"""Kernel K2a: one whole warm AL-SQP solve per scenario as a hand-written
CUDA kernel, with its plain PyTorch version.

Replaces the flagship specialization of the TPU kernel
``mpc_local_planner_tpu/ops/fused_al_sqp_pallas.py :: _fused_kernel``
(launched by ``fused_solve``): ``SimpleCarModel``, forward differences, a
point or disc footprint, static point and circle obstacle slots, minimum
time on a uniform shared variable dt, no terminal ball. The source is
``csrc/fused_al_sqp.cu``: one thread per scenario runs the n_al × n_sqp
schedule to its end — closed-form derivatives streamed into the Riccati
sweep, the rollout, the NaN quarantine, the candidate line search, the dual
updates, the best-feasible snapshot and the final selection — for float and
double, in the port's (B, N, ...) layout.

What bounds it on an H100 is arithmetic: the solve needs about 0.79 MFLOP
per scenario at the warm 3×4 budget (``k2a_flops``, the Riccati step on its
structure) against 6 KB of input and output, so at B = 4096 about 48 µs at
the float32 peak against 7 µs for the bytes. One thread per scenario is the
simplest design that is right; it runs the step as dense 6×6 products (1.7
times the operations over the whole solve), and with one warp per block and
per SM nothing hides the latency of each thread's dependent chain, so it
runs far from that bound.

``fused_solve_plain`` is the kernel's math in batched PyTorch: its
closed-form stage and terminal derivatives (``fused_kkt_system``) drive the
port's own ``solvers.al_sqp.solve`` with the plain ``lqr_solve``, the same
line search, dual update and selection. It runs on any device; the tests and
``chip_smoke.py`` hold the kernel against it.

Dispatch (``solvers.al_sqp.make_solver``): a batched float32 CUDA solve that
``fused_dispatch_ok`` admits launches the kernel or raises; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from mpc_local_planner_tpu_torch.core.so2 import _wrap_theta, se2_boxminus
from mpc_local_planner_tpu_torch.geometry.distances import _EPS
from mpc_local_planner_tpu_torch.geometry.footprints import CircularFootprint, PointFootprint
from mpc_local_planner_tpu_torch.geometry.obstacles import BIG_DISTANCE
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ops import nvcc_build
from mpc_local_planner_tpu_torch.solvers.al_sqp import DualState, SolveResult, _hinge, solve
from mpc_local_planner_tpu_torch.solvers.riccati import build_augmented_transition
from mpc_local_planner_tpu_torch.systems.models import SimpleCarModel

SOURCE = nvcc_build.CSRC / "fused_al_sqp.cu"
# compile-time maxima of the kernel (csrc/fused_al_sqp.cu)
MAX_N, MAX_M, MAX_ALPHAS = 64, 16, 16

_lib = None


# --------------------------------------------------------------------------- #
# scope
# --------------------------------------------------------------------------- #
def _spec_scope_error(spec):
    """Why K2a cannot run ``spec`` (None when it can)."""
    if type(spec.model) is not SimpleCarModel:
        return f"model {type(spec.model).__name__}"
    if type(spec.footprint) not in (PointFootprint, CircularFootprint):
        return f"footprint {type(spec.footprint).__name__}"
    if spec.collocation != "forward_differences":
        return f"collocation {spec.collocation!r}"
    if spec.objective != "minimum_time" or spec.qf_diag is not None or spec.via_cap:
        return f"objective {spec.objective!r} with its extras"
    if not spec.variable_dt or spec.nonuniform_dt:
        return "a grid other than a uniform variable dt"
    if spec.ball_radius > 0.0:
        return "the terminal ball (ROADMAP K2d)"
    if spec.enable_dynamic_obstacles:
        return "dynamic obstacles"
    if spec.N > MAX_N or spec.obstacle_cap > MAX_M:
        return f"N={spec.N}, M={spec.obstacle_cap} (at most {MAX_N} and {MAX_M})"
    return None


def fused_supported(spec) -> bool:
    """True when K2a computes this spec's exact semantics."""
    return _spec_scope_error(spec) is None


def fused_obstacles_supported(scenario) -> bool:
    """K2a reads point and circle slots only."""
    o = scenario.obstacles
    return o.lines.shape[-3] == 0 and o.polygons.shape[-3] == 0


# --------------------------------------------------------------------------- #
# closed-form pieces (batched over any leading dims)
# --------------------------------------------------------------------------- #
def dyn(spec, x, u):
    """Simple car f(x, u) (..., 3), the θ column of Jx (..., 2) and Ju
    (..., 3, 2)."""
    wb = spec.model.wheelbase
    c, s, t, v = torch.cos(x[..., 2]), torch.sin(x[..., 2]), torch.tan(u[..., 1]), u[..., 0]
    zero = torch.zeros_like(v)
    f = torch.stack([v * c, v * s, v * t / wb], dim=-1)
    jx = torch.stack([-v * s, v * c], dim=-1)
    ju = torch.stack(
        [
            torch.stack([c, zero], dim=-1),
            torch.stack([s, zero], dim=-1),
            torch.stack([t / wb, v * (1.0 + t * t) / wb], dim=-1),
        ],
        dim=-2,
    )
    return f, jx, ju


def defect_linearization(spec, xk, uk, xk1, dt):
    """Forward-difference defect c = wrap(x_k + dt f − x_{k+1}) and its
    transition form dx_{k+1} = F dx_k + G du_k + m ddt + r: F = I + dt Jx,
    G = dt Ju, m = f, r = c (E = −I exactly). dt has the leading shape."""
    f, jx, ju = dyn(spec, xk, uk)
    d = dt[..., None]
    c = _wrap_theta(xk + d * f - xk1)
    F = torch.eye(3, dtype=xk.dtype, device=xk.device).expand(dt.shape + (3, 3)).clone()
    F[..., 0:2, 2] = d * jx
    G = d[..., None] * ju
    return c, F, G, f


def circle_slots(obstacles):
    """Point and circle slots as one family: centers (B, M, 2), radii (B, M)
    (points have radius 0) and masks (B, M), points first as in
    ``footprints.distances``."""
    o = obstacles
    centers = torch.cat([o.points, o.circles], dim=-2)
    radii = torch.cat([torch.zeros_like(o.points[..., 0]), o.circle_radii], dim=-1)
    mask = torch.cat([o.point_mask, o.circle_mask], dim=-1)
    return centers, radii, mask


def _footprint_radius(spec):
    return spec.footprint.radius if isinstance(spec.footprint, CircularFootprint) else 0.0


def obstacle_rows(spec, x, slots):
    """Obstacle rows at poses x (..., 3): g = min_dist − d (..., M), with d the
    footprint disc's safe-norm distance to each slot (BIG on a masked slot),
    and the position gradient of g (..., M, 2). ``slots`` broadcast against
    x's leading dims."""
    centers, radii, mask = slots
    e = x[..., None, :2] - centers
    dn = torch.sqrt(torch.sum(e * e, dim=-1) + _EPS)
    d = torch.where(mask, dn - radii, BIG_DISTANCE) - _footprint_radius(spec)
    return spec.min_obstacle_dist - d, -(e / dn[..., None])


def hinge_w(t, rho):
    """AL curvature weight of an exactly penalized linear inequality:
    ρ·s² with the 0.5 tie subgradient s, so t == 0 weighs ρ/4."""
    s = torch.where(t > 0.0, 1.0, torch.where(t == 0.0, 0.5, 0.0))
    return rho * s * s


def _rate_bounds(spec):
    """Rate limits sanitized to ±BIG as in ``constraints``: (lo, hi) floats."""
    lo, hi = spec.control_rate_box()
    lo = [max(float(v), -BIG_DISTANCE) for v in lo]
    hi = [min(float(v), BIG_DISTANCE) for v in hi]
    return lo, hi


def rate_g(spec, u, up, dt):
    """Rate rows [du − hi·dt (2), lo·dt − du (2)] (..., 4)."""
    lo, hi = _rate_bounds(spec)
    du = u - up
    return torch.stack(
        [du[..., 0] - hi[0] * dt, du[..., 1] - hi[1] * dt,
         lo[0] * dt - du[..., 0], lo[1] * dt - du[..., 1]],
        dim=-1,
    )


def box_g(spec, u):
    """Box rows [u − hi (2), lo − u (2)] (..., 4)."""
    lo, hi = (b.tolist() for b in spec.control_box())
    return torch.stack(
        [u[..., 0] - hi[0], u[..., 1] - hi[1], lo[0] - u[..., 0], lo[1] - u[..., 1]], dim=-1
    )


# rate rows: (sign, control component, bound index into (lo, hi))
_RATE_ROWS = ((1.0, 0, 1), (1.0, 1, 1), (-1.0, 0, 0), (-1.0, 1, 0))


def stage_grad_hess(spec, xk, uk, up, dt, mu_obs, on, mu_rate, mu_box, rho, slots):
    """Exact AL gradient (hz (..., 6), hu (..., 2)) and hybrid Gauss-Newton
    Hessian blocks (Hzz, Hzu, Huu) of the stage merit over z = [x, u_prev,
    dt] and v = u. ``mu_obs`` (..., M) is the stage's multiplier row, ``on``
    zeroes the obstacle block at k = 0; all leading dims are batch dims."""
    lead, opts = dt.shape, dict(dtype=dt.dtype, device=dt.device)
    hz = torch.zeros(lead + (6,), **opts)
    hu = torch.zeros(lead + (2,), **opts)
    Hzz = torch.zeros(lead + (6, 6), **opts)
    Hzu = torch.zeros(lead + (6, 2), **opts)
    Huu = torch.zeros(lead + (2, 2), **opts)
    hz[..., 5] = 1.0  # minimum time: the stage cost dt

    # obstacles at x_k: crisp Gauss-Newton weight ρ·[μ + ρg > 0]
    g, grad = obstacle_rows(spec, xk, slots)
    r, onm = rho[..., None], on[..., None]
    t = mu_obs * onm + r * g
    a = _hinge(t) * onm
    aw = r * onm * (t > 0.0).to(dt.dtype)
    gx, gy = grad[..., 0], grad[..., 1]
    hz[..., 0] = torch.sum(a * gx, dim=-1)
    hz[..., 1] = torch.sum(a * gy, dim=-1)
    Hzz[..., 0, 0] = torch.sum(aw * gx * gx, dim=-1)
    Hzz[..., 0, 1] = Hzz[..., 1, 0] = torch.sum(aw * gx * gy, dim=-1)
    Hzz[..., 1, 1] = torch.sum(aw * gy * gy, dim=-1)

    # rate rows g = ±(du − b·dt): J over u_prev and dt (z) and u (v)
    bounds = _rate_bounds(spec)
    t = mu_rate + r * rate_g(spec, uk, up, dt)
    a, aw = _hinge(t), hinge_w(t, r)
    for idx, (sgn, comp, which) in enumerate(_RATE_ROWS):
        ai, awi = a[..., idx], aw[..., idx]
        jz_up, jz_t, jv = -sgn, -sgn * bounds[which][comp], sgn
        zi = 3 + comp
        hz[..., zi] += ai * jz_up
        hu[..., comp] += ai * jv
        Hzz[..., zi, zi] += awi * jz_up * jz_up
        Hzu[..., zi, comp] += awi * jz_up * jv
        Huu[..., comp, comp] += awi * jv * jv
        hz[..., 5] += ai * jz_t
        Hzz[..., zi, 5] += awi * jz_up * jz_t
        Hzz[..., 5, zi] = Hzz[..., zi, 5]
        Hzz[..., 5, 5] += awi * jz_t * jz_t
        Hzu[..., 5, comp] += awi * jz_t * jv

    # box rows g = ±(u − b): J over u only
    t = mu_box + r * box_g(spec, uk)
    a, aw = _hinge(t), hinge_w(t, r)
    for idx, (sgn, comp, _) in enumerate(_RATE_ROWS):
        hu[..., comp] += a[..., idx] * sgn
        Huu[..., comp, comp] += aw[..., idx]
    return hz, hu, Hzz, Hzu, Huu


def terminal_Pp(spec, xN, dt, xf, lam_term, mu_obs, mu_dt, rho, slots):
    """PN (..., 6, 6) and pN (..., 6) of the terminal merit: the masked
    terminal equality, the obstacle Gauss-Newton block at x_N (multiplier
    row N−1) and the dt box."""
    lead, opts = dt.shape, dict(dtype=dt.dtype, device=dt.device)
    P = torch.zeros(lead + (6, 6), **opts)
    p = torch.zeros(lead + (6,), **opts)
    gd = se2_boxminus(xN, xf)
    for i, fixed in enumerate(spec.xf_fixed):
        if fixed:
            P[..., i, i] = rho
            p[..., i] = lam_term[..., i] + rho * gd[..., i]
    g, grad = obstacle_rows(spec, xN, slots)
    r = rho[..., None]
    t = mu_obs + r * g
    a = _hinge(t)
    aw = r * (t > 0.0).to(dt.dtype)
    gx, gy = grad[..., 0], grad[..., 1]
    p[..., 0] += torch.sum(a * gx, dim=-1)
    p[..., 1] += torch.sum(a * gy, dim=-1)
    P[..., 0, 0] += torch.sum(aw * gx * gx, dim=-1)
    P[..., 0, 1] += torch.sum(aw * gx * gy, dim=-1)
    P[..., 1, 0] = P[..., 0, 1]
    P[..., 1, 1] += torch.sum(aw * gy * gy, dim=-1)
    t1 = mu_dt[..., 0] + rho * (dt - spec.dt_max)
    t2 = mu_dt[..., 1] + rho * (spec.dt_min - dt)
    p[..., 5] = _hinge(t1) - _hinge(t2)
    P[..., 5, 5] = hinge_w(t1, rho) + hinge_w(t2, rho)
    return P, p


def fused_kkt_system(spec, primal: Primal, scenario, duals: DualState, slots):
    """The Riccati inputs (Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN) of one
    SQP iteration from K2a's closed forms; the counterpart of the AD
    ``al_sqp._kkt_system``."""
    N, M = spec.N, spec.obstacle_cap
    xs, us, dt = primal.xs, primal.us, primal.dt
    B = dt.shape[0]
    dt_b = dt[:, None].expand(B, N)
    c, F, G, m = defect_linearization(spec, xs[:, :-1], us, xs[:, 1:], dt_b)
    Fz, Gz, rz = build_augmented_transition(F, G, m, c, nu=spec.nu)
    up = torch.cat([scenario.u_prev[:, None], us[:, :-1]], dim=1)
    # obstacle multiplier rows: stage k uses mu_obs[k-1]; k = 0 inactive
    mu_obs = torch.cat([duals.mu_obs.new_zeros(B, 1, M), duals.mu_obs[:, : N - 1]], dim=1)
    on = torch.ones((B, N), dtype=dt.dtype, device=dt.device)
    on[:, 0] = 0.0
    stage_slots = tuple(a[:, None] for a in slots)
    hz, hu, Hzz, Hzu, Huu = stage_grad_hess(
        spec, xs[:, :-1], us, up, dt_b, mu_obs, on, duals.mu_rate, duals.mu_box,
        duals.rho[:, None].expand(B, N), stage_slots,
    )
    PN, pN = terminal_Pp(
        spec, xs[:, N], dt, scenario.xf, duals.lam_term, duals.mu_obs[:, N - 1],
        duals.mu_dt, duals.rho, slots,
    )
    return tuple(a.contiguous() for a in (Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN))


def _check_scope(spec, settings, scenario):
    reason = _spec_scope_error(spec)
    if reason is None and not fused_obstacles_supported(scenario):
        reason = "line or polygon obstacle slots"
    if reason is None and len(settings.alphas) > MAX_ALPHAS:
        reason = f"{len(settings.alphas)} line-search candidates (at most {MAX_ALPHAS})"
    if reason is not None:
        raise NotImplementedError(f"kernel K2a does not take {reason} (ROADMAP K2b-K2f)")


def fused_solve_plain(spec, settings, scenario, init: Primal, duals: DualState) -> SolveResult:
    """K2a's plain PyTorch version on any device: the whole warm solve with
    the kernel's closed-form derivatives and the plain ``lqr_solve``."""
    _check_scope(spec, settings, scenario)
    slots = circle_slots(scenario.obstacles)

    def kkt_system(primal, duals):
        return fused_kkt_system(spec, primal, scenario, duals, slots)

    plain = dataclasses.replace(settings, kkt="scan", fused="off")
    return solve(spec, plain, scenario, init, duals, kkt_system=kkt_system)


# --------------------------------------------------------------------------- #
# the kernel: build, bind, launch
# --------------------------------------------------------------------------- #
class _Params(ctypes.Structure):
    """``K2aParams`` of csrc/fused_al_sqp.cu, field for field."""

    _fields_ = [
        ("N", ctypes.c_int), ("M", ctypes.c_int), ("n_al", ctypes.c_int),
        ("n_sqp", ctypes.c_int), ("n_alpha", ctypes.c_int),
        ("xf_fixed", ctypes.c_int * 3),
        ("wheelbase", ctypes.c_double), ("fp_radius", ctypes.c_double),
        ("min_dist", ctypes.c_double),
        ("lo_u", ctypes.c_double * 2), ("hi_u", ctypes.c_double * 2),
        ("lo_r", ctypes.c_double * 2), ("hi_r", ctypes.c_double * 2),
        ("dt_min", ctypes.c_double), ("dt_max", ctypes.c_double),
        ("dt_lo", ctypes.c_double), ("dt_hi", ctypes.c_double),
        ("alphas", ctypes.c_double * MAX_ALPHAS),
        ("dt_trust_frac", ctypes.c_double), ("rho_growth", ctypes.c_double),
        ("rho_max", ctypes.c_double),
        ("reg0", ctypes.c_double), ("reg_shrink", ctypes.c_double),
        ("reg_grow", ctypes.c_double), ("reg_min", ctypes.c_double),
        ("reg_max", ctypes.c_double),
        ("viol_decrease_req", ctypes.c_double), ("tol_eq", ctypes.c_double),
        ("tol_ineq", ctypes.c_double),
    ]


def _params(spec, settings) -> _Params:
    lo_u, hi_u = (b.tolist() for b in spec.control_box())
    lo_r, hi_r = _rate_bounds(spec)
    alphas = [float(a) for a in settings.alphas]
    d2 = ctypes.c_double * 2
    return _Params(
        N=spec.N, M=spec.obstacle_cap, n_al=settings.n_al, n_sqp=settings.n_sqp,
        n_alpha=len(alphas), xf_fixed=(ctypes.c_int * 3)(*(int(b) for b in spec.xf_fixed)),
        wheelbase=spec.model.wheelbase, fp_radius=_footprint_radius(spec),
        min_dist=spec.min_obstacle_dist,
        lo_u=d2(*lo_u), hi_u=d2(*hi_u), lo_r=d2(*lo_r), hi_r=d2(*hi_r),
        dt_min=spec.dt_min, dt_max=spec.dt_max,
        dt_lo=max(spec.dt_min, 1.0e-3), dt_hi=spec.dt_max,
        alphas=(ctypes.c_double * MAX_ALPHAS)(*alphas),
        dt_trust_frac=settings.dt_trust_frac, rho_growth=settings.rho_growth,
        rho_max=settings.rho_max, reg0=settings.reg0, reg_shrink=settings.reg_shrink,
        reg_grow=settings.reg_grow, reg_min=settings.reg_min, reg_max=settings.reg_max,
        viol_decrease_req=settings.viol_decrease_req, tol_eq=settings.tol_eq,
        tol_ineq=settings.tol_ineq,
    )


def library_path():
    return nvcc_build.library_path(SOURCE)


def build() -> dict:
    """Compile the kernel if its library is missing (``nvcc_build``)."""
    return nvcc_build.build_library(SOURCE, library_path())


def bind(path):
    """Load a built K2a library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    for fn in (lib.k2a_fused_solve_f32, lib.k2a_fused_solve_f64):
        fn.argtypes = [ctypes.POINTER(_Params), ptrs, ptrs, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("k2a_max_n", "k2a_max_m", "k2a_max_alphas", "k2a_params_size"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.k2a_error_string.argtypes = [ctypes.c_int]
    lib.k2a_error_string.restype = ctypes.c_char_p
    limits = (lib.k2a_max_n(), lib.k2a_max_m(), lib.k2a_max_alphas(), lib.k2a_params_size())
    if limits != (MAX_N, MAX_M, MAX_ALPHAS, ctypes.sizeof(_Params)):
        raise RuntimeError(f"K2a library {path} does not match its wrapper: {limits}")
    return lib


def _load():
    global _lib
    if _lib is None:
        build()
        _lib = bind(library_path())
    return _lib


_IN_NAMES = (
    "xs", "us", "dt", "xf", "u_prev", "centers", "radii", "mask", "lam_def",
    "lam_term", "mu_obs", "mu_rate", "mu_box", "mu_dt", "mu_ball", "rho",
)


def kernel_io(spec, scenario, init: Primal, duals: DualState):
    """The kernel's 16 inputs (checked: one device, float32 or float64,
    contiguous, the expected shapes) and its 15 freshly allocated outputs."""
    xs = init.xs
    dev, dtype = xs.device, xs.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K2a takes float32 or float64, got {dtype}")
    B, N, M = xs.shape[0], spec.N, spec.obstacle_cap
    if B == 0:
        raise ValueError("K2a needs a non-empty batch")
    centers, radii, mask = circle_slots(scenario.obstacles)
    ins = (
        xs, init.us, init.dt, scenario.xf, scenario.u_prev, centers, radii, mask,
        duals.lam_def, duals.lam_term, duals.mu_obs, duals.mu_rate, duals.mu_box,
        duals.mu_dt, duals.mu_ball, duals.rho,
    )
    shapes = (
        (B, N + 1, 3), (B, N, 2), (B,), (B, 3), (B, 2), (B, M, 2), (B, M), (B, M),
        (B, N, 3), (B, 3), (B, N, M), (B, N, 4), (B, N, 4), (B, 2), (B, 1), (B,),
    )
    for name, a, shape in zip(_IN_NAMES, ins, shapes):
        want = torch.bool if name == "mask" else dtype
        if a.device != dev:
            raise ValueError(f"K2a: {name} is on {a.device}, xs on {dev}")
        if a.dtype != want:
            raise TypeError(f"K2a: {name} is {a.dtype}, expected {want}")
        if tuple(a.shape) != shape:
            raise ValueError(f"K2a: {name} has shape {tuple(a.shape)}, expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"K2a: {name} is not contiguous")
    # xs, us, dt, the 8 dual fields, cost, eq_norm, ineq_viol; converged
    out_shapes = shapes[:3] + shapes[8:] + ((B,),) * 3
    outs = tuple(torch.empty(s, dtype=dtype, device=dev) for s in out_shapes)
    return ins, outs + (torch.empty((B,), dtype=torch.bool, device=dev),)


def launch(lib, spec, settings, ins, outs, stream) -> None:
    """Run the kernel on ``ins`` into ``outs`` on ``stream``; raises on a
    refused launch."""
    params = _params(spec, settings)
    in_ptrs = (ctypes.c_void_p * len(ins))(*(a.data_ptr() for a in ins))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(a.data_ptr() for a in outs))
    fn = lib.k2a_fused_solve_f32 if ins[0].dtype == torch.float32 else lib.k2a_fused_solve_f64
    rc = fn(ctypes.byref(params), in_ptrs, out_ptrs, ins[0].shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"K2a launch failed: {lib.k2a_error_string(rc).decode()} ({rc})")


def result_of(outs) -> SolveResult:
    xs, us, dt, ld, lt, mo, mr, mb, md, mball, rho, cost, eq, ineq, conv = outs
    return SolveResult(
        primal=Primal(xs=xs, us=us, dt=dt),
        duals=DualState(
            lam_def=ld, lam_term=lt, mu_obs=mo, mu_rate=mr, mu_box=mb, mu_dt=md,
            mu_ball=mball, rho=rho,
        ),
        cost=cost, eq_norm=eq, ineq_viol=ineq, converged=conv,
    )


def fused_solve_cuda(spec, settings, scenario, init: Primal, duals: DualState) -> SolveResult:
    """Launch K2a on CUDA tensors with one leading lane axis: the whole
    n_al × n_sqp warm solve, the same ``SolveResult`` as ``al_sqp.solve``."""
    _check_scope(spec, settings, scenario)
    if init.xs.device.type != "cuda":
        raise ValueError(f"K2a runs on CUDA tensors, got {init.xs.device}")
    ins, outs = kernel_io(spec, scenario, init, duals)
    lib = _load()
    dev = init.xs.device
    with torch.cuda.device(dev):
        launch(lib, spec, settings, ins, outs, torch.cuda.current_stream(dev).cuda_stream)
    fused_solve_cuda.launches += 1
    return result_of(outs)


fused_solve_cuda.launches = 0


# --------------------------------------------------------------------------- #
# the work of one launch, for the bound
# --------------------------------------------------------------------------- #
# The structure of one stage's step inputs: "0" and "1" are the same
# constant at every stage and iterate, "v" varies. Fz, Gz and rz are the
# augmented transition (F = I + dt Jx with Jx's θ column only, G = dt Ju with
# no steering term in the position rows); Hzz, Hzu, Huu, hz and hu are
# ``stage_grad_hess``'s blocks (obstacles on x, y; rate rows on u_prev, dt
# and u; box rows on u). tests/test_torch_fused.py holds them against the
# plain version's tensors.
STEP_STRUCTURE = {
    "Fz": ("1 0 v 0 0 v", "0 1 v 0 0 v", "0 0 1 0 0 v", "0 0 0 0 0 0", "0 0 0 0 0 0",
           "0 0 0 0 0 1"),
    "Gz": ("v 0", "v 0", "v v", "1 0", "0 1", "0 0"),
    "rz": ("v v v 0 0 0",),
    "Hzz": ("v v 0 0 0 0", "v v 0 0 0 0", "0 0 0 0 0 0", "0 0 0 v 0 v", "0 0 0 0 v v",
            "0 0 0 v v v"),
    "Hzu": ("0 0", "0 0", "0 0", "v 0", "0 v", "v v"),
    "Huu": ("v 0", "0 v"),
    "hz": ("v v 0 v v v",),
    "hu": ("v v",),
}


def _structure(name):
    """STEP_STRUCTURE[name] as rows of 0.0, 1.0 or None (varies)."""
    return [[{"0": 0.0, "1": 1.0, "v": None}[t] for t in row.split()]
            for row in STEP_STRUCTURE[name]]


def step_flops() -> tuple[int, int]:
    """Operations of one stage of the Riccati step and of one stage of the
    rollout on ``STEP_STRUCTURE``: a product or sum with a structural 0 or
    1 folds away, as the TPU kernel folds it when it is traced; every other
    product and sum counts 1. P is dense after the first stage and counted
    dense; each entry of the symmetrized P is formed once."""
    count = 0

    def mul(a, b):
        nonlocal count
        if a == 0.0 or b == 0.0:
            return 0.0
        if a == 1.0 or b == 1.0:
            return b if a == 1.0 else a
        count += 1
        return None

    def add(a, b):
        nonlocal count
        if a == 0.0 or b == 0.0:
            return b if a == 0.0 else a
        count += 1
        return None

    def dot(xs, ys):
        acc = 0.0
        for x, y in zip(xs, ys):
            acc = add(acc, mul(x, y))
        return acc

    def cols(A):
        return [list(c) for c in zip(*A)]

    S = {name: _structure(name) for name in STEP_STRUCTURE}
    Fz, Gz, rz, Hzz, Hzu, Huu = (S[k] for k in ("Fz", "Gz", "rz", "Hzz", "Hzu", "Huu"))
    hz, hu, rz = S["hz"][0], S["hu"][0], rz[0]
    P, p, var2 = [[None] * 6 for _ in range(6)], [None] * 6, [[None] * 2 for _ in range(2)]
    PF = [[dot(row, c) for c in cols(Fz)] for row in P]
    PG = [[dot(row, c) for c in cols(Gz)] for row in P]
    Prp = [add(dot(row, rz), pi) for row, pi in zip(P, p)]
    Qzz = [[add(Hzz[i][j], dot(fc, c)) for j, c in enumerate(cols(PF))]
           for i, fc in enumerate(cols(Fz))]
    Qzu = [[add(Hzu[i][j], dot(fc, c)) for j, c in enumerate(cols(PG))]
           for i, fc in enumerate(cols(Fz))]
    for i, gc in enumerate(cols(Gz)):  # Quu = Huu + Gz' P Gz + reg I
        for j, c in enumerate(cols(PG)):
            add(add(Huu[i][j], dot(gc, c)), None if i == j else 0.0)
    qz = [add(h, dot(fc, Prp)) for h, fc in zip(hz, cols(Fz))]
    qu = [add(h, dot(gc, Prp)) for h, gc in zip(hu, cols(Gz))]
    count += 8  # 2x2 inverse: det (3), 1/det, four scaled entries
    K = [[dot(qi, row) for row in Qzu] for qi in var2]  # negation is free
    kf = [dot(qi, qu) for qi in var2]
    v = [[add(Qzz[i][j], dot(Qzu[i], [K[0][j], K[1][j]])) for j in range(6)]
         for i in range(6)]
    for i in range(6):
        for j in range(i, 6):
            mul(0.5, add(v[i][j], v[j][i]))
        add(qz[i], dot(Qzu[i], kf))
    riccati, count = count, 0
    z = [None] * 6  # rollout: u = K z + kff, z' = Fz z + Gz u + rz
    u = [add(dot(row, z), None) for row in [[None] * 6] * 2]
    for frow, grow, r in zip(Fz, Gz, rz):
        add(add(dot(frow, z), dot(grow, u)), r)
    return riccati, count


def k2a_flops(N: int, M: int, n_al: int, n_sqp: int, n_alpha: int) -> int:
    """Floating-point operations one scenario's solve needs: its closed
    forms counted from csrc/fused_al_sqp.cu, the Riccati step and the
    rollout on their structure (``step_flops``; the kernel itself does them
    as dense 6x6 products, about four times the work). A multiply-add is 2;
    sqrt, division and the trigonometric functions 1 each; comparisons,
    negations and copies 0. The schedule is fixed, so every lane does the
    same work."""
    riccati, rollout_step = step_flops()
    terminal = 30 + 30 * M                 # terminal_Pp
    # dyn 12 (cos, sin, tan; v c, v s, v t / wb; t / wb, v (1 + t²) / wb),
    # defect 13 (three x + dt f − x', the θ wrap), F 2, G 4
    transition = 31
    stage = 175 + 30 * M                   # stage_grad_hess (obstacles, rate, box)
    rollout = transition + rollout_step
    merit_stage = 121 + 20 * M             # candidate, defect, penalties
    per_iter = (
        terminal + N * (transition + stage + riccati) + 3 + N * rollout
        + 4 + (n_alpha + 1) * (N * merit_stage + 40) + 13 * N + 6
    )
    per_phase = N * (80 + 16 * M) + 20     # dual update
    return n_al * n_sqp * per_iter + n_al * per_phase + 2
