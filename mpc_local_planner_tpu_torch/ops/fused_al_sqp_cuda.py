"""The fused whole-solve kernel: one whole warm AL-SQP solve per scenario as a
hand-written CUDA kernel, with its plain PyTorch version.

Replaces the TPU kernel
``mpc_local_planner_tpu/ops/fused_al_sqp_pallas.py :: _fused_kernel``
(launched by ``fused_solve``) on the scope of JAX ``fused_supported``: the
unicycle, both Ackermann cars and the kinematic bicycle (template parameter
of the kernel), forward, midpoint or Crank–Nicolson differences (the
latter two with the −E⁻¹ fold in closed form, K2b) or a shooting grid of a
tableau of at most 11 stages, 4 substeps and 28 stages × substeps (K2e; a
template parameter tells forward differences from the other rules, which
the kernel reads at run time with the tableau), a
point, disc, two-disc, line or
polygon footprint (at most 8 vertices), point, circle, line and polygon
obstacle slots, static or dynamic (runtime values of the launch; the kernel
compiles them away for a launch with one disc at the pose and static point
and circle slots, and has instantiations of its own for a segment or a
polygon footprint), minimum time, minimum time with at most 8 via points
(ordered or not, with an orientation weight) or the quadratic form
(template parameter; plain or integral, left-sum or trapezoidal, hybrid
time weight), the terminal quadratic cost and the terminal ball, on a
uniform grid of any length with a variable or fixed dt or on the
non-uniform grid of a per-stage dt (K2f: δdt_k a third control column of
the step, the interval's dt box a stage row; the template parameter NONU),
any number of obstacle slots and of
line-search candidates. K2a, the first specialization ported (simple car,
minimum time, variable dt), is one instantiation. The
source is ``csrc/fused_al_sqp.cu``: a team of ``TEAM`` lanes of one warp
runs one scenario's n_al × n_sqp schedule to its end — closed-form
derivatives streamed into the Riccati sweep, the rollout, the NaN
quarantine, the candidate line search, the dual updates, the best-feasible
snapshot and the final selection — for float and double, in the port's
(B, N, ...) layout. The lanes take the stages in turn wherever the stages
are independent (the stage terms of the sweep, each candidate's merit, the
step's application, the dual update, the snapshot and the selection); the
Riccati recursion and the rollout stay serial over the stages, each stage's
6×6 products spread over the lanes. A team's working state (the primal,
the step, a chunk of stage terms, the gain tape, the duals and the
snapshot) lives in its slice of the block's shared memory as far as its
budget holds it, the rest in the output tensors or in a workspace the
wrapper allocates, scenario-major (``launch_geometry``); the candidates are
a device input. Each (working type, model, objective family, grid,
collocation family) is a group of five instantiations built into a library
of its own (``Group``),
when a launch first needs it or all at once beforehand (``build``).

What bounds it on an H100 is arithmetic: the flagship solve needs about
0.79 MFLOP per scenario at the warm 3×4 budget (``k2a_flops``, the Riccati
step on its structure) against 6 KB of input and output, so at B = 4096
about 48 µs at the float32 peak against 7 µs for the bytes. The kernel runs
the step as dense 6×6 products (1.7 times the operations over the whole
solve); a team per scenario puts several warps on every SM at the fleet
cycle's batches and cuts each scenario's dependent chain to the serial
recursion's.

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

import collections
import ctypes
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import torch

from mpc_local_planner_tpu_torch.core.so2 import (
    _wrap_theta,
    angle_diff,
    normalize_angle,
    se2_boxminus,
)
from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.geometry.distances import _EPS, _polygon_edges
from mpc_local_planner_tpu_torch.device import const
from mpc_local_planner_tpu_torch.geometry.footprints import (
    CircularFootprint,
    LineFootprint,
    PointFootprint,
    PolygonFootprint,
    TwoCirclesFootprint,
    disc_footprint,
)
from mpc_local_planner_tpu_torch.geometry.obstacles import BIG_DISTANCE
from mpc_local_planner_tpu_torch.ocp.costs import trapezoidal
from mpc_local_planner_tpu_torch.numerics.integrators import RK_TABLEAUS
from mpc_local_planner_tpu_torch.ocp.collocation import SHOOTING_PREFIX, _parse_shooting
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.problem import OcpFunctions
from mpc_local_planner_tpu_torch.ocp.spec import MODELS
from mpc_local_planner_tpu_torch.ops import nvcc_build
from mpc_local_planner_tpu_torch.solvers.al_sqp import (
    DualState,
    SolveResult,
    _hinge,
    _stage_obstacles,
    _via_weights,
    dt_clip,
    has_via,
    solve,
)
from mpc_local_planner_tpu_torch.solvers.riccati import (
    build_augmented_transition,
    build_augmented_transition_nonuniform,
)
from mpc_local_planner_tpu_torch.systems.models import (
    KinematicBicycleModelVelocityInput,
    SimpleCarFrontWheelDrivingModel,
    SimpleCarModel,
    UnicycleModel,
)

SOURCE = nvcc_build.CSRC / "fused_al_sqp.cu"
# compile-time maxima of the kernel (csrc/fused_al_sqp.cu): padded polygon
# vertices, polygon footprint vertices and via points (JAX
# ``fused_obstacles_supported`` and ``fused_supported``)
MAX_V, MAX_FP_V, MAX_VIA = 16, 8, 8
# a shooting grid's integrator (JAX ``fused_supported``): a tableau of at
# most MAX_RK stages, at most MAX_SUBSTEPS substeps and MAX_RK_EVALS
# dynamics evaluations per stage of the grid
MAX_RK, MAX_SUBSTEPS, MAX_RK_EVALS = 11, 4, 28
# the launch (csrc/fused_al_sqp.cu): a team of TEAM lanes solves one
# scenario, BLOCK threads a block; a team's shared budget (SMEM_TEAM_F32
# bytes in float, twice that in double, at most a block's SMEM_BLOCK over
# its teams) holds its 32 bytes of via stage indices, SCRATCH values of the
# Riccati step's blocks and then each array of ``_arrays`` that fits
TEAM, BLOCK = 32, 64
SMEM_BLOCK, SMEM_TEAM_F32, VKS_BYTES, SCRATCH = 232448, 18944, 32, 192

_libs = {}  # the loaded library of each ``Group``


# --------------------------------------------------------------------------- #
# scope
# --------------------------------------------------------------------------- #
# the kernel's model template parameter (csrc/fused_al_sqp.cu ModelId)
MODEL_IDS = {
    UnicycleModel: 0,
    SimpleCarModel: 1,
    SimpleCarFrontWheelDrivingModel: 2,
    KinematicBicycleModelVelocityInput: 3,
}


# the kernel's footprint kinds (csrc/fused_al_sqp.cu FootprintKind)
FOOTPRINT_KINDS = {
    PointFootprint: 0, CircularFootprint: 0, TwoCirclesFootprint: 0,
    LineFootprint: 1, PolygonFootprint: 2,
}


def _spec_scope_error(spec):
    """Why the kernel cannot run ``spec`` (None when it can): what the TPU
    kernel does not take either (JAX ``fused_supported``)."""
    if type(spec.model) not in MODELS:
        return f"model {type(spec.model).__name__}"
    fp = spec.footprint
    if type(fp) not in FOOTPRINT_KINDS:
        return f"footprint {type(fp).__name__}"
    if isinstance(fp, PolygonFootprint) and len(fp.vertices) > MAX_FP_V:
        return f"a polygon footprint of {len(fp.vertices)} vertices (at most {MAX_FP_V})"
    if spec.collocation.startswith(SHOOTING_PREFIX):
        integ, substeps = _parse_shooting(spec.collocation)
        if (integ not in RK_TABLEAUS or substeps > MAX_SUBSTEPS
                or len(RK_TABLEAUS[integ][1]) * substeps > MAX_RK_EVALS):
            return (f"collocation {spec.collocation!r} (a tableau of RK_TABLEAUS, at most "
                    f"{MAX_SUBSTEPS} substeps and {MAX_RK_EVALS} stages × substeps)")
    if spec.via_cap > MAX_VIA:
        return f"via_cap={spec.via_cap} (at most {MAX_VIA})"
    return None


def fused_supported(spec) -> bool:
    """True when the kernel computes this spec's exact semantics."""
    return _spec_scope_error(spec) is None


def fused_obstacles_supported(scenario) -> bool:
    """Every slot family is in the kernel's scope; polygon slots up to
    MAX_V padded vertices (JAX ``fused_obstacles_supported``)."""
    o = scenario.obstacles
    return o.polygons.shape[-3] == 0 or o.polygons.shape[-2] <= MAX_V


# --------------------------------------------------------------------------- #
# closed-form pieces (batched over any leading dims)
# --------------------------------------------------------------------------- #
def dyn(spec, x, u):
    """The model's f(x, u) (..., 3), the θ column of Jx (..., 2; the other
    columns are zero for every model) and Ju (..., 3, 2), in closed form."""
    model = spec.model
    th, v, w = x[..., 2], u[..., 0], u[..., 1]
    zero = torch.zeros_like(v)
    if type(model) is UnicycleModel:
        c, s = torch.cos(th), torch.sin(th)
        f = [v * c, v * s, w]
        jx = [-v * s, v * c]
        ju = [[c, zero], [s, zero], [zero, zero + 1.0]]
    elif type(model) is SimpleCarModel:
        wb = model.wheelbase
        c, s, t = torch.cos(th), torch.sin(th), torch.tan(w)
        f = [v * c, v * s, v * t / wb]
        jx = [-v * s, v * c]
        ju = [[c, zero], [s, zero], [t / wb, v * (1.0 + t * t) / wb]]
    elif type(model) is SimpleCarFrontWheelDrivingModel:
        wb = model.wheelbase
        c, s = torch.cos(th), torch.sin(th)
        cp, sp = torch.cos(w), torch.sin(w)
        vl = v * cp
        f = [vl * c, vl * s, v * sp / wb]
        jx = [-vl * s, vl * c]
        ju = [[cp * c, -v * sp * c], [cp * s, -v * sp * s], [sp / wb, v * cp / wb]]
    else:  # kinematic bicycle: beta = atan(a tan δ), a = lr / (lf + lr)
        a, lr = _bicycle_a(model), model.lr
        t = torch.tan(w)
        at = a * t
        beta = torch.atan(at)
        dbeta = a * (1.0 + t * t) / (1.0 + at * at)
        cb, sb = torch.cos(th + beta), torch.sin(th + beta)
        sbe, cbe = torch.sin(beta), torch.cos(beta)
        f = [v * cb, v * sb, v * sbe / lr]
        jx = [-v * sb, v * cb]
        ju = [[cb, -v * sb * dbeta], [sb, v * cb * dbeta], [sbe / lr, v * cbe * dbeta / lr]]
    ju = torch.stack([torch.stack(row, dim=-1) for row in ju], dim=-2)
    return torch.stack(f, dim=-1), torch.stack(jx, dim=-1), ju


def _bicycle_a(model) -> float:
    return model.lr / (model.lf + model.lr)


# the kernel's collocation rules (csrc/fused_al_sqp.cu K2aParams::colloc)
# and the library family of each (the template parameter COLLOC, the macro
# K2A_COLLOC, ``Group.colloc``): forward differences, or the other rules
# (the −E⁻¹ fold of midpoint and Crank–Nicolson, the shooting grids'
# tableau walk) in one family, the rule and the tableau read at run time
COLLOC_IDS = {"forward_differences": 0, "midpoint_differences": 1,
              "crank_nicolson_differences": 2}
SHOOTING = 3
COLLOC_FAMILY = {0: 0, 1: 1, 2: 1, SHOOTING: 1}


def colloc_id(spec) -> int:
    if spec.collocation.startswith(SHOOTING_PREFIX):
        return SHOOTING
    return COLLOC_IDS[spec.collocation]


def shooting_tableau(spec):
    """(a rows for stages 2..S, b, substeps) of a shooting grid."""
    integ, substeps = _parse_shooting(spec.collocation)
    a_rows, b = RK_TABLEAUS[integ]
    return a_rows, b, substeps


def kernel_midpoint(xk, xk1):
    """The kernel's SE(2) midpoint ((x_k + x_{k+1})/2, wrap(θ_k + ½ wrap(θ_{k+1}
    − θ_k))): the JAX ``se2_interpolate`` at ½, rounded the kernel's way."""
    th = normalize_angle(xk[..., 2] + 0.5 * normalize_angle(xk1[..., 2] - xk[..., 2]))
    return torch.stack([0.5 * (xk[..., 0] + xk1[..., 0]), 0.5 * (xk[..., 1] + xk1[..., 1]), th],
                       dim=-1)


def shoot(spec, xk, uk, dt, tangent=True):
    """The shooting prediction Φ(x_k, u_k, dt) by the kernel's walk of the
    tableau (h = dt / substeps; per nonzero entry c: y += (c h) k) and, with
    ``tangent``, its 3×6 tangent over w = [x_k, u_k, dt] (the JAX
    ``_shoot_phi``'s forward mode: each k pushes the θ row of the tangent
    through Jx's θ column and adds Ju; the dt column carries (c/substeps) k).
    dt has the leading shape. Returns (Φ, tangent or None)."""
    a_rows, b, substeps = shooting_tableau(spec)
    h = (dt / substeps if substeps > 1 else dt)[..., None]
    dh = 1.0 / substeps
    x, X = xk, None
    if tangent:
        X = torch.eye(3, 6, dtype=xk.dtype, device=xk.device).expand(xk.shape + (6,))

    def jvp(y, Y):
        f, jx, ju = dyn(spec, y, uk)
        if Y is None:
            return f, None
        K = torch.zeros_like(Y)
        K[..., 0:2, :] = jx[..., :, None] * Y[..., 2:3, :]
        K[..., :, 3:5] = K[..., :, 3:5] + ju
        return f, K

    def axpy(y, Y, c, k, K):
        ch = c * h
        y = y + ch * k
        if Y is not None:
            D = ch[..., None] * K
            D[..., 5] = D[..., 5] + (c * dh) * k
            Y = Y + D
        return y, Y

    for _ in range(substeps):
        ks = [jvp(x, X)]
        for row in a_rows:
            y, Y = x, X
            for c, (k, K) in zip(row, ks):
                if c != 0.0:
                    y, Y = axpy(y, Y, c, k, K)
            ks.append(jvp(y, Y))
        for c, (k, K) in zip(b, ks):
            if c != 0.0:
                x, X = axpy(x, X, c, k, K)
    return x, X


def defect_value(spec, xk, uk, xk1, dt):
    """The defect c = wrap(pred − x_{k+1}) as the kernel rounds it: forward
    differences x_k + dt f(x_k); midpoint x_k + dt f at ``kernel_midpoint``;
    Crank–Nicolson x_k + dt ½(f(x_k) + f(x_{k+1})); a shooting grid
    ``shoot``. dt has the leading shape."""
    rule = colloc_id(spec)
    if rule == SHOOTING:
        return _wrap_theta(shoot(spec, xk, uk, dt, tangent=False)[0] - xk1)
    if rule == 0:
        f = dyn(spec, xk, uk)[0]
    elif rule == 1:
        f = dyn(spec, kernel_midpoint(xk, xk1), uk)[0]
    else:
        f = 0.5 * (dyn(spec, xk, uk)[0] + dyn(spec, xk1, uk)[0])
    return _wrap_theta(xk + dt[..., None] * f - xk1)


def defect_linearization(spec, xk, uk, xk1, dt):
    """The defect c and its transition form dx_{k+1} = F dx_k + G du_k + m
    ddt + r (the Pallas ``defect``'s five values; the caller zeroes m on a
    fixed dt). dt has the leading shape.

    Forward differences: F = I + dt Jx, G = dt Ju, m = f, r = c (E = −I).
    Midpoint and Crank–Nicolson: E = −I + (dt/2) Jx_e has only a θ column
    (P, Q), so −E⁻¹ = [[1, 0, P], [0, 1, Q], [0, 0, 1]] folds in closed form:
    F = I + the θ column (dt/2) Jx_a + (P, Q), rows 0-1 of G, m and r gain
    (P, Q) times row 2 (G = −E⁻¹ dt Ju_b, m = −E⁻¹ f, r = −E⁻¹ c). Midpoint
    takes Jx and Ju at ``kernel_midpoint``, Crank–Nicolson Jx_a at x_k, Jx_e
    at x_{k+1} and ½(Ju(x_k) + Ju(x_{k+1})). Shooting: F, G and m are the
    tangent of ``shoot``, r = c (E = −I)."""
    rule = colloc_id(spec)
    d = dt[..., None]
    if rule == SHOOTING:
        x, X = shoot(spec, xk, uk, dt)
        c = _wrap_theta(x - xk1)
        return c, X[..., :3].contiguous(), X[..., 3:5].contiguous(), X[..., 5].contiguous(), c
    if rule == 0:
        f, jx, ju = dyn(spec, xk, uk)
        c = _wrap_theta(xk + d * f - xk1)
        F = torch.eye(3, dtype=xk.dtype, device=xk.device).expand(dt.shape + (3, 3)).clone()
        F[..., 0:2, 2] = d * jx
        G = d[..., None] * ju
        return c, F, G, f, c
    if rule == 1:
        f, ja, bu = dyn(spec, kernel_midpoint(xk, xk1), uk)
        je = ja
    else:
        fa, ja, jua = dyn(spec, xk, uk)
        fb, je, jub = dyn(spec, xk1, uk)
        f = 0.5 * (fa + fb)
        bu = 0.5 * (jua + jub)
    c = _wrap_theta(xk + d * f - xk1)
    hdt = 0.5 * d
    pq = hdt * je  # (P, Q): −E⁻¹'s θ column
    F = torch.eye(3, dtype=xk.dtype, device=xk.device).expand(dt.shape + (3, 3)).clone()
    F[..., 0:2, 2] = hdt * ja + pq
    G = d[..., None] * bu
    G[..., 0:2, :] = G[..., 0:2, :] + pq[..., :, None] * G[..., 2:3, :]
    m, r = f.clone(), c.clone()
    m[..., 0:2] = f[..., 0:2] + pq * f[..., 2:3]
    r[..., 0:2] = c[..., 0:2] + pq * c[..., 2:3]
    return c, F, G, m, r


@dataclasses.dataclass(frozen=True)
class KernelFunctions(OcpFunctions):
    """The OCP's evaluators with the kernel's defect values
    (``defect_value``), for the plain version's merit and dual update."""

    def defects(self, primal: Primal) -> torch.Tensor:
        xs, dt = primal.xs, primal.dt
        xk, xk1 = xs[..., :-1, :], xs[..., 1:, :]
        dtb = dt if dt.dim() == xs.dim() - 1 else dt[..., None].expand(xk.shape[:-1])
        return defect_value(self.spec, xk, primal.us, xk1, dtb)


def circle_slots(obstacles):
    """Point and circle slots as one family: centers (B, M, 2), radii (B, M)
    (points have radius 0), masks (B, M) and velocities (B, M, 2), points
    first as in ``footprints.distances``."""
    o = obstacles
    centers = torch.cat([o.points, o.circles], dim=-2)
    radii = torch.cat([torch.zeros_like(o.points[..., 0]), o.circle_radii], dim=-1)
    mask = torch.cat([o.point_mask, o.circle_mask], dim=-1)
    vels = torch.cat([o.point_vels, o.circle_vels], dim=-2)
    return centers, radii, mask, vels


def _disc_centers(spec, x):
    """The footprint discs at poses x (..., 3): [(px, py, radius, dpx/dθ,
    dpy/dθ)], each disc at p + offset·(cos θ, sin θ) (Pallas ``fp_points``)."""
    out = []
    for off, r in disc_footprint(spec.footprint):
        if off == 0.0:
            zero = torch.zeros_like(x[..., 0])
            out.append((x[..., 0], x[..., 1], r, zero, zero))
        else:
            c, s = torch.cos(x[..., 2]), torch.sin(x[..., 2])
            out.append((x[..., 0] + off * c, x[..., 1] + off * s, r, -off * s, off * c))
    return out


def _clip_gate(t_raw):
    """AD gate of jnp.clip(t_raw, 0, 1): 0.5 at an exact 0 or 1."""
    g1 = torch.where(t_raw > 0.0, 1.0, torch.where(t_raw == 0.0, 0.5, 0.0))
    y = torch.clamp(t_raw, min=0.0)
    g2 = torch.where(y < 1.0, 1.0, torch.where(y == 1.0, 0.5, 0.0))
    return g1 * g2


def _sel_lt(a, b):
    """Weight of ``a`` in torch.minimum(a, b): 1, 0.5 at a tie, 0."""
    return torch.where(a < b, 1.0, torch.where(a == b, 0.5, 0.0))


def _point_seg(px, py, ax, ay, bx, by):
    """point_to_segment from the disc center p to the segment [a, b] and its
    gradient in p (Pallas ``d_point_seg``)."""
    abx, aby = bx - ax, by - ay
    denom = torch.clamp(abx * abx + aby * aby, min=_EPS)
    sx, sy = px - ax, py - ay
    t_raw = (sx * abx + sy * aby) / denom
    t = torch.clamp(t_raw, 0.0, 1.0)
    ex, ey = sx - t * abx, sy - t * aby
    dn = torch.sqrt(ex * ex + ey * ey + _EPS)
    eab = (ex * abx + ey * aby) * _clip_gate(t_raw) / denom
    return dn, (ex - eab * abx) / dn, (ey - eab * aby) / dn


def _polygon_rows(px, py, polys, nv):
    """point_to_polygon_signed from the disc center p (..., 1) to padded
    polygons (..., Mg, V, 2) with nv active vertices (..., Mg), and its
    gradient in p: the minimum over the active edges (an equal split among
    tied edges, as jnp.min), negated inside by the even-odd rule."""
    a, b, act = _polygon_edges(polys, nv)
    ax, ay, bx, by = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    qx, qy = px[..., None, None], py[..., None, None]
    d, gx, gy = _point_seg(qx, qy, ax, ay, bx, by)
    d = torch.where(act, d, torch.inf)
    dmin = torch.amin(d, dim=-1)
    w = ((d == dmin[..., None]) & act).to(d.dtype)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    gx, gy = torch.sum(w * gx, dim=-1), torch.sum(w * gy, dim=-1)
    cond = (ay > qy) != (by > qy)
    dy = torch.where(torch.abs(by - ay) < _EPS, _EPS, by - ay)
    x_int = ax + (qy - ay) * (bx - ax) / dy
    crossing = cond & (qx < x_int) & act
    sgn = torch.where(torch.remainder(torch.sum(crossing.int(), dim=-1), 2) == 1, -1.0, 1.0)
    return sgn * dmin, sgn * gx, sgn * gy


def _seg_point(S, cx, cy):
    """point_to_segment from the fixed point c to the footprint segment S =
    (ax, ay, bx, by, aθx, aθy, bθx, bθy), which moves with the pose, and its
    pose gradient (..., 3): the whole AD chain with the ∂|ab|²/∂θ term
    (Pallas ``d_seg_point``)."""
    ax, ay, bx, by, tax, tay, tbx, tby = S
    abx, aby = bx - ax, by - ay
    d2 = abx * abx + aby * aby
    denom = torch.clamp(d2, min=_EPS)
    sx, sy = cx - ax, cy - ay
    t_raw = (sx * abx + sy * aby) / denom
    t = torch.clamp(t_raw, 0.0, 1.0)
    ex, ey = sx - t * abx, sy - t * aby
    dn = torch.sqrt(ex * ex + ey * ey + _EPS)
    abtx, abty = tbx - tax, tby - tay
    gd = torch.where(d2 > _EPS, 1.0, torch.where(d2 == _EPS, 0.5, 0.0))
    ddenom_th = gd * 2.0 * (abx * abtx + aby * abty)
    ds_th = -(tax * abx + tay * aby) + (sx * abtx + sy * abty)
    cl = _clip_gate(t_raw)
    dt_x, dt_y = cl * (-abx) / denom, cl * (-aby) / denom
    dt_th = cl * (ds_th / denom - t_raw * ddenom_th / denom)
    # e = (c − A) − t·ab
    gx = (ex * (-1.0 - abx * dt_x) + ey * (-aby * dt_x)) / dn
    gy = (ex * (-abx * dt_y) + ey * (-1.0 - aby * dt_y)) / dn
    gth = (ex * (-tax - abx * dt_th - t * abtx) + ey * (-tay - aby * dt_th - t * abty)) / dn
    return dn, torch.stack([gx, gy, gth], dim=-1)


def _moving_point_seg(px, py, tx, ty, ax, ay, bx, by):
    """point_to_segment from a footprint point p (θ derivative (tx, ty)) to
    the fixed segment [a, b], and its pose gradient (..., 3)."""
    dn, gx, gy = _point_seg(px, py, ax, ay, bx, by)
    return dn, torch.stack([gx, gy, gx * tx + gy * ty], dim=-1)


def _min2(c1, c2):
    """torch.minimum of two (value, pose gradient) candidates with the 0.5
    tie split (Pallas ``min2``)."""
    (d1, g1), (d2, g2) = c1, c2
    w1, w2 = _sel_lt(d1, d2), _sel_lt(d2, d1)
    return torch.minimum(d1, d2), w1[..., None] * g1 + w2[..., None] * g2


def _orient(ax, ay, bx, by, cx, cy):
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def _seg_seg(S, ax, ay, bx, by, rev=False):
    """segment_to_segment between the footprint segment S and the fixed
    segment [a, b]: the nested minimum of the four point-segment distances,
    zero (with a zero gradient) under a proper intersection. ``rev``: [a, b]
    is the first argument (Pallas ``d_seg_seg_rev``: the obstacle line of
    ``segment_to_polygon`` with the footprint polygon), which pairs the
    minimum's ties otherwise."""
    fa, fb = S[0:2], S[2:4]
    c_a = _moving_point_seg(*fa, *S[4:6], ax, ay, bx, by)
    c_b = _moving_point_seg(*fb, *S[6:8], ax, ay, bx, by)
    c_p, c_q = _seg_point(S, ax, ay), _seg_point(S, bx, by)
    pairs = ((c_p, c_q), (c_a, c_b)) if rev else ((c_a, c_b), (c_p, c_q))
    d, g = _min2(_min2(*pairs[0]), _min2(*pairs[1]))
    inter = (_orient(ax, ay, bx, by, *fa) * _orient(ax, ay, bx, by, *fb) < 0) & (
        _orient(*fa, *fb, ax, ay) * _orient(*fa, *fb, bx, by) < 0)
    return torch.where(inter, 0.0, d), torch.where(inter[..., None], 0.0, g)


def _edges_min(d, g, act):
    """jnp.min over the last axis where ``act`` (all where None), with the
    gradient split equally among tied edges (Pallas ``_edges_min``)."""
    if act is not None:
        d = torch.where(act, d, torch.inf)
    dmin = torch.amin(d, dim=-1)
    w = d == dmin[..., None]
    if act is not None:
        w = w & act
    w = w.to(g.dtype)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    return dmin, torch.sum(w[..., None] * g, dim=-2)


def _inside(px, py, ax, ay, bx, by, act):
    """The even-odd rule over the last axis of the edges [a, b] (where
    ``act``; all where None): whether p lies inside."""
    cond = (ay > py) != (by > py)
    dy = torch.where(torch.abs(by - ay) < _EPS, _EPS, by - ay)
    crossing = cond & (px < ax + (py - ay) * (bx - ax) / dy)
    if act is not None:
        crossing = crossing & act
    return torch.remainder(torch.sum(crossing.int(), dim=-1), 2) == 1


def _slot_edges(obs):
    """The polygon slots' edges: ax, ay, bx, by (..., Mg, V) and their
    active mask (``distances._polygon_edges``)."""
    a, b, act = _polygon_edges(obs.polygons, obs.polygon_nv)
    return a[..., 0], a[..., 1], b[..., 0], b[..., 1], act


def _footprint_points(body, x):
    """Body-frame points ``body`` (V, 2) at poses x (..., 3): world x, y and
    their θ derivatives, each (..., V) (Pallas ``fp_segment`` /
    ``fp_polygon``, in ``footprints``' order of operations)."""
    c, s = torch.cos(x[..., 2, None]), torch.sin(x[..., 2, None])
    vx, vy = body[:, 0], body[:, 1]
    return (x[..., 0, None] + (c * vx - s * vy), x[..., 1, None] + (s * vx + c * vy),
            -s * vx - c * vy, c * vx - s * vy)


def _rows(cols):
    """The slot families' (d, grad, mask) in row order as (d, grad), d BIG
    on a masked slot."""
    d = torch.cat([torch.where(m, dc, BIG_DISTANCE) for dc, _, m in cols], dim=-1)
    return d, torch.cat([g for _, g, _ in cols], dim=-2)


def _line_footprint_rows(fp, x, obs):
    """The footprint segment's distance to every slot and its pose gradient
    (Pallas ``d_seg_point``, ``d_seg_seg``, ``d_seg_polygon``): a point or
    circle slot by point_to_segment less its radius, a line slot by
    segment_to_segment, a polygon slot by segment_to_polygon (zero when the
    segment's start lies inside)."""
    px, py, tx, ty = _footprint_points(const((fp.line_start, fp.line_end), x), x)
    S = (px[..., 0], py[..., 0], px[..., 1], py[..., 1], tx[..., 0], ty[..., 0],
         tx[..., 1], ty[..., 1])
    centers, radii, cmask, _ = circle_slots(obs)
    S1 = tuple(v[..., None] for v in S)
    d, g = _seg_point(S1, centers[..., 0], centers[..., 1])
    cols = [(d - radii, g, cmask)]
    lines = obs.lines
    if lines.shape[-3]:
        cols.append(_seg_seg(S1, lines[..., 0, 0], lines[..., 0, 1], lines[..., 1, 0],
                             lines[..., 1, 1]) + (obs.line_mask,))
    if obs.polygons.shape[-3]:
        ax, ay, bx, by, act = _slot_edges(obs)
        S2 = tuple(v[..., None, None] for v in S)
        d, g = _edges_min(*_seg_seg(S2, ax, ay, bx, by), act)
        inside = _inside(S2[0], S2[1], ax, ay, bx, by, act)
        cols.append((torch.where(inside, 0.0, d), torch.where(inside[..., None], 0.0, g),
                     obs.polygon_mask))
    return _rows(cols)


def _polygon_footprint_rows(fp, x, obs):
    """The footprint polygon's distance to every slot and its pose gradient
    (Pallas ``d_point_fp_polygon``, ``d_seg_fp_polygon``,
    ``d_polygon_fp_polygon``): a point or circle slot by the signed distance
    of its center (negative inside the footprint, by the even-odd rule) less
    its radius; a line slot by segment_to_polygon with the line first (zero
    when its first end lies inside); a polygon slot by polygon_to_polygon
    with the footprint first, over every pair of a footprint edge and an
    active slot edge (zero when either holds the other's first vertex)."""
    px, py, tx, ty = _footprint_points(const(fp.vertices, x), x)
    nxt = lambda v: torch.roll(v, -1, dims=-1)  # noqa: E731
    E = (px, py, nxt(px), nxt(py), tx, ty, nxt(tx), nxt(ty))  # edges (..., Vf)
    E1 = tuple(v[..., None, :] for v in E)                   # (..., 1, Vf)
    centers, radii, cmask, _ = circle_slots(obs)
    cx, cy = centers[..., 0, None], centers[..., 1, None]
    d, g = _edges_min(*_seg_point(E1, cx, cy), None)
    sgn = torch.where(_inside(cx, cy, *E1[:4], None), -1.0, 1.0)
    cols = [(sgn * d - radii, sgn[..., None] * g, cmask)]
    lines = obs.lines
    if lines.shape[-3]:
        ax, ay = lines[..., 0, 0, None], lines[..., 0, 1, None]
        bx, by = lines[..., 1, 0, None], lines[..., 1, 1, None]
        d, g = _edges_min(*_seg_seg(E1, ax, ay, bx, by, rev=True), None)
        inside = _inside(ax, ay, *E1[:4], None)
        cols.append((torch.where(inside, 0.0, d), torch.where(inside[..., None], 0.0, g),
                     obs.line_mask))
    if obs.polygons.shape[-3]:
        ax, ay, bx, by, act = _slot_edges(obs)
        E2 = tuple(v[..., None, :, None] for v in E)  # (..., 1, Vf, 1)
        d, g = _seg_seg(E2, *(v[..., None, :] for v in (ax, ay, bx, by)))  # (..., Mg, Vf, V)
        flat = d.shape[:-2] + (-1,)
        act2 = act[..., None, :].expand(d.shape)
        d, g = _edges_min(d.reshape(flat), g.reshape(flat + (3,)), act2.reshape(flat))
        slot_in_fp = _inside(obs.polygons[..., 0, 0, None], obs.polygons[..., 0, 1, None],
                             *E1[:4], None)
        fp_in_slot = _inside(px[..., 0, None, None], py[..., 0, None, None], ax, ay, bx, by,
                             act)
        overlap = slot_in_fp | fp_in_slot
        cols.append((torch.where(overlap, 0.0, d), torch.where(overlap[..., None], 0.0, g),
                     obs.polygon_mask))
    return _rows(cols)


def _disc_rows(spec, x, obs):
    """The discs' distance to every slot and its pose gradient: each disc's
    distance is its center's minus its radius; two discs combine by their
    minimum with the 0.5 tie split (Pallas ``obs_terms``)."""
    centers, radii, cmask, _ = circle_slots(obs)
    lines = obs.lines
    d_all, g_all = [], []
    for px, py, r, dpx, dpy in _disc_centers(spec, x):
        qx, qy = px[..., None], py[..., None]
        ex, ey = qx - centers[..., 0], qy - centers[..., 1]
        dn = torch.sqrt(ex * ex + ey * ey + _EPS)
        rows = [(torch.where(cmask, dn - radii, BIG_DISTANCE), ex / dn, ey / dn)]
        if lines.shape[-3]:
            dl, lgx, lgy = _point_seg(
                qx, qy, lines[..., 0, 0], lines[..., 0, 1], lines[..., 1, 0], lines[..., 1, 1]
            )
            rows.append((torch.where(obs.line_mask, dl, BIG_DISTANCE), lgx, lgy))
        if obs.polygons.shape[-3]:
            dg, ggx, ggy = _polygon_rows(px, py, obs.polygons, obs.polygon_nv)
            rows.append((torch.where(obs.polygon_mask, dg, BIG_DISTANCE), ggx, ggy))
        d, gx, gy = (torch.cat(parts, dim=-1) for parts in zip(*rows))
        d = d - r
        d_all.append(d)
        g_all.append(torch.stack([gx, gy, gx * dpx[..., None] + gy * dpy[..., None]], dim=-1))
    d, grad = d_all[0], g_all[0]
    if len(d_all) == 2:
        w1, w2 = _sel_lt(d_all[0], d_all[1]), _sel_lt(d_all[1], d_all[0])
        d = torch.minimum(d_all[0], d_all[1])
        grad = w1[..., None] * g_all[0] + w2[..., None] * g_all[1]
    return d, grad


def obstacle_rows(spec, x, obs):
    """Obstacle rows at poses x (..., 3): g = min_dist − d (..., M), d the
    footprint's distance to each slot of ``obs`` (an ObstacleSet whose
    leaves broadcast against x's leading dims; BIG on a masked slot), in the
    order [points and circles, lines, polygons], and the pose gradient of g
    (..., M, 3), in closed form with JAX's subgradients. A family with no
    slot adds no row and no work."""
    fp = spec.footprint
    if isinstance(fp, LineFootprint):
        d, grad = _line_footprint_rows(fp, x, obs)
    elif isinstance(fp, PolygonFootprint):
        d, grad = _polygon_footprint_rows(fp, x, obs)
    else:
        d, grad = _disc_rows(spec, x, obs)
    return spec.min_obstacle_dist - d, -grad


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


def _quadratic_stage(spec, xk, uk, dt, xref, iw, hz, hu, Hzz, Hzu, Huu, dtp=None):
    """The quadratic form's stage terms, exact, added in place: l = lx + lu
    (plain) or (iw·lx + lu)·dt (integral), plus w·dt (hybrid), with
    lx = Σ q_i dx_i², dx = x_k ⊖ xref, and lu = Σ r_j u_j². On the
    non-uniform grid dt_k is control column 2 and the trapezoidal stage is
    ½(dt_{k-1} + dt_k)·lx + lu·dt_k, dt_{k-1} = ``dtp`` in z column 5 (Pallas
    ``stage_grad_hess``)."""
    dx = se2_boxminus(xk, xref)
    q, r = spec.q_diag, spec.r_diag
    if spec.nonuniform_dt:
        _quadratic_stage_nonu(spec, dx, uk, dt, dtp, hz, hu, Hzz, Hzu, Huu)
        return
    if spec.integral_form:
        x_term = sum(q[i] * dx[..., i] * dx[..., i] for i in range(3))
        u_term = sum(r[j] * uk[..., j] * uk[..., j] for j in range(2))
        hz[..., 5] += iw * x_term + u_term
        for i in range(3):
            qi = 2.0 * q[i] * iw * dx[..., i]
            hz[..., i] += qi * dt
            Hzz[..., i, i] += 2.0 * q[i] * iw * dt
            Hzz[..., i, 5] += qi
            Hzz[..., 5, i] = Hzz[..., i, 5]
        for j in range(2):
            rj = 2.0 * r[j] * uk[..., j]
            hu[..., j] += rj * dt
            Huu[..., j, j] += 2.0 * r[j] * dt
            Hzu[..., 5, j] += rj
    else:
        for i in range(3):
            hz[..., i] += 2.0 * q[i] * dx[..., i]
            Hzz[..., i, i] += 2.0 * q[i]
        for j in range(2):
            hu[..., j] += 2.0 * r[j] * uk[..., j]
            Huu[..., j, j] += 2.0 * r[j]
    if spec.hybrid_time_weight > 0.0:
        hz[..., 5] += spec.hybrid_time_weight


def _quadratic_stage_nonu(spec, dx, uk, dt, dtp, hz, hu, Hzz, Hzu, Huu):
    """``_quadratic_stage`` on the non-uniform grid: the dt terms on control
    column 2 (and, trapezoidal, the dt_{k-1} coupling on z column 5)."""
    q, r = spec.q_diag, spec.r_diag
    if spec.integral_form:
        x_term = sum(q[i] * dx[..., i] * dx[..., i] for i in range(3))
        u_term = sum(r[j] * uk[..., j] * uk[..., j] for j in range(2))
        trap = spec.cost_integration == "trapezoidal"
        wx = 0.5 * (dtp + dt) if trap else dt
        if trap:
            hz[..., 5] += 0.5 * x_term
            hu[..., 2] += 0.5 * x_term + u_term
        else:
            hu[..., 2] += x_term + u_term
        for i in range(3):
            qi = 2.0 * q[i] * dx[..., i]
            hz[..., i] += qi * wx
            Hzz[..., i, i] += 2.0 * q[i] * wx
            if trap:
                Hzz[..., i, 5] += 0.5 * qi
                Hzz[..., 5, i] = Hzz[..., i, 5]
                Hzu[..., i, 2] += 0.5 * qi
            else:
                Hzu[..., i, 2] += qi
        for j in range(2):
            rj = 2.0 * r[j] * uk[..., j]
            hu[..., j] += rj * dt
            Huu[..., j, j] += 2.0 * r[j] * dt
            Huu[..., j, 2] += rj
            Huu[..., 2, j] = Huu[..., j, 2]
    else:
        for i in range(3):
            hz[..., i] += 2.0 * q[i] * dx[..., i]
            Hzz[..., i, i] += 2.0 * q[i]
        for j in range(2):
            hu[..., j] += 2.0 * r[j] * uk[..., j]
            Huu[..., j, j] += 2.0 * r[j]
    if spec.hybrid_time_weight > 0.0:
        hu[..., 2] += spec.hybrid_time_weight


def via_rows(spec, x, via_pts, via_w, h, H):
    """The via attraction's exact gradient and (diagonal, PSD) Hessian on the
    pose x (..., 3), added in place: 2·pw·Σ_j w_j (x − v_j) and 2·pw·Σ_j w_j
    on x and y, and where the orientation weight ow > 0, 2·ow·Σ_j w_j
    wrap(θ − θ_j) and 2·ow·Σ_j w_j on θ (the wrap's derivative is 1).
    ``via_pts`` (..., Mv, 3) and the assignment weights ``via_w`` (..., Mv)
    broadcast against x's leading dims (Pallas ``via_rows``)."""
    pw, ow = spec.via_position_weight, spec.via_orientation_weight
    for i in range(2):
        h[..., i] += torch.sum(2.0 * pw * via_w * (x[..., i, None] - via_pts[..., i]), dim=-1)
        H[..., i, i] += torch.sum(2.0 * pw * via_w, dim=-1)
    if ow > 0.0:
        dth = angle_diff(x[..., 2, None], via_pts[..., 2])
        h[..., 2] += torch.sum(2.0 * ow * via_w * dth, dim=-1)
        H[..., 2, 2] += torch.sum(2.0 * ow * via_w, dim=-1)


def _obstacle_block(g, grad, t, on, rho, h, H):
    """The obstacle rows' part of an AL gradient and Gauss-Newton Hessian,
    added in place on the pose: a = max(0, t)·on, crisp weight ρ·on·[t > 0],
    h[:3] += Σ a ∇g, H[:3, :3] += Σ aw ∇g ∇gᵀ (symmetric)."""
    a = _hinge(t) * on
    aw = rho * on * (t > 0.0).to(g.dtype)
    for i in range(3):
        h[..., i] += torch.sum(a * grad[..., i], dim=-1)
        for j in range(i, 3):
            H[..., i, j] += torch.sum(aw * grad[..., i] * grad[..., j], dim=-1)
    for i in range(3):
        for j in range(i + 1, 3):
            H[..., j, i] = H[..., i, j]


def stage_grad_hess(spec, xk, uk, up, dt, mu_obs, on, mu_rate, mu_box, rho, obs,
                    xref=None, iw=None, via=None, dtp=None, mu_dt=None, dt_prox=0.0):
    """Exact AL gradient (hz (..., 6), hu (..., 2)) and hybrid Gauss-Newton
    Hessian blocks (Hzz, Hzu, Huu) of the stage merit over z = [x, u_prev,
    dt] and v = u. ``mu_obs`` (..., M) is the stage's multiplier row, ``on``
    zeroes the obstacle block at k = 0, ``obs`` the stage's obstacle set
    (dynamic obstacles predicted to its time); the quadratic form reads
    ``xref`` (..., 3) and the integration weight ``iw``; the via attraction
    ``via`` = (via points, assignment weights), as ``via_rows`` takes them;
    all leading dims are batch dims. On the non-uniform grid z = [x, u_prev,
    dt_prev] and v = [u, dt] (hu (..., 3), Hzu (..., 6, 3), Huu (..., 3, 3)):
    ``dtp`` is dt_{k-1} (0 at k = 0), ``mu_dt`` (..., 2) the interval's
    dt-box multipliers, ``dt_prox`` the δdt column's proximal weight."""
    nonu = spec.nonuniform_dt
    nv = 3 if nonu else 2
    lead, opts = dt.shape, dict(dtype=dt.dtype, device=dt.device)
    hz = torch.zeros(lead + (6,), **opts)
    hu = torch.zeros(lead + (nv,), **opts)
    Hzz = torch.zeros(lead + (6, 6), **opts)
    Hzu = torch.zeros(lead + (6, nv), **opts)
    Huu = torch.zeros(lead + (nv, nv), **opts)
    if spec.objective == "quadratic_form":
        _quadratic_stage(spec, xk, uk, dt, xref, iw, hz, hu, Hzz, Hzu, Huu, dtp)
    else:
        if nonu:
            hu[..., 2] = 1.0  # minimum time: the stage cost dt_k
        else:
            hz[..., 5] = 1.0  # minimum time: the stage cost dt
        if via is not None:
            via_rows(spec, xk, *via, hz, Hzz)

    # obstacles at x_k: crisp Gauss-Newton weight ρ·[μ + ρg > 0] on the pose
    g, grad = obstacle_rows(spec, xk, obs)
    r, onm = rho[..., None], on[..., None]
    _obstacle_block(g, grad, mu_obs * onm + r * g, onm, r, hz, Hzz)

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
        if nonu:  # the dt column is v[2]
            hu[..., 2] += ai * jz_t
            Hzu[..., zi, 2] += awi * jz_up * jz_t
            Huu[..., comp, 2] += awi * jv * jz_t
            Huu[..., 2, comp] = Huu[..., comp, 2]
            Huu[..., 2, 2] += awi * jz_t * jz_t
            continue
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
    if nonu:
        # the interval's dt box, exact; the δdt column's proximal damping
        t1 = mu_dt[..., 0] + rho * (dt - spec.dt_max)
        t2 = mu_dt[..., 1] + rho * (spec.dt_min - dt)
        hu[..., 2] += _hinge(t1) - _hinge(t2)
        Huu[..., 2, 2] += hinge_w(t1, rho) + hinge_w(t2, rho)
        if dt_prox > 0.0:
            Huu[..., 2, 2] += dt_prox
    return hz, hu, Hzz, Hzu, Huu


def terminal_Pp(spec, xN, dt, xf, lam_term, mu_obs, mu_dt, rho, obs, mu_ball=None, via=None):
    """PN (..., 6, 6) and pN (..., 6) of the terminal merit: the masked
    terminal equality, Qf, the via attraction of x_N (``via`` as
    ``stage_grad_hess`` takes it), the obstacle Gauss-Newton block on the
    pose at x_N (multiplier row N−1, ``obs`` predicted to its time), the
    ½·dt·lx(x_N) tail of the trapezoidal quadratic form, the terminal ball
    (exact PSD Hessian ρs²·g′g′ᵀ + a·2 diag(w), s the 0.5 tie subgradient)
    and the dt box on a variable uniform dt. On the non-uniform grid ``dt``
    is dt_{N-1} (z column 5) and the dt boxes are stage rows."""
    lead, opts = dt.shape, dict(dtype=dt.dtype, device=dt.device)
    P = torch.zeros(lead + (6, 6), **opts)
    p = torch.zeros(lead + (6,), **opts)
    gd = se2_boxminus(xN, xf)
    for i, fixed in enumerate(spec.xf_fixed):
        if fixed:
            P[..., i, i] = rho
            p[..., i] = lam_term[..., i] + rho * gd[..., i]
    if spec.qf_diag is not None:
        for i, qf in enumerate(spec.qf_diag):
            P[..., i, i] += 2.0 * qf
            p[..., i] += 2.0 * qf * gd[..., i]
    if via is not None:
        via_rows(spec, xN, *via, p, P)
    g, grad = obstacle_rows(spec, xN, obs)
    r = rho[..., None]
    _obstacle_block(g, grad, mu_obs + r * g, 1.0, r, p, P)
    if trapezoidal(spec):
        q = spec.q_diag
        p[..., 5] += 0.5 * sum(q[i] * gd[..., i] * gd[..., i] for i in range(3))
        for i in range(3):
            p[..., i] += q[i] * gd[..., i] * dt
            P[..., i, i] += q[i] * dt
            P[..., i, 5] += q[i] * gd[..., i]
            P[..., 5, i] = P[..., i, 5]
    if spec.ball_radius > 0.0:
        gb, gp = ball_g(spec, xN, xf)
        tb = mu_ball[..., 0] + rho * gb
        ab, hwb = _hinge(tb), hinge_w(tb, rho)
        for i, w in enumerate(spec.ball_weights):
            p[..., i] += ab * gp[..., i]
            P[..., i, i] += 2.0 * w * ab
            for j in range(3):
                P[..., i, j] += hwb * gp[..., i] * gp[..., j]
    if spec.variable_dt and not spec.nonuniform_dt:
        t1 = mu_dt[..., 0] + rho * (dt - spec.dt_max)
        t2 = mu_dt[..., 1] + rho * (spec.dt_min - dt)
        p[..., 5] += _hinge(t1) - _hinge(t2)
        P[..., 5, 5] += hinge_w(t1, rho) + hinge_w(t2, rho)
    return P, p


def ball_g(spec, xN, xf):
    """Terminal ball row g = ‖x_N ⊖ xf‖²_S − r² (..., ) and its pose gradient
    (..., 3)."""
    d = se2_boxminus(xN, xf)
    w = spec.ball_weights
    g = sum(w[i] * d[..., i] * d[..., i] for i in range(3)) - spec.ball_radius**2
    return g, torch.stack([2.0 * w[i] * d[..., i] for i in range(3)], dim=-1)


def fused_kkt_system(spec, primal: Primal, scenario, duals: DualState, obs_k,
                     dt_prox: float = 1.0):
    """The Riccati inputs (Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN) of one
    SQP iteration from the kernel's closed forms; the counterpart of the AD
    ``al_sqp._kkt_system`` (``dt_prox``: ``settings.dt_prox``, on the
    non-uniform grid). ``obs_k`` holds the per-stage obstacle sets
    (B, N+1, ...), ``al_sqp._stage_obstacles`` at the solve's initial dt."""
    N, M = spec.N, spec.obstacle_cap
    nonu = spec.nonuniform_dt
    xs, us, dt = primal.xs, primal.us, primal.dt
    B = dt.shape[0]
    dt_b = dt if nonu else dt[:, None].expand(B, N)
    _, F, G, m, r = defect_linearization(spec, xs[:, :-1], us, xs[:, 1:], dt_b)
    if not spec.variable_dt:
        m = torch.zeros_like(m)
    transition = build_augmented_transition_nonuniform if nonu else build_augmented_transition
    Fz, Gz, rz = transition(F, G, m, r, nu=spec.nu)
    up = torch.cat([scenario.u_prev[:, None], us[:, :-1]], dim=1)
    # obstacle multiplier rows: stage k uses mu_obs[k-1]; k = 0 inactive
    mu_obs = torch.cat([duals.mu_obs.new_zeros(B, 1, M), duals.mu_obs[:, : N - 1]], dim=1)
    on = torch.ones((B, N), dtype=dt.dtype, device=dt.device)
    on[:, 0] = 0.0
    iw = torch.ones((N,), dtype=dt.dtype, device=dt.device)
    if trapezoidal(spec):
        iw[0] = 0.5
    via_s = via_t = None
    if has_via(spec):
        # the stage assignment at the current iterate (Pallas via_sweep)
        w = _via_weights(spec, xs, scenario)  # (B, N+1, Mv)
        via_s = (scenario.via_points[:, None], w[:, :N])
        via_t = (scenario.via_points, w[:, N])
    nonu_kw = {}
    if nonu:  # dt_{k-1} (dt_{-1} = 0), the intervals' dt-box multipliers
        nonu_kw = dict(dtp=torch.cat([dt.new_zeros(B, 1), dt[:, :-1]], dim=1),
                       mu_dt=duals.mu_dt.reshape(B, N, 2), dt_prox=dt_prox)
    hz, hu, Hzz, Hzu, Huu = stage_grad_hess(
        spec, xs[:, :-1], us, up, dt_b, mu_obs, on, duals.mu_rate, duals.mu_box,
        duals.rho[:, None].expand(B, N), tree_map(lambda a: a[:, :N], obs_k),
        scenario.xf[:, None], iw, via_s, **nonu_kw,
    )
    PN, pN = terminal_Pp(
        spec, xs[:, N], dt[:, N - 1] if nonu else dt, scenario.xf, duals.lam_term,
        duals.mu_obs[:, N - 1], duals.mu_dt, duals.rho, tree_map(lambda a: a[:, N], obs_k),
        duals.mu_ball, via_t,
    )
    return tuple(a.contiguous() for a in (Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN))


def _check_scope(spec, settings, scenario):
    reason = _spec_scope_error(spec)
    if reason is None and not fused_obstacles_supported(scenario):
        reason = f"polygons of {scenario.obstacles.polygons.shape[-2]} padded vertices " \
                 f"(at most {MAX_V})"
    if reason is not None:
        raise NotImplementedError(
            f"the fused kernel does not take {reason}, nor does the TPU kernel "
            "(JAX fused_supported)"
        )


def fused_solve_plain(spec, settings, scenario, init: Primal, duals: DualState,
                      decisions=None, kkt_rounding=None) -> SolveResult:
    """The kernel's plain PyTorch version on any device: the whole warm solve
    with the kernel's closed-form derivatives and the plain ``lqr_solve``
    (``decisions``: as ``al_sqp.solve`` takes it; ``kkt_rounding``: applied
    to each iteration's KKT inputs, ``agreement.kkt_roundings``)."""
    _check_scope(spec, settings, scenario)
    # the derivatives predict dynamic obstacles at the initial dt, the merit
    # and the dual update (``solve``) at the trajectory's own dt
    obs_k = _stage_obstacles(spec, scenario, init.dt, spec.N + 1)

    def kkt_system(primal, duals):
        kkt = fused_kkt_system(spec, primal, scenario, duals, obs_k, settings.dt_prox)
        return kkt if kkt_rounding is None else kkt_rounding(kkt)

    plain = dataclasses.replace(settings, kkt="scan", fused="off")
    return solve(spec, plain, scenario, init, duals, kkt_system=kkt_system,
                 decisions=decisions, funcs=KernelFunctions(spec))


# --------------------------------------------------------------------------- #
# the kernel: build, bind, launch
# --------------------------------------------------------------------------- #
class _Params(ctypes.Structure):
    """``K2aParams`` of csrc/fused_al_sqp.cu, field for field."""

    _fields_ = [
        ("N", ctypes.c_int), ("M", ctypes.c_int), ("n_al", ctypes.c_int),
        ("n_sqp", ctypes.c_int), ("n_alpha", ctypes.c_int),
        ("xf_fixed", ctypes.c_int * 3),
        ("model", ctypes.c_int), ("quadratic", ctypes.c_int),
        ("integral", ctypes.c_int), ("trapezoidal", ctypes.c_int),
        ("has_qf", ctypes.c_int), ("variable_dt", ctypes.c_int),
        ("Mc", ctypes.c_int), ("Ml", ctypes.c_int), ("Mg", ctypes.c_int), ("V", ctypes.c_int),
        ("n_disc", ctypes.c_int), ("dynamic", ctypes.c_int),
        ("fp_kind", ctypes.c_int), ("fp_nv", ctypes.c_int),
        ("wheelbase", ctypes.c_double), ("bike_a", ctypes.c_double),
        ("bike_lr", ctypes.c_double), ("disc_off", ctypes.c_double * 2),
        ("disc_r", ctypes.c_double * 2), ("fp_v", ctypes.c_double * (2 * MAX_FP_V)),
        ("min_dist", ctypes.c_double),
        ("lo_u", ctypes.c_double * 2), ("hi_u", ctypes.c_double * 2),
        ("lo_r", ctypes.c_double * 2), ("hi_r", ctypes.c_double * 2),
        ("q", ctypes.c_double * 3), ("r", ctypes.c_double * 2),
        ("qf", ctypes.c_double * 3), ("hybrid", ctypes.c_double),
        ("ball_w", ctypes.c_double * 3), ("ball_r", ctypes.c_double),
        ("dt_min", ctypes.c_double), ("dt_max", ctypes.c_double),
        ("dt_lo", ctypes.c_double), ("dt_hi", ctypes.c_double),
        ("mv", ctypes.c_int), ("via_ordered", ctypes.c_int),
        ("via_pw", ctypes.c_double), ("via_ow", ctypes.c_double),
        ("dt_trust_frac", ctypes.c_double), ("rho_growth", ctypes.c_double),
        ("rho_max", ctypes.c_double),
        ("reg0", ctypes.c_double), ("reg_shrink", ctypes.c_double),
        ("reg_grow", ctypes.c_double), ("reg_min", ctypes.c_double),
        ("reg_max", ctypes.c_double),
        ("viol_decrease_req", ctypes.c_double), ("tol_eq", ctypes.c_double),
        ("tol_ineq", ctypes.c_double),
        ("nonu", ctypes.c_int), ("dt_ref", ctypes.c_double), ("dt_prox", ctypes.c_double),
        ("colloc", ctypes.c_int), ("rk_stages", ctypes.c_int), ("rk_substeps", ctypes.c_int),
        ("rk_a", ctypes.c_double * (MAX_RK * MAX_RK)), ("rk_b", ctypes.c_double * MAX_RK),
    ]


def _params(spec, settings, obstacles) -> _Params:
    """The kernel's ``K2aParams`` for a launch on ``obstacles``."""
    lo_u, hi_u = (b.tolist() for b in spec.control_box())
    lo_r, hi_r = _rate_bounds(spec)
    d2, d3 = ctypes.c_double * 2, ctypes.c_double * 3
    model = spec.model
    bicycle = type(model) is KinematicBicycleModelVelocityInput
    dt_lo, dt_hi = dt_clip(spec)
    fp = spec.footprint
    kind = FOOTPRINT_KINDS[type(fp)]
    discs = disc_footprint(fp) if kind == 0 else ((0.0, 0.0),)
    pad = list(discs) + [(0.0, 0.0)] * (2 - len(discs))
    points = {1: lambda: (fp.line_start, fp.line_end), 2: lambda: fp.vertices}.get(
        kind, lambda: ())()
    fp_v = [c for v in points for c in v]
    o = obstacles
    rule = colloc_id(spec)
    rk_a, rk_b, stages, substeps = [0.0] * (MAX_RK * MAX_RK), [0.0] * MAX_RK, 0, 1
    if rule == SHOOTING:  # the tableau, row s holding stage s's a entries
        a_rows, b, substeps = shooting_tableau(spec)
        stages = len(b)
        for i, row in enumerate(a_rows):
            rk_a[(i + 1) * MAX_RK : (i + 1) * MAX_RK + len(row)] = row
        rk_b[: len(b)] = b
    return _Params(
        N=spec.N, M=spec.obstacle_cap, n_al=settings.n_al, n_sqp=settings.n_sqp,
        n_alpha=len(settings.alphas), xf_fixed=(ctypes.c_int * 3)(*(int(b) for b in spec.xf_fixed)),
        model=MODEL_IDS[type(model)], quadratic=int(spec.objective == "quadratic_form"),
        integral=int(spec.integral_form), trapezoidal=int(trapezoidal(spec)),
        has_qf=int(spec.qf_diag is not None), variable_dt=int(spec.variable_dt),
        Mc=o.points.shape[-2] + o.circles.shape[-2], Ml=o.lines.shape[-3],
        Mg=o.polygons.shape[-3], V=o.polygons.shape[-2], n_disc=len(discs),
        dynamic=int(spec.enable_dynamic_obstacles), fp_kind=kind, fp_nv=len(points),
        wheelbase=getattr(model, "wheelbase", 0.0),
        bike_a=_bicycle_a(model) if bicycle else 0.0,
        bike_lr=model.lr if bicycle else 0.0,
        disc_off=d2(*(o for o, _ in pad)), disc_r=d2(*(r for _, r in pad)),
        fp_v=(ctypes.c_double * (2 * MAX_FP_V))(*fp_v),
        min_dist=spec.min_obstacle_dist,
        lo_u=d2(*lo_u), hi_u=d2(*hi_u), lo_r=d2(*lo_r), hi_r=d2(*hi_r),
        q=d3(*spec.q_diag), r=d2(*spec.r_diag), qf=d3(*(spec.qf_diag or (0.0,) * 3)),
        hybrid=spec.hybrid_time_weight, ball_w=d3(*spec.ball_weights),
        ball_r=spec.ball_radius,
        dt_min=spec.dt_min, dt_max=spec.dt_max, dt_lo=dt_lo, dt_hi=dt_hi,
        mv=spec.via_cap if has_via(spec) else 0, via_ordered=int(spec.via_points_ordered),
        via_pw=spec.via_position_weight, via_ow=spec.via_orientation_weight,
        dt_trust_frac=settings.dt_trust_frac, rho_growth=settings.rho_growth,
        rho_max=settings.rho_max, reg0=settings.reg0, reg_shrink=settings.reg_shrink,
        reg_grow=settings.reg_grow, reg_min=settings.reg_min, reg_max=settings.reg_max,
        viol_decrease_req=settings.viol_decrease_req, tol_eq=settings.tol_eq,
        tol_ineq=settings.tol_ineq,
        nonu=int(spec.nonuniform_dt), dt_ref=spec.dt_ref,
        dt_prox=settings.dt_prox if spec.nonuniform_dt else 0.0,
        colloc=rule, rk_stages=stages, rk_substeps=substeps,
        rk_a=(ctypes.c_double * (MAX_RK * MAX_RK))(*rk_a), rk_b=(ctypes.c_double * MAX_RK)(*rk_b),
    )


# the GEO instantiations a launch runs (csrc/fused_al_sqp.cu GeoParts,
# launch_as)
GEO_NONE, GEO_SLOTS, GEO_ALL, GEO_FP_LINE, GEO_FP_POLYGON = 0, 14, 15, 16, 32


def launched_geo(params: _Params) -> int:
    """The ``GEO`` instantiation the kernel launches for ``params``: a segment
    footprint with every slot family, a polygon footprint with static point
    and circle slots or with every family, one disc at the pose with static
    point and circle slots, or the disc geometry read at run time."""
    plain = params.Ml == 0 and params.Mg == 0 and params.dynamic == 0
    if params.fp_kind == 1:
        return GEO_FP_LINE | GEO_SLOTS
    if params.fp_kind == 2:
        return GEO_FP_POLYGON if plain else GEO_FP_POLYGON | GEO_SLOTS
    if plain and params.n_disc == 1 and params.disc_off[0] == 0.0:
        return GEO_NONE
    return GEO_ALL


class Group(NamedTuple):
    """The template arguments one library of the kernel holds (its five
    ``GEO`` instantiations): the working type, the model (``MODEL_IDS``),
    the objective family (``OBJ_IDS``), the grid and the collocation family
    (``COLLOC_FAMILY``)."""

    double: bool
    model: int
    obj: int
    nonu: bool
    colloc: int

    def defines(self):
        return (f"K2A_DOUBLE={int(self.double)}", f"K2A_MODEL={self.model}",
                f"K2A_OBJ={self.obj}", f"K2A_NONU={int(self.nonu)}",
                f"K2A_COLLOC={self.colloc}")

    def code(self) -> int:
        """``k2a_group()`` of the library built for this group."""
        return (((int(self.double) * 10 + self.model) * 10 + self.obj) * 10
                + int(self.nonu)) * 10 + self.colloc


# the kernel's objective template parameter (csrc/fused_al_sqp.cu Objective)
OBJ_IDS = {"minimum_time": 0, "quadratic_form": 1, "minimum_time_via_points": 2}
GROUPS = tuple(Group(d, m, o, n, c) for c in sorted(set(COLLOC_FAMILY.values()))
               for n in (False, True) for d in (False, True)
               for m in sorted(set(MODEL_IDS.values())) for o in sorted(OBJ_IDS.values()))


# a team's working state in the kernel's order (csrc/fused_al_sqp.cu Arr):
# each array's values at (N, M), on the non-uniform grid, for a team of
# ``team`` lanes, and whether it has an output tensor to live in where it
# does not fit in shared memory (else it goes to the workspace)
def _arrays(N, M, nonu, team):
    nv = 3 if nonu else 2
    d = N if nonu else 0
    slot = (2 * 36 + 2 * 6 + 2 * 6 * nv + nv * nv + nv) | 1  # a chunk slot: Fz .. hu
    return (
        ((N + 1) * 3, True), (N * 2, True), (d, True),               # xs, us, dts
        (team * slot, False), (N * (nv * 6 + nv), False),            # chunk, gain tape
        ((N + 1) * 3, False), (N * 2, False), (d, False),            # the step
        (N * 3, True), (N * 4, True), (N * 4, True),                 # lam_def, mu_rate, mu_box
        (2 * N if nonu else 2, True), (N * M, True),                 # mu_dt, mu_obs
        ((N + 1) * 3, False), (N * 2, False), (d, False),            # the snapshot
        (N + 1 if nonu else 0, False),                               # prediction times
    )


class LaunchGeometry(NamedTuple):
    """A launch's shape: the lanes of a team, the teams of a block, the
    block's dynamic shared bytes and the workspace's values per scenario."""

    team: int
    teams_per_block: int
    shared_bytes: int
    workspace: int


def launch_geometry(g: Group, N: int, M: int, team: int = TEAM) -> LaunchGeometry:
    """The kernel's launch shape for group ``g`` at N stages and M slots
    (``k2a_launch_geometry`` of its library, computed here without it): the
    arrays claim the team's shared budget in order, and an array that does
    not fit lives in its output tensor or in the workspace."""
    tsize = 8 if g.double else 4
    teams = BLOCK // team
    budget = min(SMEM_TEAM_F32 * tsize // 4, SMEM_BLOCK // teams)
    used, ws = SCRATCH, 0
    for n, has_output in _arrays(N, M, g.nonu, team):
        if VKS_BYTES + (used + n) * tsize <= budget:
            used += n
        elif not has_output:
            ws += n
    return LaunchGeometry(team, teams, teams * ((VKS_BYTES + used * tsize + 15) // 16 * 16), ws)


def group(spec, dtype) -> Group:
    """The library group that launches ``spec`` in ``dtype``: its model, its
    objective family (via points only where it has some, as ``_params``
    passes them), its grid and its collocation family."""
    obj = OBJ_IDS["quadratic_form"] if spec.objective == "quadratic_form" else (
        OBJ_IDS["minimum_time_via_points"] if has_via(spec) else OBJ_IDS["minimum_time"])
    return Group(dtype == torch.float64, MODEL_IDS[type(spec.model)], obj,
                 bool(spec.nonuniform_dt), COLLOC_FAMILY[colloc_id(spec)])


def library_path(g: Group):
    """The library of one group, built from the one source with the group's
    macros, under a name of its own."""
    variant = (f"_{'f64' if g.double else 'f32'}_m{g.model}_o{g.obj}"
               f"{'_nonu' if g.nonu else ''}{f'_c{g.colloc}' if g.colloc else ''}")
    return nvcc_build.library_path(SOURCE, variant)


def build(groups=GROUPS) -> list:
    """Compile the library of each group in ``groups`` that is missing, all
    at once (one nvcc each, at most 16 at a time; ``nvcc_build``). Returns
    each build's report."""
    def one(g):
        return nvcc_build.build_library(SOURCE, library_path(g), g.defines())

    with ThreadPoolExecutor(max_workers=min(len(groups), 16)) as pool:
        return list(pool.map(one, groups))


def bind(path, g: Group):
    """Load the built fused-kernel library of group ``g`` and declare its C
    entry points."""
    lib = ctypes.CDLL(str(path))
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.k2a_fused_solve.argtypes = [ctypes.POINTER(_Params), ptrs, ptrs, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_void_p]
    lib.k2a_fused_solve.restype = ctypes.c_int
    names = ("k2a_max_v", "k2a_max_fp_v", "k2a_max_via", "k2a_params_size", "k2a_group")
    for name in names:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.k2a_launch_geometry.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.k2a_launch_geometry.restype = None
    lib.k2a_occupancy.argtypes = [ctypes.POINTER(_Params), ctypes.POINTER(ctypes.c_int)]
    lib.k2a_occupancy.restype = ctypes.c_int
    lib.k2a_error_string.argtypes = [ctypes.c_int]
    lib.k2a_error_string.restype = ctypes.c_char_p
    limits = tuple(getattr(lib, name)() for name in names)
    if limits != (MAX_V, MAX_FP_V, MAX_VIA, ctypes.sizeof(_Params), g.code()):
        raise RuntimeError(f"fused-kernel library {path} does not match its wrapper: {limits}")
    lib.k2a_team = library_geometry(lib, 1, 0).team
    return lib


def library_geometry(lib, N: int, M: int) -> LaunchGeometry:
    """``k2a_launch_geometry`` of a bound library at N stages and M slots."""
    out = (ctypes.c_int * 4)()
    lib.k2a_launch_geometry(N, M, out)
    return LaunchGeometry(*out)


def occupancy(lib, spec, settings, obstacles) -> int:
    """The blocks per SM of the instantiation a launch of ``spec`` on
    ``obstacles`` runs, at its shared bytes (the CUDA occupancy
    calculator)."""
    blocks = ctypes.c_int()
    rc = lib.k2a_occupancy(ctypes.byref(_params(spec, settings, obstacles)), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"fused kernel occupancy failed: {lib.k2a_error_string(rc).decode()}")
    return blocks.value


def _load(g: Group):
    if g not in _libs:
        build((g,))
        _libs[g] = bind(library_path(g), g)
    return _libs[g]


_IN_NAMES = (
    "xs", "us", "dt", "xf", "u_prev", "centers", "radii", "circle_mask", "circle_vels",
    "lines", "line_vels", "line_mask", "polygons", "polygon_nv", "polygon_vels",
    "polygon_mask", "lam_def", "lam_term", "mu_obs", "mu_rate", "mu_box", "mu_dt",
    "mu_ball", "rho", "via_points", "via_mask",
)
_NOT_FLOAT = {"circle_mask": torch.bool, "line_mask": torch.bool, "polygon_nv": torch.int32,
              "polygon_mask": torch.bool, "via_mask": torch.bool}


def kernel_io(spec, scenario, init: Primal, duals: DualState):
    """The kernel's 26 inputs (checked: one device, float32 or float64, the
    masks bool and the vertex counts int32, contiguous, the expected shapes,
    slot families adding up to the spec's M) and its 15 freshly allocated
    outputs. The obstacle inputs are the point and circle slots as one
    family (``circle_slots``), then the line and the polygon slots, each
    with its velocities; the via points and their mask come last. On the
    non-uniform grid dt is (B, N) and mu_dt (B, 2N), the kernel's (B, N, 2)
    of [hi, lo] rows per interval, in and out."""
    xs = init.xs
    dev, dtype = xs.device, xs.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the fused kernel takes float32 or float64, got {dtype}")
    B, N, M = xs.shape[0], spec.N, spec.obstacle_cap
    if B == 0:
        raise ValueError("the fused kernel needs a non-empty batch")
    o = scenario.obstacles
    centers, radii, cmask, cvels = circle_slots(o)
    Mc, Ml, Mg, V = centers.shape[-2], o.lines.shape[-3], o.polygons.shape[-3], o.polygons.shape[-2]
    if Mc + Ml + Mg != M:
        raise ValueError(f"fused kernel: {Mc}+{Ml}+{Mg} obstacle slots, the spec has M={M}")
    ins = (
        xs, init.us, init.dt, scenario.xf, scenario.u_prev, centers, radii, cmask, cvels,
        o.lines, o.line_vels, o.line_mask, o.polygons, o.polygon_nv, o.polygon_vels,
        o.polygon_mask, duals.lam_def, duals.lam_term, duals.mu_obs, duals.mu_rate,
        duals.mu_box, duals.mu_dt, duals.mu_ball, duals.rho, scenario.via_points,
        scenario.via_mask,
    )
    Mv = spec.via_cap
    dt_shape, md_shape = ((B, N), (B, 2 * N)) if spec.nonuniform_dt else ((B,), (B, 2))
    shapes = (
        (B, N + 1, 3), (B, N, 2), dt_shape, (B, 3), (B, 2), (B, Mc, 2), (B, Mc), (B, Mc),
        (B, Mc, 2), (B, Ml, 2, 2), (B, Ml, 2), (B, Ml), (B, Mg, V, 2), (B, Mg), (B, Mg, 2),
        (B, Mg), (B, N, 3), (B, 3), (B, N, M), (B, N, 4), (B, N, 4), md_shape, (B, 1), (B,),
        (B, Mv, 3), (B, Mv),
    )
    for name, a, shape in zip(_IN_NAMES, ins, shapes):
        want = _NOT_FLOAT.get(name, dtype)
        if a.device != dev:
            raise ValueError(f"fused kernel: {name} is on {a.device}, xs on {dev}")
        if a.dtype != want:
            raise TypeError(f"fused kernel: {name} is {a.dtype}, expected {want}")
        if tuple(a.shape) != shape:
            raise ValueError(f"fused kernel: {name} has shape {tuple(a.shape)}, expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"fused kernel: {name} is not contiguous")
    # xs, us, dt, the 8 dual fields, cost, eq_norm, ineq_viol; converged
    out_shapes = shapes[:3] + shapes[16:24] + ((B,),) * 3
    outs = tuple(torch.empty(s, dtype=dtype, device=dev) for s in out_shapes)
    return ins, outs + (torch.empty((B,), dtype=torch.bool, device=dev),)


def launch(lib, spec, settings, ins, outs, stream, obstacles) -> None:
    """Run the kernel on ``ins`` into ``outs`` on ``stream``, with the
    line-search candidates as a device input in the working type and a
    fresh workspace for what of each team's working state does not fit in
    its shared memory (``launch_geometry``: values per scenario,
    scenario-major, for the team size of ``lib``); raises on a refused
    launch."""
    params = _params(spec, settings, obstacles)
    xs = ins[0]
    B = xs.shape[0]
    alphas = const(tuple(float(a) for a in settings.alphas), xs)  # cached on the device
    geo = launch_geometry(group(spec, xs.dtype), spec.N, spec.obstacle_cap, lib.k2a_team)
    ws = torch.empty((B, max(geo.workspace, 1)), dtype=xs.dtype, device=xs.device)
    in_ptrs = (ctypes.c_void_p * (len(ins) + 1))(*(a.data_ptr() for a in ins + (alphas,)))
    out_ptrs = (ctypes.c_void_p * len(outs))(*(a.data_ptr() for a in outs))
    rc = lib.k2a_fused_solve(ctypes.byref(params), in_ptrs, out_ptrs, ws.data_ptr(), B, stream)
    if rc != 0:
        raise RuntimeError(f"fused kernel launch failed: {lib.k2a_error_string(rc).decode()} ({rc})")


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
    """Launch the fused kernel on CUDA tensors with one leading lane axis: the whole
    n_al × n_sqp warm solve, the same ``SolveResult`` as ``al_sqp.solve``."""
    _check_scope(spec, settings, scenario)
    if init.xs.device.type != "cuda":
        raise ValueError(f"the fused kernel runs on CUDA tensors, got {init.xs.device}")
    ins, outs = kernel_io(spec, scenario, init, duals)
    g = group(spec, init.xs.dtype)
    lib = _load(g)
    dev = init.xs.device
    with torch.cuda.device(dev):
        launch(lib, spec, settings, ins, outs, torch.cuda.current_stream(dev).cuda_stream,
               scenario.obstacles)
    fused_solve_cuda.launches += 1
    fused_solve_cuda.launches_by_rule[spec.collocation] += 1
    fused_solve_cuda.launches_by_group[g] += 1
    return result_of(outs)


fused_solve_cuda.launches = 0
fused_solve_cuda.launches_by_rule = collections.Counter()  # by spec.collocation
fused_solve_cuda.launches_by_group = collections.Counter()  # by group(spec, dtype)


# --------------------------------------------------------------------------- #
# the work of one launch, for the bound
# --------------------------------------------------------------------------- #
# The structure of one stage's step inputs for a spec: "0" and "1" are the
# same constant at every stage and iterate, "v" varies. Fz, Gz and rz are the
# augmented transition (F = I + dt Jx with Jx's θ column only, G = dt Ju,
# the dt column m = f only on a variable dt; under the midpoint and
# Crank–Nicolson fold and on a shooting grid F keeps that structure and G
# its row 2's, rows 0-1 live in both columns); Hzz, Hzu, Huu, hz and hu are
# ``stage_grad_hess``'s blocks (obstacles on x, y and, where a footprint disc
# sits off the pose or the footprint is a segment or a polygon, θ; the
# quadratic form on x, u and, integral, dt; the via attraction on the x and
# y diagonal and, with an orientation weight, θ's; rate rows on u_prev, dt
# and u; box rows on u). On the non-uniform grid the control is [u, dt_k]:
# Fz = [[F, 0, 0], [0]], Gz = [[G | m], [I3]], the dt terms in the control
# column 2 and, under the trapezoidal rule, dt_{k-1} in z column 5.
# tests/test_torch_fused.py, tests/test_torch_quadratic.py and
# tests/test_torch_nonuniform.py hold them against the plain version's
# tensors.
def step_structure(spec) -> dict:
    model = type(spec.model)
    m = "v" if spec.variable_dt else "0"
    # Gz[0:2, 1]: dt Ju's, zero for the unicycle and the simple car, until
    # the −E⁻¹ fold or a shooting step past its first evaluation brings in
    # G's row 2
    rule = colloc_id(spec)
    one_eval = rule == SHOOTING and len(shooting_tableau(spec)[1]) * shooting_tableau(spec)[2] == 1
    coupled = rule in (1, 2) or (rule == SHOOTING and not one_eval)
    g01 = "0" if model in (UnicycleModel, SimpleCarModel) and not coupled else "v"
    g20 = "0" if model is UnicycleModel else "v"                    # Gz[2, 0]
    quad = spec.objective == "quadratic_form"
    integ = "v" if quad and spec.integral_form else "0"
    obs = "v" if spec.obstacle_cap else "0"
    rot = spec.obstacle_cap and (
        FOOTPRINT_KINDS[type(spec.footprint)] != 0
        or any(off != 0.0 for off, _ in disc_footprint(spec.footprint)))
    o_th = "v" if rot else "0"
    via = has_via(spec)
    xy = "v" if spec.obstacle_cap or quad or via else "0"
    th = "v" if quad or rot or (via and spec.via_orientation_weight > 0.0) else "0"
    if spec.nonuniform_dt:
        tr = "v" if quad and spec.integral_form and spec.cost_integration == "trapezoidal" \
            else "0"
        return {
            "Fz": ("1 0 v 0 0 0", "0 1 v 0 0 0", "0 0 1 0 0 0") + ("0 0 0 0 0 0",) * 3,
            "Gz": (f"v {g01} v", f"v {g01} v", f"{g20} v v", "1 0 0", "0 1 0", "0 0 1"),
            "rz": ("v v v 0 0 0",),
            "Hzz": (f"{xy} {obs} {o_th} 0 0 {tr}", f"{obs} {xy} {o_th} 0 0 {tr}",
                    f"{o_th} {o_th} {th} 0 0 {tr}", "0 0 0 v 0 0", "0 0 0 0 v 0",
                    f"{tr} {tr} {tr} 0 0 0"),
            "Hzu": (f"0 0 {integ}",) * 3 + ("v 0 v", "0 v v", "0 0 0"),
            "Huu": ("v 0 v", "0 v v", "v v v"),
            "hz": (f"{xy} {xy} {th} v v {tr}",),
            "hu": ("v v v",),
        }
    return {
        "Fz": (f"1 0 v 0 0 {m}", f"0 1 v 0 0 {m}", f"0 0 1 0 0 {m}", "0 0 0 0 0 0",
               "0 0 0 0 0 0", "0 0 0 0 0 1"),
        "Gz": (f"v {g01}", f"v {g01}", f"{g20} v", "1 0", "0 1", "0 0"),
        "rz": ("v v v 0 0 0",),
        "Hzz": (f"{xy} {obs} {o_th} 0 0 {integ}", f"{obs} {xy} {o_th} 0 0 {integ}",
                f"{o_th} {o_th} {th} 0 0 {integ}", "0 0 0 v 0 v", "0 0 0 0 v v",
                f"{integ} {integ} {integ} v v v"),
        "Hzu": ("0 0", "0 0", "0 0", "v 0", "0 v", "v v"),
        "Huu": ("v 0", "0 v"),
        "hz": (f"{xy} {xy} {th} v v v",),
        "hu": ("v v",),
    }


def structure_rows(rows):
    """One block of ``step_structure`` as rows of 0.0, 1.0 or None (varies)."""
    return [[{"0": 0.0, "1": 1.0, "v": None}[t] for t in row.split()] for row in rows]


def step_flops(structure) -> tuple[int, int]:
    """Operations of one stage of the Riccati step and of one stage of the
    rollout on a ``step_structure``: a product or sum with a structural 0
    or 1 folds away, as the TPU kernel folds it when it is traced; every
    other product and sum counts 1. P is dense after the first stage and
    counted dense; each entry of the symmetrized P is formed once. Quu is
    2×2, or 3×3 on the non-uniform grid (the adjugate over the
    determinant)."""
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

    S = {name: structure_rows(rows) for name, rows in structure.items()}
    Fz, Gz, rz, Hzz, Hzu, Huu = (S[k] for k in ("Fz", "Gz", "rz", "Hzz", "Hzu", "Huu"))
    hz, hu, rz = S["hz"][0], S["hu"][0], rz[0]
    nv = len(hu)
    P, p, var_inv = [[None] * 6 for _ in range(6)], [None] * 6, [[None] * nv for _ in range(nv)]
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
    # 2x2 inverse: det (3), 1/det, four scaled entries; 3x3: nine cofactors
    # (3 each), det (5), 1/det, nine scaled entries
    count += 8 if nv == 2 else 42
    K = [[dot(qi, row) for row in Qzu] for qi in var_inv]  # negation is free
    kf = [dot(qi, qu) for qi in var_inv]
    v = [[add(Qzz[i][j], dot(Qzu[i], [K[l][j] for l in range(nv)])) for j in range(6)]
         for i in range(6)]
    for i in range(6):
        for j in range(i, 6):
            mul(0.5, add(v[i][j], v[j][i]))
        add(qz[i], dot(Qzu[i], kf))
    riccati, count = count, 0
    z = [None] * 6  # rollout: u = K z + kff, z' = Fz z + Gz u + rz
    u = [add(dot(row, z), None) for row in [[None] * 6] * nv]
    for frow, grow, r in zip(Fz, Gz, rz):
        add(add(dot(frow, z), dot(grow, u)), r)
    return riccati, count


# Operations of the closed forms, counted from csrc/fused_al_sqp.cu as
# ``k2a_flops`` counts them. f: the model's f alone (the merit's defect);
# dyn: f, Jx and Ju (cos, sin, tan, atan 1 each); G: the varying entries of
# dt·Ju; G fold: the −E⁻¹ fold's (P, Q) times G's row 2 into rows 0-1
# (``linearize``); RK tangent: one tableau stage's tangent (rows 0-1: jx_i
# times the θ row, plus Ju); RK axpy: one nonzero tableau entry's y +=
# (c h) k with its tangent (c h once, the value 6, rows 0-1 20, row 2 at
# Ju's nonzero row-2 entries and dt).
_MODEL_FLOPS = {  # model: (f, dyn, G, G fold, RK tangent, RK axpy)
    UnicycleModel: (4, 4, 2, 2, 8, 31),
    SimpleCarModel: (7, 12, 4, 6, 8, 33),
    SimpleCarFrontWheelDrivingModel: (9, 15, 6, 8, 10, 33),
    KinematicBicycleModelVelocityInput: (11, 23, 6, 8, 10, 33),
}
# the defect's value: three x + dt f − x' and the θ wrap (13); the midpoint
# state (15: x and y 2 each, θ two wraps, a difference, a half and a sum);
# Crank–Nicolson's average of f (6); the fold: dt/2, P and Q, F's θ column
# (4), m and r (4 each) beside G's; a shooting grid's value Φ − x' (7) and
# a nonzero entry's value update ((c h) and y += (c h) k, 7)
_DEFECT, _MIDPOINT_X, _CN_AVG, _FOLD, _SHOOT_C, _RK_AXPY_VALUE = 13, 15, 6, 15, 7, 7


def _defect_flops(spec) -> tuple[int, int]:
    """(the defect's value, its linearization) operations per stage of the
    grid under ``spec``'s rule, counted from csrc/fused_al_sqp.cu
    (``defect_value``, ``transition``) on the structure: forward
    differences f or dyn, the defect and F = I + dt Jx (2); midpoint and
    Crank–Nicolson their f (at the midpoint state, or averaged over both
    ends with Ju) and the fold; a shooting grid stages × substeps of f or of
    dyn with its tangent (the first stage's tangent is Ju alone) and a
    value or tangent update per nonzero tableau entry, h = dt / substeps."""
    f_ops, dyn_ops, g_ops, g_fold, rk_tangent, rk_axpy = _MODEL_FLOPS[type(spec.model)]
    rule = colloc_id(spec)
    if rule == 0:
        return f_ops + _DEFECT, dyn_ops + _DEFECT + 2 + g_ops
    if rule == 1:
        fold = _MIDPOINT_X + dyn_ops + _DEFECT + _FOLD + g_ops + g_fold
        return _MIDPOINT_X + f_ops + _DEFECT, fold
    if rule == 2:
        fold = 2 * dyn_ops + _CN_AVG + 2 * g_ops + _DEFECT + _FOLD + g_ops + g_fold
        return 2 * f_ops + _CN_AVG + _DEFECT, fold
    a_rows, b, substeps = shooting_tableau(spec)
    entries = sum(c != 0.0 for row in a_rows for c in row) + sum(c != 0.0 for c in b)
    stages = len(b)
    h = int(substeps > 1)
    value = h + substeps * (stages * f_ops + entries * _RK_AXPY_VALUE) + _SHOOT_C
    walk = substeps * (stages * (dyn_ops + rk_tangent) + entries * rk_axpy) - rk_tangent
    return value, h + walk + _SHOOT_C
_GOAL_DX = 6     # x ⊖ xf: three differences and the θ wrap
_QUAD_FORM = 8   # Σ q_i d_i² (and 5 for Σ r_j u_j²)
# The via points, counted from csrc/fused_al_sqp.cu (``via_sweep``,
# ``via_rows``): per slot and stage of a sweep the squared distance (two
# differences and the sum of squares, 5); per active slot of a cost the
# weighted distance and its sum (2) and, with an orientation weight, the
# weighted wrapped error (7); per active slot of the derivatives the x and y
# rows and their diagonal (8) and θ's (7). A candidate's poses are the
# merit's (``merit_stage`` counts them), and the assignment at the top of an
# iteration is the α = 0 candidate's: each is counted once.
_VIA_D2, _VIA_COST, _VIA_COST_TH = 5, 2, 7
_VIA_ROWS, _VIA_ROWS_TH = 8, 7


def _via_flops(spec, n_alpha, via_mask):
    """(per SQP iteration, at the end) operations of the via points: the
    assignment and cost at the current states and at each candidate, the
    rows, the final cost. Active slots are this run's mean over the lanes of
    ``via_mask`` (every slot without it)."""
    if not has_via(spec):
        return 0.0, 0.0
    mv, stages = spec.via_cap, spec.N + 1
    active = float(via_mask.double().sum(dim=-1).mean()) if via_mask is not None else mv
    th = spec.via_orientation_weight > 0.0
    sweep = mv * stages * _VIA_D2
    cost = active * (_VIA_COST + _VIA_COST_TH * th)
    per_iter = active * (_VIA_ROWS + _VIA_ROWS_TH * th) + (n_alpha + 1) * (sweep + cost)
    return per_iter, sweep + cost


def _geometry_flops(spec, obstacles):
    """Operations of the obstacle rows at one pose, counted from
    csrc/fused_al_sqp.cu: (value only, value and pose gradient, the AL
    terms of one slot in the derivatives). Per slot and disc: a point or
    circle slot 9 (the gradient 4 more), a line slot 21 (11), a polygon slot
    26 per active edge and 2 (13 per active edge and 4), the θ chain of a
    disc off the pose 3; per slot g = min_dist − d 1, the minimum of two
    discs' gradients 9, the dynamic shift 4 (point, circle), 6 (line) or
    2 + 2 per vertex (polygon); per pose the prediction time 1 and, with a
    disc off the pose, cos, sin and 6 per such disc. The AL terms are 16
    per slot on the (x, y) block, 27 on the 3×3 pose block. Polygon edges
    are this run's mean active count over the lanes of ``obstacles``. A
    segment or polygon footprint: ``_footprint_flops``."""
    if obstacles is None:
        mc, ml, mg, edges = spec.obstacle_cap, 0, 0, 0.0
    else:
        o = obstacles
        mc = o.points.shape[-2] + o.circles.shape[-2]
        ml, mg = o.lines.shape[-3], o.polygons.shape[-3]
        edges = float(o.polygon_nv.double().sum(dim=-1).mean()) if mg else 0.0
    m = mc + ml + mg
    dynamic = (4 * mc + 6 * ml + 2 * mg + 2 * edges + 1) * spec.enable_dynamic_obstacles
    if FOOTPRINT_KINDS[type(spec.footprint)] != 0:
        value, grad = _footprint_flops(spec.footprint, mc, ml, mg, edges)
        return value + m + dynamic, value + m + dynamic + grad, 27
    discs = disc_footprint(spec.footprint)
    nd, n_off = len(discs), sum(off != 0.0 for off, _ in discs)
    value = (9 * mc + 21 * ml + 2 * mg) * nd + 26 * edges * nd + m + dynamic
    if n_off and m:
        value += 2 + 6 * n_off
    grad = (4 * mc + 11 * ml + 4 * mg) * nd + 13 * edges * nd + 3 * m * n_off
    grad += 9 * m * (nd == 2)
    al = 27 if n_off else 16
    return value, value + grad, al


# Operations of the segment and polygon footprints' chains in
# csrc/fused_al_sqp.cu, as the function needs them (value, pose gradient):
# whatever one pose shares among its slots and edges is counted once.
# Per pose: cos and sin; each world vertex of the footprint (8; its θ
# derivative 2 more in the gradient); each footprint edge's constants
# (b − a and |b − a|², 5; their θ terms 9). Per point and segment whose
# constants are known: the distance (15; its gradient 12 where the segment
# is fixed and 3 more for a footprint vertex's θ chain, 41 where the
# segment moves with the pose, with the ∂|ab|²/∂θ term), the point's
# orientation to the segment and its even-odd crossing (3 each, from the
# distance's differences). A minimum's gradient counts every candidate's
# (the tie split needs them), as the disc footprints' count does; min2's
# split is 9 and an edge minimum's 4.
_TRIG, _WORLD_VERTEX, _SEG_CONST = 2, (8, 2), (5, 9)
_DIST, _DIST_GRAD_FIXED, _DIST_GRAD_MOVING, _THETA_CHAIN = 15, 12, 41, 3
_ORIENT = _CROSS = 3
_MIN2, _EDGE_MIN = 9, 4


def _footprint_flops(fp, mc, ml, mg, edges):
    """(value, pose gradient) operations of a segment or polygon footprint's
    rows at one pose, before g = min_dist − d and the dynamic shifts, for
    mc point and circle slots, ml line slots and mg polygon slots with
    ``edges`` active edges in all. The footprint: cos, sin, its world
    points and edges once per pose. A circle slot: its center's distance to
    each footprint edge, with a crossing for the polygon's sign, and the
    sign and radius. A line slot (segment_to_segment per footprint edge):
    its constants, each footprint point's distance and orientation to it,
    each of its ends' distance and orientation to each footprint edge, the
    intersection test per edge (2) and, for the polygon, its first end's
    crossing per edge. A polygon slot: each edge's constants, per pair of
    a footprint edge and a slot edge the two distances a pair adds (a
    footprint point to the slot edge, a slot vertex to the footprint edge,
    each shared with the next pair) with their orientations and the
    intersection test, and the two containment tests' crossings."""
    d, o = _DIST, _ORIENT
    if isinstance(fp, LineFootprint):
        nf, ne = 2, 1
    else:
        nf = ne = len(fp.vertices)
    value = _TRIG + nf * _WORLD_VERTEX[0] + ne * _SEG_CONST[0]
    grad = nf * _WORLD_VERTEX[1] + ne * _SEG_CONST[1]
    seg_seg_grad = 2 * (_DIST_GRAD_FIXED + _THETA_CHAIN) + 2 * _DIST_GRAD_MOVING + 3 * _MIN2
    if isinstance(fp, LineFootprint):
        value += mc * (d + 1) + ml * (_SEG_CONST[0] + 4 * (d + o) + 2)
        value += edges * (_SEG_CONST[0] + 3 * (d + o) + 2 + _CROSS) + mg
        grad += mc * _DIST_GRAD_MOVING + ml * seg_seg_grad
        grad += edges * (2 * (_DIST_GRAD_FIXED + _THETA_CHAIN) + _DIST_GRAD_MOVING + 3 * _MIN2)
        return value, grad + mg * _EDGE_MIN
    value += mc * (ne * (d + _CROSS) + 2)
    value += ml * (_SEG_CONST[0] + 3 * ne * (d + o) + ne * (2 + _CROSS) + 1)
    value += edges * (_SEG_CONST[0] + ne * (2 * (d + o) + 2) + _CROSS) + mg * (ne * _CROSS + 1)
    pair_grad = _DIST_GRAD_FIXED + _THETA_CHAIN + _DIST_GRAD_MOVING + 3 * _MIN2
    grad += mc * (ne * _DIST_GRAD_MOVING + _EDGE_MIN)
    grad += ml * (ne * (pair_grad + _DIST_GRAD_MOVING) + _EDGE_MIN) + edges * ne * pair_grad
    return value, grad + mg * _EDGE_MIN


def k2a_flops(spec, n_al: int, n_sqp: int, n_alpha: int, obstacles=None, via_mask=None) -> int:
    """Floating-point operations one scenario's solve of ``spec`` needs: its
    closed forms counted from csrc/fused_al_sqp.cu, the Riccati step and the
    rollout on their structure (``step_flops`` of ``step_structure``; the
    kernel itself does them as dense 6x6 products, about four times the
    work). A multiply-add is 2; sqrt, division and the trigonometric
    functions 1 each; comparisons, negations and copies 0. The schedule is
    fixed, so every lane does the same work but for its polygon edges.
    ``obstacles`` (the run's ObstacleSet) gives the slot families; without
    it every slot is a circle slot. ``via_mask`` (the run's) gives the
    active via points (``_via_flops``). On the non-uniform grid the dt box
    is a stage row (in the derivatives with the ddt column's proximal
    weight, in every candidate's merit and in the dual update), each stage
    clips its own candidate dt (2) and applies its step (2), the trust cap
    is taken per stage (2) and the minimum time is the sum of the stage dt.
    The defect's value (every candidate's merit, the dual update) and its
    linearization (the derivatives, the rollout) per stage follow the
    collocation rule (``_defect_flops``)."""
    N, M = spec.N, spec.obstacle_cap
    f_ops = _MODEL_FLOPS[type(spec.model)][0]
    value_ops, transition = _defect_flops(spec)
    value_extra = value_ops - (f_ops + _DEFECT)  # beyond forward differences' value
    quad = spec.objective == "quadratic_form"
    vdt, ball = spec.variable_dt, spec.ball_radius > 0.0
    nonu = spec.nonuniform_dt
    trap_nonu = nonu and trapezoidal(spec)
    shared_dt = vdt and not nonu  # the one dt box: terminal rows
    riccati, rollout_step = step_flops(step_structure(spec))
    obs_value, obs_grad, obs_al = _geometry_flops(spec, obstacles)
    obs_deriv = obs_grad + obs_al * M
    ball_g = 9                              # Σ w_i d_i² − r²
    dt_rows_merit, dt_rows_pp, dt_rows_dual = 14, 14, 6
    # terminal_Pp: equality and the dt box (30), the obstacle rows; Qf, the
    # trapezoidal tail, the ball (g, g′, its gradient and exact Hessian)
    terminal = 30 + obs_deriv - (0 if shared_dt else dt_rows_pp)
    terminal += 9 * (spec.qf_diag is not None) + 28 * trapezoidal(spec)
    terminal += (ball_g + 3 + 4 + 12 + 27) * ball
    # stage_grad_hess: rate and box rows (175), the obstacle rows; the
    # quadratic form: plain 21, integral 52 (the non-uniform trapezoidal
    # stage 12 more: ½(dt_{k-1} + dt_k), ½lx and the dt_{k-1} rows), hybrid
    # 1; the non-uniform interval's dt box and the proximal weight
    stage = 175 + obs_deriv + (dt_rows_pp + 1) * nonu
    if quad:
        stage += (52 if spec.integral_form else 21) + (spec.hybrid_time_weight > 0.0)
        stage += 12 * trap_nonu
    rollout = transition + rollout_step
    # merit per stage: candidate, defect, penalties (121 with the simple
    # car's f), the obstacle rows and their penalties (10 per slot); the
    # quadratic form's stage cost (20, integral 22, the non-uniform
    # trapezoidal 2 more, hybrid 2); non-uniform: the interval's dt box, its
    # clipped candidate dt (2) and, minimum time, Σ dt (1)
    merit_stage = 121 - 7 + f_ops + value_extra + obs_value + 10 * M
    if quad:
        merit_stage += (22 if spec.integral_form else 20) + 2 * (spec.hybrid_time_weight > 0.0)
        merit_stage += 2 * trap_nonu
    merit_stage += (dt_rows_merit + 2 + (not quad)) * nonu
    # merit's terminal part (40): equality, dt box, ball row, minimum time;
    # Qf 9, the tail 11, the ball's g
    merit_end = 40 - (0 if shared_dt else dt_rows_merit) - quad
    merit_end += 9 * (spec.qf_diag is not None) + 11 * trapezoidal(spec) + ball_g * ball
    # the free δτ and the cap (3 + 4), or the cap per stage (2) and each
    # stage's dt step (2)
    free_tau_and_cap = 3 + 4 if shared_dt else 4 * N * nonu
    via_iter, via_final = _via_flops(spec, n_alpha, via_mask)
    per_iter = (
        terminal + N * (transition + stage + riccati) + free_tau_and_cap + N * rollout
        + (n_alpha + 1) * (N * merit_stage + merit_end) + 13 * N + 6 + via_iter
    )
    # dual update: the stage rows (80), the obstacle rows and their updates
    # (6 per slot), the terminal rows and ρ (20); the non-uniform intervals'
    # dt boxes
    per_phase = (N * (80 + value_extra + obs_value + 6 * M) + 20 + (ball_g + 3) * ball
                 - (0 if shared_dt else dt_rows_dual) + dt_rows_dual * N * nonu)
    # the objective at the end: N·dt (Σ dt_k), or the stage costs and the
    # terminal terms
    final = N if nonu else 2
    if quad:
        final = N * (22 if spec.integral_form else 20) + 11 * trapezoidal(spec) + 2 * N * trap_nonu
    final += 9 * (spec.qf_diag is not None) + via_final
    return round(n_al * n_sqp * per_iter + n_al * per_phase + final)
