"""Benchmark problem definitions (port of ``mpc_local_planner_tpu.benchmarks``:
BASELINE.json configs #1-#3, the scenario ensemble, and the flagship,
canonical car-like, wall-world, via-points, polygon-footprint and
non-uniform-grid families with their ensembles)."""

from __future__ import annotations

from typing import Optional

import dataclasses
import math

import torch

from mpc_local_planner_tpu_torch.device import resolve_device
from mpc_local_planner_tpu_torch.geometry.footprints import (
    CircularFootprint,
    PointFootprint,
    PolygonFootprint,
    TwoCirclesFootprint,
)
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec, Scenario
from mpc_local_planner_tpu_torch.systems.models import (
    RobotLimits,
    SimpleCarModel,
    UnicycleModel,
)

DIFF_DRIVE_LIMITS = RobotLimits(
    max_vel_x=0.4, max_vel_x_backwards=0.2, max_vel_theta=0.3,
    acc_lim_x=0.5, acc_lim_theta=0.5,
)
CARLIKE_LIMITS = RobotLimits(
    max_vel_x=0.4, max_vel_x_backwards=0.2, max_steering_angle=1.0,
    acc_lim_x=0.5,
)


def config1_unicycle_quadratic(N: int = 20) -> OcpSpec:
    """BASELINE config #1: unicycle, quadratic form, no obstacles."""
    return OcpSpec(
        model=UnicycleModel(), footprint=PointFootprint(), N=N,
        objective="quadratic_form", q_diag=(2.0, 2.0, 2.0), r_diag=(1.0, 1.0),
        qf_diag=(10.0, 10.0, 10.0), dt_ref=0.3, limits=DIFF_DRIVE_LIMITS,
    )


def config2_diffdrive_obstacles(N: int = 30, obstacle_cap: int = 10) -> OcpSpec:
    """BASELINE config #2: diff-drive, 10 circular obstacles, terminal ball."""
    return OcpSpec(
        model=UnicycleModel(), footprint=CircularFootprint(radius=0.2), N=N,
        objective="quadratic_form", q_diag=(2.0, 2.0, 2.0), r_diag=(1.0, 1.0),
        qf_diag=(20.0, 20.0, 20.0), ball_weights=(1.0, 1.0, 0.0),
        ball_radius=0.2, dt_ref=0.3, min_obstacle_dist=0.1,
        obstacle_cap=obstacle_cap, limits=DIFF_DRIVE_LIMITS,
    )


def config3_carlike_min_time(N: int = 50, obstacle_cap: int = 10) -> OcpSpec:
    """BASELINE config #3: car-like (Ackermann) time-optimal with obstacles."""
    return OcpSpec(
        model=SimpleCarModel(wheelbase=0.5), footprint=CircularFootprint(radius=0.2),
        N=N, objective="minimum_time", variable_dt=True, dt_min=1e-3, dt_max=0.5,
        dt_ref=0.3, xf_fixed=(True, True, True), min_obstacle_dist=0.1,
        obstacle_cap=obstacle_cap, limits=CARLIKE_LIMITS,
    )


def random_ensemble(
    spec: OcpSpec,
    batch: int,
    generator: torch.Generator,
    dtype=torch.float32,
    device=None,
    goal_radius: float = 3.0,
    n_obstacles: Optional[int] = None,
) -> Scenario:
    """Random (start pose × goal × obstacle field) scenario ensemble.

    Obstacles are circles sampled between start and goal, kept clear of both
    endpoints so every instance is feasible. The numbers are drawn from
    ``generator`` on its own device and moved to ``device`` (CUDA unless the
    caller asks for the CPU); they differ from the JAX package's streams.
    """
    dev = resolve_device(device)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
        return (lo + (hi - lo) * u).to(dev)

    x0 = torch.zeros((batch, 3), dtype=dtype, device=dev)
    ang = uniform((batch,), -0.8, 0.8)
    dist = uniform((batch,), 0.6 * goal_radius, goal_radius)
    xf = torch.stack([dist * torch.cos(ang), dist * torch.sin(ang), ang], dim=-1)

    M = spec.obstacle_cap
    u_prev = torch.zeros((batch, spec.nu), dtype=dtype, device=dev)
    via_points = torch.zeros((batch, spec.via_cap, 3), dtype=dtype, device=dev)
    via_mask = torch.zeros((batch, spec.via_cap), dtype=torch.bool, device=dev)
    if M == 0:
        obstacles = ObstacleSet.empty(dtype=dtype, device=dev, batch=(batch,))
        return Scenario(x0, xf, obstacles, via_points, via_mask, u_prev)

    n_act = M if n_obstacles is None else min(n_obstacles, M)
    frac = uniform((batch, M), 0.25, 0.75)
    lateral = uniform((batch, M), -1.0, 1.0)
    heading = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    normal = torch.stack([-torch.sin(ang), torch.cos(ang)], dim=-1)
    centers = (
        frac[..., None] * dist[:, None, None] * heading[:, None, :]
        + lateral[..., None] * normal[:, None, :]
    )
    mask = (torch.arange(M, device=dev) < n_act)[None, :] & (torch.abs(lateral) > 0.45)
    empty = ObstacleSet.empty(dtype=dtype, device=dev, batch=(batch,), max_polygon_vertices=3)
    obstacles = ObstacleSet(
        points=empty.points, point_vels=empty.point_vels, point_mask=empty.point_mask,
        circles=centers,
        circle_radii=torch.full((batch, M), 0.25, dtype=dtype, device=dev),
        circle_vels=torch.zeros((batch, M, 2), dtype=dtype, device=dev),
        circle_mask=mask,
        lines=empty.lines, line_vels=empty.line_vels, line_mask=empty.line_mask,
        polygons=empty.polygons, polygon_nv=empty.polygon_nv,
        polygon_vels=empty.polygon_vels, polygon_mask=empty.polygon_mask,
    )
    return Scenario(x0, xf, obstacles, via_points, via_mask, u_prev)


# the families of bench.py's families mode, in its order; ``family_spec``
# builds each
FAMILY_NAMES = (
    "flagship", "canonical_carlike", "converter_lines", "via_points",
    "polygon_footprint", "nonuniform",
)


def family_spec(name: str, N: int = 30) -> OcpSpec:
    """Widened-family variants of the flagship car-like minimum-time config:
    ``canonical_carlike`` is the reference's own footprint (two_circles,
    examples/cfg/carlike_minimum_time.yaml), ``converter_lines`` the wall
    worlds of costmap_converter's line output (6 slots, filled with lines by
    ``family_ensemble``), ``via_points`` the minimum-time objective with 4
    via points (position weight 2, unordered, filled with corridor points
    by ``family_ensemble``), ``polygon_footprint`` a 0.5 × 0.3 m rectangular
    body (the reference's ``footprint_model.type: polygon``), ``nonuniform``
    the non-uniform grid of a per-stage dt (``random_ensemble``'s
    scenarios)."""
    base = config3_carlike_min_time(N=N, obstacle_cap=8)
    if name == "flagship":
        return base
    if name == "canonical_carlike":
        return dataclasses.replace(
            base,
            footprint=TwoCirclesFootprint(
                front_offset=0.15, front_radius=0.2, rear_offset=-0.15, rear_radius=0.2,
            ),
        )
    if name == "converter_lines":
        return dataclasses.replace(base, obstacle_cap=6)
    if name == "via_points":
        return dataclasses.replace(
            base, objective="minimum_time_via_points", via_cap=4, via_position_weight=2.0,
        )
    if name == "polygon_footprint":
        return dataclasses.replace(
            base,
            footprint=PolygonFootprint(
                vertices=((0.25, 0.15), (-0.25, 0.15), (-0.25, -0.15), (0.25, -0.15))
            ),
        )
    if name == "nonuniform":
        return dataclasses.replace(base, nonuniform_dt=True)
    raise ValueError(f"unknown family {name!r}")


def family_ensemble(name: str, spec: OcpSpec, batch: int, generator: torch.Generator,
                    dtype=torch.float32, device=None) -> Scenario:
    """Scenario ensemble for a family: ``random_ensemble``'s; for
    ``converter_lines`` wall segments in place of the circle slots (0.8 m
    walls across the corridor between start and goal, tilted up to 0.5 rad,
    kept clear of both endpoints like the circle sampler); for
    ``via_points`` corridor via points (the reference extracts via points
    from the global plan every ``global_plan_viapoint_sep`` metres): points
    at 0.2 to 0.8 of the way, evenly spaced in list order, offset up to
    ±0.3 m across it, heading along it, all active. Drawn from
    ``generator`` after ``random_ensemble``'s numbers."""
    scen = random_ensemble(spec, batch, generator, dtype=dtype, device=device)
    if name not in ("converter_lines", "via_points"):
        return scen
    dev = scen.x0.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
        return (lo + (hi - lo) * u).to(dev)

    d = scen.xf[:, :2] - scen.x0[:, :2]
    ang = torch.atan2(d[:, 1], d[:, 0])
    dist = torch.linalg.norm(d, dim=-1)
    heading = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
    normal = torch.stack([-torch.sin(ang), torch.cos(ang)], dim=-1)
    if name == "via_points":
        if not spec.via_cap:
            return scen
        V = spec.via_cap
        frac = torch.linspace(0.2, 0.8, V, dtype=dtype, device=dev)[None, :]
        lateral = uniform((batch, V), -0.3, 0.3)
        pts = (frac[..., None] * dist[:, None, None] * heading[:, None, :]
               + lateral[..., None] * normal[:, None, :])
        via = torch.cat([pts, ang[:, None, None].expand(batch, V, 1)], dim=-1)
        return dataclasses.replace(
            scen, via_points=via, via_mask=torch.ones((batch, V), dtype=torch.bool, device=dev))
    M = spec.obstacle_cap
    frac = uniform((batch, M), 0.25, 0.75)
    lateral = uniform((batch, M), -1.0, 1.0)
    wall_ang = uniform((batch, M), -0.5, 0.5)
    half = 0.4
    mid = frac[..., None] * dist[:, None, None] * heading[:, None, :] + lateral[
        ..., None
    ] * normal[:, None, :]
    wdir = (
        torch.cos(wall_ang)[..., None] * normal[:, None, :]
        + torch.sin(wall_ang)[..., None] * heading[:, None, :]
    )
    ends = torch.stack([mid - half * wdir, mid + half * wdir], dim=-2)
    obstacles = dataclasses.replace(
        scen.obstacles,
        circles=torch.zeros((batch, 0, 2), dtype=dtype, device=dev),
        circle_radii=torch.zeros((batch, 0), dtype=dtype, device=dev),
        circle_vels=torch.zeros((batch, 0, 2), dtype=dtype, device=dev),
        circle_mask=torch.zeros((batch, 0), dtype=torch.bool, device=dev),
        lines=ends,
        line_vels=torch.zeros((batch, M, 2), dtype=dtype, device=dev),
        line_mask=torch.abs(lateral) > 0.45,
    )
    return dataclasses.replace(scen, obstacles=obstacles)


def case_ensemble(kind: str, spec: OcpSpec, batch: int, generator: torch.Generator,
                  dtype=torch.float32, device=None) -> Scenario:
    """``random_ensemble``'s scenarios for a kernel check beyond the
    families: ``"random_via"`` adds random via points as the JAX package's
    fused-kernel tests draw them (``tests/test_fused_solver.py``: poses
    uniform in [0.2, 2.0]³, each slot active with probability 0.7),
    ``"8_obstacles"`` puts 8 obstacles in the spec's slots and masks the
    rest. Drawn from ``generator``, the via points after
    ``random_ensemble``'s numbers."""
    if kind == "8_obstacles":
        return random_ensemble(spec, batch, generator, dtype=dtype, device=device, n_obstacles=8)
    if kind != "random_via":
        raise ValueError(f"unknown case ensemble {kind!r}")
    scen = random_ensemble(spec, batch, generator, dtype=dtype, device=device)
    dev = scen.x0.device
    u = torch.rand((batch, spec.via_cap, 3), generator=generator, dtype=dtype,
                   device=generator.device)
    m = torch.rand((batch, spec.via_cap), generator=generator, dtype=dtype,
                   device=generator.device)
    return dataclasses.replace(scen, via_points=(0.2 + 1.8 * u).to(dev), via_mask=(m > 0.3).to(dev))


def mixed_obstacles(batch: int, generator: torch.Generator, mp: int = 0, mc: int = 0,
                    ml: int = 0, mg: int = 0, V: int = 4, dynamic: bool = False,
                    vary_nv: bool = False, dtype=torch.float32, device=None) -> ObstacleSet:
    """A random ObstacleSet with every requested slot family, as the JAX
    package's fused-kernel tests draw it (``tests/test_fused_solver.py``):
    points and circles in [0.3, 2.2]², circle radii in [0.1, 0.3], segments
    from a point in that box to within ±0.7 of it, star-shaped polygons of V
    vertices (radii 0.15-0.4 about a center in [0.5, 2.0]²; with
    ``vary_nv`` 3 to V of them active), a quarter of the slots masked,
    velocities in [−0.4, 0.4]² when ``dynamic``. Drawn from ``generator``."""
    dev = resolve_device(device)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
        return (lo + (hi - lo) * u).to(dev)

    def vel(n):
        return uniform((batch, n, 2), -0.4, 0.4) if dynamic else torch.zeros(
            (batch, n, 2), dtype=dtype, device=dev)

    def mask(n):
        return uniform((batch, n), 0.0, 1.0) > 0.25

    line_a = uniform((batch, ml, 2), 0.3, 2.2)
    lines = torch.stack([line_a, line_a + uniform((batch, ml, 2), -0.7, 0.7)], dim=-2)
    centers = uniform((batch, mg, 2), 0.5, 2.0)
    ang = torch.sort(uniform((batch, mg, V), 0.0, 2.0 * math.pi), dim=-1).values
    rad = uniform((batch, mg, V), 0.15, 0.4)
    polygons = centers[..., None, :] + torch.stack(
        [rad * torch.cos(ang), rad * torch.sin(ang)], dim=-1)
    if vary_nv and V > 3:
        nv = 3 + torch.randint(0, V - 2, (batch, mg), generator=generator,
                               device=generator.device)
    else:
        nv = torch.full((batch, mg), V)
    return ObstacleSet(
        points=uniform((batch, mp, 2), 0.3, 2.2), point_vels=vel(mp), point_mask=mask(mp),
        circles=uniform((batch, mc, 2), 0.3, 2.2), circle_radii=uniform((batch, mc), 0.1, 0.3),
        circle_vels=vel(mc), circle_mask=mask(mc),
        lines=lines, line_vels=vel(ml), line_mask=mask(ml),
        polygons=polygons, polygon_nv=nv.to(device=dev, dtype=torch.int32),
        polygon_vels=vel(mg), polygon_mask=mask(mg),
    )


def _astar_lane(x0, xf, lines, mask, n_points, resolution, robot_radius, margin):
    """One lane of ``lines_astar_plans``: (plan (n_points, 3) float64, ok)."""
    import numpy as np

    from mpc_local_planner_tpu_torch.planner.local_planner import Costmap
    from mpc_local_planner_tpu_torch.utils.worlds import astar_plan

    lo = np.minimum(x0, xf) - margin
    hi = np.maximum(x0, xf) + margin
    W = int(np.ceil((hi[0] - lo[0]) / resolution)) + 1
    H = int(np.ceil((hi[1] - lo[1]) / resolution)) + 1
    data = np.zeros((H, W), np.uint8)
    for j in range(lines.shape[0]):
        if not mask[j]:
            continue
        a, c = lines[j, 0], lines[j, 1]
        n = max(2, int(np.linalg.norm(c - a) / (0.5 * resolution)))
        for t in np.linspace(0.0, 1.0, n):
            p = a + t * (c - a)
            cx = int(round((p[0] - lo[0]) / resolution))
            cy = int(round((p[1] - lo[1]) / resolution))
            if 0 <= cy < H and 0 <= cx < W:
                data[cy, cx] = 254
    cm = Costmap(data=data, origin=(float(lo[0]), float(lo[1])), resolution=resolution)
    plan = np.zeros((n_points, 3), np.float64)
    try:
        path = astar_plan(cm, x0, xf, robot_radius=robot_radius)
    except ValueError:
        path = None
    if path is None or path.shape[0] < 2:
        d = xf - x0
        fr = np.linspace(0.0, 1.0, n_points)[:, None]
        plan[:, :2] = x0 + fr * d
        plan[:, 2] = np.arctan2(d[1], d[0])
        return plan, False
    # the true start and goal anchor the seed (A* returns cell centres)
    path = np.array(path, np.float64)
    path[0, :2] = x0
    path[-1, :2] = xf
    seg = np.diff(path[:, :2], axis=0)
    arc = np.concatenate([[0.0], np.cumsum(np.linalg.norm(seg, axis=1))])
    s = np.linspace(0.0, arc[-1], n_points)
    plan[:, 0] = np.interp(s, arc, path[:, 0])
    plan[:, 1] = np.interp(s, arc, path[:, 1])
    d = np.diff(plan[:, :2], axis=0)
    th = np.arctan2(d[:, 1], d[:, 0])
    plan[:-1, 2] = th
    plan[-1, 2] = th[-1]
    return plan, True


def _astar_lanes(args):
    """``_astar_lane`` over a chunk of lanes (a worker process's share)."""
    x0, xf, lines, mask, kw = args
    out = [_astar_lane(x0[b], xf[b], lines[b], mask[b], **kw) for b in range(x0.shape[0])]
    return [p for p, _ in out], [ok for _, ok in out]


def lines_astar_plans(scenario, n_points: int = 16, resolution: float = 0.1,
                      robot_radius: float = 0.25, margin: float = 1.8, processes: int = 1):
    """Per-lane A* global plans around the wall fields (host-side numpy).

    The move_base global planner's role for the ``converter_lines``
    ensemble: each lane's active wall segments are rasterized into an
    occupancy grid and ``astar_plan`` routes start → goal; each path is
    resampled by arc length to ``n_points`` poses. Lanes where A* fails
    (start or goal enclosed) fall back to the straight line. Returns (plans
    (B, n_points, 3) float32 on the scenario's device, ok (B,) numpy bool).
    ``processes`` > 1 splits the lanes into that many chunks, each planned
    in a process of its own; the plans are the same.
    """
    import numpy as np

    x0 = scenario.x0[..., :2].detach().cpu().double().numpy()
    xf = scenario.xf[..., :2].detach().cpu().double().numpy()
    lines = scenario.obstacles.lines.detach().cpu().double().numpy()   # (B, M, 2, 2)
    mask = scenario.obstacles.line_mask.detach().cpu().numpy()
    B = x0.shape[0]
    kw = dict(n_points=n_points, resolution=resolution, robot_radius=robot_radius,
              margin=margin)
    bounds = np.linspace(0, B, max(1, min(processes, B)) + 1).astype(int)
    chunks = [(x0[a:b], xf[a:b], lines[a:b], mask[a:b], kw)
              for a, b in zip(bounds[:-1], bounds[1:])]
    if len(chunks) == 1:
        parts = [_astar_lanes(chunks[0])]
    else:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(len(chunks),
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            parts = list(pool.map(_astar_lanes, chunks))
    plans = np.stack([p for ps, _ in parts for p in ps]) if B else np.zeros((0, n_points, 3))
    ok = np.array([o for _, oks in parts for o in oks], dtype=bool)
    return torch.from_numpy(plans.astype(np.float32)).to(scenario.x0.device), ok


def lines_detour_plan(scenario) -> torch.Tensor:
    """A 3-point global plan routed around the wall field: start → a mid-path
    waypoint 1.2 m to the side opposite the mean lateral offset of the
    active walls → goal, every pose heading along start → goal (bench.py's
    ``BENCH_LINES_SEED=plan``); feed it to ``ocp.grid.primal_from_plan``."""
    x0, xf = scenario.x0[..., :2], scenario.xf[..., :2]
    d = xf - x0
    dist = torch.linalg.norm(d, dim=-1, keepdim=True)
    hn = d / torch.clamp(dist, min=1e-6)
    normal = torch.stack([-hn[..., 1], hn[..., 0]], dim=-1)
    mids = torch.mean(scenario.obstacles.lines, dim=-2)  # (..., M, 2)
    rel = mids - x0[..., None, :]
    lat = torch.sum(rel * normal[..., None, :], dim=-1)  # (..., M)
    m = scenario.obstacles.line_mask.to(lat.dtype)
    mean_lat = torch.sum(lat * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1), min=1.0)
    side = -torch.sign(mean_lat + 1e-6)
    way = 0.5 * (x0 + xf) + side[..., None] * 1.2 * normal
    th = torch.atan2(d[..., 1], d[..., 0])[..., None]
    return torch.stack([torch.cat([p, th], dim=-1) for p in (x0, way, xf)], dim=-2)


def classify_feasibility(spec, scenario, max_instances: int = 64, tol: float = 1e-5,
                         maxiter: int = 600, seed_primal=None, device=None):
    """Ensemble feasibility oracle: classify the first ``max_instances``
    scenarios with the float64 golden pipeline.

    For each: (1) a float64 AL-SQP cold solve (``SolverSettings.for_spec``)
    from the straight-line seed or ``seed_primal`` finds a candidate point
    on ``device`` (CUDA unless the caller asks for the CPU); (2) where its
    violation passes ``tol``, scipy SLSQP (``solvers/golden.py``, on the
    host) polishes from it; (3) the instance is "feasible" if the better of
    the two points is within ``tol`` (max equality and inequality
    violation), else "unknown" (infeasible, or beyond both budgets). Inputs
    are cast to float64 here, so the classification never runs at the
    solver's float32. Returns (labels list, details dict), as the JAX
    function does.
    """
    import numpy as np

    from mpc_local_planner_tpu_torch.core.tree import tree_map
    from mpc_local_planner_tpu_torch.ocp.grid import initial_primal
    from mpc_local_planner_tpu_torch.ocp.problem import make_ocp_functions
    from mpc_local_planner_tpu_torch.solvers.al_sqp import (
        SolverSettings,
        init_duals,
        make_solver,
    )
    from mpc_local_planner_tpu_torch.solvers.golden import solve_golden

    dev = resolve_device(device)
    funcs = make_ocp_functions(spec)
    B = int(scenario.x0.shape[0])
    n = min(B, max_instances)

    def head64(tree, where):
        return tree_map(
            lambda a: (a[:n].double() if a.is_floating_point() else a[:n]).to(where), tree)

    scen64 = head64(scenario, dev)
    cold = SolverSettings.for_spec(spec)
    init = initial_primal(spec, scen64) if seed_primal is None else head64(seed_primal, dev)
    duals = init_duals(spec, cold, dtype=torch.float64, device=dev, batch=(n,))
    r = make_solver(spec, cold, dev)(scen64, init, duals)
    scen_h = tree_map(lambda a: a.cpu(), scen64)
    primal_h = tree_map(lambda a: a.cpu(), r.primal)

    def viol_at(primal, scen_b):
        eq = float(torch.max(torch.abs(funcs.eq(primal, scen_b))))
        ineq = float(torch.max(funcs.ineq(primal, scen_b)))
        return max(eq, max(ineq, 0.0))

    labels, viols, per_instance = [], [], []
    for b in range(n):
        scen_b = tree_map(lambda a: a[b], scen_h)
        primal_b = tree_map(lambda a: a[b], primal_h)
        al_viol = viol_at(primal_b, scen_b)
        viol = al_viol
        used_slsqp = False
        if viol > tol:
            try:
                sol_g, _res = solve_golden(spec, scen_b, init=primal_b, tol=1e-10,
                                           maxiter=maxiter)
                pv = viol_at(sol_g, scen_b)
                used_slsqp = pv < viol
                viol = min(viol, pv)
            except Exception:  # noqa: BLE001 — an SLSQP failure leaves "unknown"
                pass
        viols.append(viol)
        labels.append("feasible" if viol <= tol else "unknown")
        per_instance.append({
            "al_viol": float(al_viol),
            "viol": float(viol),
            "certified_by": (
                "al64" if al_viol <= tol else ("slsqp" if viol <= tol else "none")
            ),
            "used_slsqp": used_slsqp,
        })
    feas = labels.count("feasible")
    return labels, {
        "n": n,
        "feasible_frac": feas / max(n, 1),
        "max_viol_on_feasible": float(
            np.max([v for v, lab in zip(viols, labels) if lab == "feasible"], initial=0.0)
        ),
        "per_instance": per_instance,
    }
