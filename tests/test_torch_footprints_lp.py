"""The line and polygon footprints (the rest of the fused kernel's geometry,
K2c) on the CPU, against the JAX package.

- ``LineFootprint`` and ``PolygonFootprint.distances`` against JAX, values
  and pose gradients (``torch.func.grad`` against ``jax.grad``), float64 at
  1e-12 and float32 at 1e-5 (values) and 1e-4 (gradients): point, circle,
  line and polygon slots (padded, 3 to 5 active vertices), static and
  predicted, a tilted segment, a rectangle, a concave polygon and an
  8-vertex polygon (the kernel's limit); then the exact ties: a segment
  parameter at exactly 0 and 1, a slot point on a footprint vertex, a slot
  point equally near two and three footprint edges, a slot line crossing
  the footprint, and containment both ways.
- ``inscribed_radius`` of every footprint against JAX's.
- The kernel's closed forms (``fused_kkt_system``) against the port's AD
  path (``al_sqp._kkt_system``) at 1e-10 in float64, for a line footprint
  and a polygon footprint with all four slot families moving and for the
  polygon-footprint family, at random iterates and with the ties above on
  the trajectory; the float32 AD path stays float32.
- The scope (``fused_supported`` up to 8 vertices), the family spec, the
  kernel's parameters, the step structure and the operation count.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.geometry import footprints as jfp

from test_torch_geometry_k2c import (
    DTYPES,
    KKT_NAMES,
    _closed_forms_and_ad,
    _obstacle_arrays,
    _place_near,
    _poses,
)
from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.geometry import footprints as tfp
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet as TObstacleSet
from mpc_local_planner_tpu_torch.ocp.grid import Primal, initial_primal
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.solvers import al_sqp

N = 8
TOL = {"f64": dict(value=1e-12, grad=1e-12), "f32": dict(value=1e-5, grad=1e-4)}
# binary-exact coordinates, so that the tie poses below tie exactly
RECT = ((0.25, 0.125), (-0.25, 0.125), (-0.25, -0.125), (0.25, -0.125))
FAMILY_RECT = ((0.25, 0.15), (-0.25, 0.15), (-0.25, -0.15), (0.25, -0.15))
CONCAVE = ((0.3, 0.2), (-0.2, 0.2), (-0.2, -0.2), (0.3, -0.2), (0.3, -0.05), (0.05, 0.0))
OCTAGON = tuple((0.3 * math.cos(2 * math.pi * i / 8), 0.2 * math.sin(2 * math.pi * i / 8))
                for i in range(8))
FOOTPRINTS = {
    "line": ("LineFootprint", dict(line_start=(-0.125, 0.0), line_end=(0.375, 0.0))),
    "tilted_line": ("LineFootprint", dict(line_start=(-0.1, -0.05), line_end=(0.35, 0.1))),
    "rectangle": ("PolygonFootprint", dict(vertices=RECT)),
    "concave": ("PolygonFootprint", dict(vertices=CONCAVE)),
    "octagon": ("PolygonFootprint", dict(vertices=OCTAGON)),
}


def _footprints(kind):
    name, kw = FOOTPRINTS[kind]
    return getattr(jfp, name)(**kw), getattr(tfp, name)(**kw)


def _jax_obs(arrays):
    return jax.tree_util.tree_map(jnp.asarray, jfp.ObstacleSet(**arrays))


def _assert_distances_match(jf, tf, poses, arrays, tol):
    """Values and pose gradients of ``distances`` on every pose."""
    jo, to = _jax_obs(arrays), convert.from_numpy(TObstacleSet, arrays, "cpu")
    # jitted: one compile per footprint and shape (eager JAX compiles each op)
    d_j = jax.jit(jf.distances)(jnp.asarray(poses), jo)
    d_t = tf.distances(torch.from_numpy(poses), to)
    assert d_t.dtype == torch.from_numpy(poses).dtype
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=tol["value"], rtol=0)
    g_j = jax.jit(jax.grad(lambda p, o: jf.distances(p, o).sum()))(jnp.asarray(poses), jo)
    g_t = torch.func.grad(lambda p: tf.distances(p, to).sum())(torch.from_numpy(poses))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=tol["grad"], rtol=0)
    return d_t, g_t


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("kind", sorted(FOOTPRINTS))
def test_torch_line_and_polygon_footprints_match_jax(kind, dynamic, dtype_name):
    """Per-pose distances to every slot of all four families and their pose
    gradients; dynamic: each pose against the set predicted to its own
    time."""
    np_dtype, _ = DTYPES[dtype_name]
    jf, tf = _footprints(kind)
    poses = _poses(np_dtype)
    arrays = _obstacle_arrays(np_dtype)
    if dynamic:
        times = np.linspace(0.0, 1.2, len(poses)).astype(np_dtype)
        jo = _jax_obs(arrays).predict_stages(jnp.asarray(times))
        arrays = {f.name: np.asarray(getattr(jo, f.name)) for f in dataclasses.fields(jo)}
    d_t, _ = _assert_distances_match(jf, tf, poses, arrays, TOL[dtype_name])
    assert np.all(d_t.numpy()[:, [1, 5]] >= 1e6 - 1.0)  # the masked point and line slots


def _tie_case(name, np_dtype):
    """(footprint kind, poses, obstacle arrays) of one exact tie, every
    coordinate exact in binary: the footprint at (1, 0.5, 0) and a slot
    placed on the tie (a second slot of each family far away, masked)."""
    f = lambda x: np.asarray(x, dtype=np_dtype)  # noqa: E731
    far_poly = [[5.0, 5.0], [6.0, 5.0], [6.0, 6.0], [5.0, 6.0]]
    slots = dict(point=[5.0, 5.0], circle=[6.0, 6.0], line=[[5.0, 6.0], [6.0, 6.0]],
                 polygon=far_poly)
    kind, slot, where = {
        # the footprint segment runs (0.875, 0.5) -> (1.375, 0.5)
        "segment_t_0": ("line", "point", [0.875, 0.5625]),
        "segment_t_1": ("line", "circle", [1.375, 0.4375]),
        "line_crosses_segment": ("line", "line", [[1.0, 0.25], [1.125, 0.75]]),
        "segment_start_inside_polygon": ("line", "polygon",
                                         [[0.75, 0.25], [1.0, 0.25], [1.0, 0.75], [0.75, 0.75]]),
        # the rectangle spans [0.75, 1.25] x [0.375, 0.625]
        "point_on_vertex": ("rectangle", "point", [1.25, 0.625]),
        "two_edges_at_a_corner": ("rectangle", "circle", [1.28125, 0.65625]),
        "three_edges_inside": ("rectangle", "point", [1.125, 0.5]),
        "line_crosses_polygon": ("rectangle", "line", [[0.5, 0.5], [1.5, 0.53125]]),
        "slot_holds_footprint": ("rectangle", "polygon",
                                 [[0.5, 0.25], [1.5, 0.25], [1.5, 0.75], [0.5, 0.75]]),
        "footprint_holds_slot": ("rectangle", "polygon",
                                 [[0.875, 0.4375], [1.0, 0.4375], [1.0, 0.5], [0.875, 0.5]]),
    }[name]
    slots[slot] = where
    arrays = dict(
        points=f([slots["point"], [7.0, 7.0]]), point_vels=f(np.zeros((2, 2))),
        point_mask=np.array([True, False]),
        circles=f([slots["circle"], [7.0, 8.0]]), circle_radii=f([0.0625, 0.125]),
        circle_vels=f(np.zeros((2, 2))), circle_mask=np.array([True, False]),
        lines=f([slots["line"], [[8.0, 8.0], [9.0, 8.0]]]), line_vels=f(np.zeros((2, 2))),
        line_mask=np.array([True, False]),
        polygons=f([slots["polygon"] + [slots["polygon"][-1]], far_poly + [far_poly[-1]]]),
        polygon_nv=np.array([4, 4], dtype=np.int32), polygon_vels=f(np.zeros((2, 2))),
        polygon_mask=np.array([True, False]),
    )
    return kind, f([[1.0, 0.5, 0.0], [1.0, 0.5, 0.25]]), arrays


TIES = ("segment_t_0", "segment_t_1", "line_crosses_segment", "segment_start_inside_polygon",
        "point_on_vertex", "two_edges_at_a_corner", "three_edges_inside",
        "line_crosses_polygon", "slot_holds_footprint", "footprint_holds_slot")


@pytest.mark.parametrize("tie", TIES)
def test_torch_footprint_ties_match_jax(tie):
    """Each exact tie at pose 0 (and a rotated pose beside it): values and
    pose gradients equal JAX's at 1e-12, and the tie shows as it should."""
    kind, poses, arrays = _tie_case(tie, np.float64)
    jf, tf = _footprints(kind)
    d, g = _assert_distances_match(jf, tf, poses, arrays, TOL["f64"])
    slot = {"point": 0, "circle": 2, "line": 4, "polygon": 6}
    if tie in ("segment_t_0", "segment_t_1"):
        j = slot["point"] if tie == "segment_t_0" else slot["circle"]
        radius = 0.0 if tie == "segment_t_0" else 0.0625
        np.testing.assert_allclose(d[0, j].item(), 0.0625 - radius, atol=1e-9)
    if tie in ("line_crosses_segment", "segment_start_inside_polygon", "line_crosses_polygon",
               "slot_holds_footprint", "footprint_holds_slot"):
        j = slot["line"] if "line_crosses" in tie else slot["polygon"]
        assert d[0, j].item() == 0.0  # zero, with a zero gradient
        row = torch.func.grad(lambda p: tf.distances(p, convert.from_numpy(
            TObstacleSet, arrays, "cpu"))[0, j])(torch.from_numpy(poses))
        assert float(torch.abs(row).max()) == 0.0
    if tie == "point_on_vertex":
        np.testing.assert_allclose(d[0, 0].item(), 1e-6, rtol=1e-9)  # the safe norm's floor
    if tie == "three_edges_inside":
        np.testing.assert_allclose(d[0, 0].item(), -0.125, atol=1e-9)  # inside: negative
    if tie == "two_edges_at_a_corner":
        np.testing.assert_allclose(d[0, 2].item(), 0.03125 * math.sqrt(2.0) - 0.0625, atol=1e-9)


@pytest.mark.parametrize("kind", ["point", "circular", "two_circles"] + sorted(FOOTPRINTS))
def test_torch_inscribed_radius_matches_jax(kind):
    if kind in FOOTPRINTS:
        jf, tf = _footprints(kind)
    else:
        kw = dict(circular=dict(radius=0.2),
                  two_circles=dict(front_offset=0.15, front_radius=0.2, rear_offset=-0.15,
                                   rear_radius=0.18)).get(kind, {})
        name = {"point": "PointFootprint", "circular": "CircularFootprint",
                "two_circles": "TwoCirclesFootprint"}[kind]
        jf, tf = getattr(jfp, name)(**kw), getattr(tfp, name)(**kw)
    assert tf.inscribed_radius == pytest.approx(float(jf.inscribed_radius), abs=1e-15)


# --------------------------------------------------------------------------- #
# closed forms against the AD path (float64)
# --------------------------------------------------------------------------- #
CF_CASES = {
    # footprint, slot families, dynamic
    "line_mixed_dynamic": (tfp.LineFootprint((-0.125, 0.0), (0.375, 0.0)),
                           dict(mp=1, mc=2, ml=2, mg=2, V=5, vary_nv=True), True),
    "polygon_mixed_dynamic": (tfp.PolygonFootprint(RECT),
                              dict(mp=1, mc=2, ml=2, mg=2, V=5, vary_nv=True), True),
    "polygon_family": (tfp.PolygonFootprint(FAMILY_RECT), dict(mc=8), False),
    "octagon": (tfp.PolygonFootprint(OCTAGON), dict(mp=1, mc=1, ml=1, mg=1, V=4), False),
}


def _with_ties(case, xs, obs):
    """Ties on the trajectory, at poses (1, 0.5, 0) of stages 4-6 (the
    coordinates of ``_tie_case``): the line footprint meets a point slot
    at t = 0 exactly and a line slot crosses it; the polygon footprint has
    a point slot on a vertex, a circle slot equally near two edges and a
    line slot crossing it."""
    T = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    for k in (4, 5, 6):
        xs[:, k] = T([1.0, 0.5, 0.0])
    upd = {"points": obs.points.clone(), "lines": obs.lines.clone()}
    for name in ("point_vels", "circle_vels", "line_vels"):  # the tie slots stand still
        upd[name] = getattr(obs, name).clone()
        upd[name][:, 0] = 0.0
    if case.startswith("line"):
        upd["points"][:, 0] = T([0.875, 0.5625])
        upd["lines"][:, 0] = T([[1.0, 0.25], [1.125, 0.75]])
    else:
        upd["points"][:, 0] = T([1.25, 0.625])
        upd["lines"][:, 0] = T([[0.5, 0.5], [1.5, 0.53125]])
        circles = obs.circles.clone()
        circles[:, 0] = T([1.28125, 0.65625])
        upd["circles"] = circles
    return dataclasses.replace(obs, **upd)


def _cf_iterate(case, seed, ties=False, batch=6):
    """An iterate of the flagship with the case's footprint and slots placed
    on the trajectory, the first slot of each family live, and random
    multipliers."""
    fp, fam, dyn = CF_CASES[case]
    M = sum(fam.get(k, 0) for k in ("mp", "mc", "ml", "mg"))
    spec = dataclasses.replace(tb.config3_carlike_min_time(N=N, obstacle_cap=M), footprint=fp,
                               enable_dynamic_obstacles=dyn)
    gen = torch.Generator().manual_seed(seed)
    scen = tb.random_ensemble(dataclasses.replace(spec, obstacle_cap=0), batch, gen,
                              dtype=torch.float64, device="cpu")
    obs = tb.mixed_obstacles(batch, gen, dtype=torch.float64, device="cpu", dynamic=dyn, **fam)
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))  # noqa: E731
    init = initial_primal(spec, dataclasses.replace(scen, obstacles=obs))
    xs = init.xs + T(0.05 * rng.normal(size=init.xs.shape))
    us = init.us + T(0.05 * rng.normal(size=init.us.shape))
    dt = init.dt * T(rng.uniform(0.8, 1.2, size=batch))
    obs = _place_near(obs, xs, rng)
    mask = {k: getattr(obs, k).clone() for k in ("point_mask", "circle_mask", "line_mask",
                                                  "polygon_mask")}
    for m in mask.values():
        m[:, :1] = True
    obs = dataclasses.replace(obs, **mask)
    if ties:
        obs = _with_ties(case, xs, obs)
    scen = dataclasses.replace(scen, obstacles=obs)
    duals = al_sqp.DualState(
        lam_def=T(rng.normal(size=(batch, N, 3))),
        lam_term=T(rng.normal(size=(batch, 3))),
        mu_obs=T(rng.uniform(0.0, 2.0, size=(batch, N, M))),
        mu_rate=T(rng.uniform(0.0, 1.0, size=(batch, N, 4))),
        mu_box=T(rng.uniform(0.0, 1.0, size=(batch, N, 4))),
        mu_dt=T(rng.uniform(0.0, 1.0, size=(batch, 2))),
        mu_ball=torch.zeros((batch, 1), dtype=torch.float64),
        rho=T(rng.uniform(50.0, 200.0, size=batch)),
    )
    return spec, scen, Primal(xs=xs, us=us, dt=dt), duals


@pytest.mark.parametrize(
    "case, ties",
    [(case, False) for case in sorted(CF_CASES)]
    + [("line_mixed_dynamic", True), ("polygon_mixed_dynamic", True)],
)
def test_torch_footprint_closed_forms_match_the_ad_path(case, ties):
    spec, scen, primal, duals = _cf_iterate(case, 31, ties=ties)
    cf, ad, obs_k = _closed_forms_and_ad(spec, scen, primal, duals)
    for name, a, b in zip(KKT_NAMES, cf, ad):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64, name
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0, msg=name)
    g, _ = k2a.obstacle_rows(spec, primal.xs[:, 1:], tree_map(lambda a: a[:, 1:], obs_k))
    assert bool((duals.mu_obs + duals.rho[:, None, None] * g > 0).any())
    # the footprint turns with the pose: the θ rows of the pose block are live
    assert bool((cf[3][:, 1:, 2, 2] > 0).any())
    assert ties or bool((cf[8][:, 0, 2] != 0).any())
    if ties:
        # stage 4: the line slot (row 3, after the point and two circles)
        # crosses the footprint, d = 0 with a zero gradient; the point slot
        # (row 0) sits at t = 0 of the segment or on a polygon vertex
        g4, grad4 = k2a.obstacle_rows(spec, primal.xs[:, 4], tree_map(lambda a: a[:, 4], obs_k))
        assert bool((g4[:, 3] == spec.min_obstacle_dist).all())
        assert bool((grad4[:, 3] == 0).all())
        d0 = math.sqrt((0.0625 if case.startswith("line") else 0.0) ** 2 + 1e-12)
        np.testing.assert_allclose(g4[:, 0].numpy(), spec.min_obstacle_dist - d0, rtol=0,
                                   atol=1e-15)


def test_torch_footprint_ad_path_keeps_float32():
    """A rotating segment and polygon in float32: the AD path's KKT inputs
    stay float32 (the forward-mode tangent trap of
    ``test_torch_merit_derivatives_keep_float32``)."""
    for case in ("line_mixed_dynamic", "polygon_mixed_dynamic"):
        spec, scen, primal, duals = _cf_iterate(case, 32)
        scen, primal, duals = tree_map(
            lambda a: a.float() if a.is_floating_point() else a, (scen, primal, duals))
        cf, ad, _ = _closed_forms_and_ad(spec, scen, primal, duals)
        for name, a, b in zip(KKT_NAMES, cf, ad):
            assert a.dtype == b.dtype == torch.float32, (case, name)
            torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-3, msg=name)


@pytest.mark.parametrize("case", sorted(CF_CASES))
def test_torch_footprint_step_structure_matches_the_plain_tensors(case):
    spec, scen, primal, duals = _cf_iterate(case, 33)
    kkt, _, _ = _closed_forms_and_ad(spec, scen, primal, duals)
    structure = k2a.step_structure(spec)
    assert structure["Hzz"][2].split()[:3] == ["v", "v", "v"]  # θ rows live
    for name, a in zip(KKT_NAMES, kkt):
        if name not in structure:
            continue
        want = k2a.structure_rows(structure[name])
        a = a.reshape(a.shape[:2] + (len(want), len(want[0])))
        for i, row in enumerate(want):
            for j, c in enumerate(row):
                if c is not None:
                    assert bool((a[:, :, i, j] == c).all()), (name, i, j)


# --------------------------------------------------------------------------- #
# scope, family, parameters, operation count
# --------------------------------------------------------------------------- #
def test_torch_fused_scope_admits_line_and_polygon_footprints_up_to_8_vertices():
    spec = tb.config3_carlike_min_time(N=N, obstacle_cap=4)
    line = dataclasses.replace(spec, footprint=tfp.LineFootprint((-0.1, 0.0), (0.3, 0.0)))
    assert k2a.fused_supported(line)
    for n in (3, 4, 8):
        verts = tuple((0.3 * math.cos(2 * math.pi * i / n), 0.3 * math.sin(2 * math.pi * i / n))
                      for i in range(n))
        assert k2a.fused_supported(dataclasses.replace(spec, footprint=tfp.PolygonFootprint(verts)))
    nine = tuple((0.3 * math.cos(2 * math.pi * i / 9), 0.3 * math.sin(2 * math.pi * i / 9))
                 for i in range(9))
    wide = dataclasses.replace(spec, footprint=tfp.PolygonFootprint(nine))
    assert not k2a.fused_supported(wide)
    # JAX's scope agrees
    j_nine = dataclasses.replace(jb.config3_carlike_min_time(N=N, obstacle_cap=4),
                                 footprint=jfp.PolygonFootprint(nine))
    from mpc_local_planner_tpu.ops.fused_al_sqp_pallas import fused_supported as j_supported
    assert not j_supported(j_nine)
    st = al_sqp.SolverSettings(n_al=1, n_sqp=1)
    scen = tb.random_ensemble(spec, 2, torch.Generator().manual_seed(0), device="cpu")
    init, duals = al_sqp.default_init(wide, st, scen)
    with pytest.raises(NotImplementedError, match="a polygon footprint of 9 vertices "
                                                  r"\(at most 8\)"):
        k2a.fused_solve_plain(wide, st, scen, init, duals)
    assert not al_sqp.fused_dispatch_ok(wide, st, scen, torch.float32, "cuda")
    assert al_sqp.fused_dispatch_ok(line, st, scen, torch.float32, "cuda")


def test_torch_polygon_footprint_family_matches_jax():
    j, t = jb.family_spec("polygon_footprint", N=N), tb.family_spec("polygon_footprint", N=N)
    for f in dataclasses.fields(j):
        if f.name == "footprint":
            np.testing.assert_array_equal(np.asarray(t.footprint.vertices),
                                          np.asarray(j.footprint.vertices))
            assert type(t.footprint).__name__ == type(j.footprint).__name__
        elif f.name in ("model", "limits"):
            assert dataclasses.asdict(getattr(t, f.name)) == dataclasses.asdict(
                getattr(j, f.name)), f.name
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.footprint.vertices == FAMILY_RECT
    scen = tb.family_ensemble("polygon_footprint", t, 16, torch.Generator().manual_seed(0),
                              device="cpu")
    ref = tb.random_ensemble(t, 16, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(scen.obstacles.circles, ref.obstacles.circles)  # random_ensemble's
    assert k2a.fused_supported(t)


def test_torch_kernel_parameters_carry_the_footprint():
    st = al_sqp.SolverSettings(n_al=3, n_sqp=4)
    spec = tb.family_spec("polygon_footprint", N=N)
    scen = tb.family_ensemble("polygon_footprint", spec, 4, torch.Generator(), device="cpu")
    p = k2a._params(spec, st, scen.obstacles)
    assert (p.fp_kind, p.fp_nv, p.n_disc, p.Mc, p.Ml, p.Mg) == (2, 4, 1, 8, 0, 0)
    assert list(p.fp_v)[:8] == [c for v in FAMILY_RECT for c in v]
    assert list(p.fp_v)[8:] == [0.0] * 8 and list(p.disc_off) == [0.0, 0.0]
    line = dataclasses.replace(spec, footprint=tfp.LineFootprint((-0.1, 0.0), (0.35, 0.05)))
    p = k2a._params(line, st, scen.obstacles)
    assert (p.fp_kind, p.fp_nv) == (1, 2) and list(p.fp_v)[:4] == [-0.1, 0.0, 0.35, 0.05]
    disc = k2a._params(tb.family_spec("canonical_carlike", N=N), st, scen.obstacles)
    assert (disc.fp_kind, disc.fp_nv, disc.n_disc) == (0, 0, 2)


def test_torch_footprint_flops_count_the_chains():
    flagship = tb.config3_carlike_min_time(N=30, obstacle_cap=8)
    rect = tb.family_spec("polygon_footprint")
    circles = tb.family_ensemble("polygon_footprint", rect, 8, torch.Generator(), device="cpu")
    base = k2a.k2a_flops(flagship, 3, 4, 3)
    path_c = k2a.k2a_flops(rect, 3, 4, 3, circles.obstacles)
    assert path_c > 3 * base  # four moving edges per circle slot, with θ rows
    # what one pose shares is counted once: a circle slot more adds its
    # distance and crossing per edge and its sign and radius, not the
    # footprint's vertices or edge constants again; a value pass no θ term
    fp = rect.footprint
    assert k2a._footprint_flops(fp, 8, 0, 0, 0) == (2 + 4 * 8 + 4 * 5 + 8 * (4 * 18 + 2),
                                                    4 * 2 + 4 * 9 + 8 * (4 * 41 + 4))
    one_more = [b - a for a, b in zip(k2a._footprint_flops(fp, 8, 0, 0, 0),
                                      k2a._footprint_flops(fp, 9, 0, 0, 0))]
    assert one_more == [4 * (15 + 3) + 2, 4 * 41 + 4]
    assert path_c == 2_419_454  # the count PERF.md's path C bound uses
    octagon = dataclasses.replace(rect, footprint=tfp.PolygonFootprint(OCTAGON))
    assert k2a.k2a_flops(octagon, 3, 4, 3, circles.obstacles) > path_c
    line = dataclasses.replace(rect, footprint=tfp.LineFootprint((-0.1, 0.0), (0.35, 0.0)))
    assert base < k2a.k2a_flops(line, 3, 4, 3, circles.obstacles) < path_c
    # polygon slots count this run's active edges, pairs with the footprint's edges
    spec = dataclasses.replace(rect, obstacle_cap=2)
    few = tb.mixed_obstacles(8, torch.Generator(), mg=2, V=5, device="cpu")
    more = dataclasses.replace(few, polygon_nv=torch.full_like(few.polygon_nv, 5))
    fewer = dataclasses.replace(few, polygon_nv=torch.full_like(few.polygon_nv, 3))
    assert k2a.k2a_flops(spec, 3, 4, 3, more) > k2a.k2a_flops(spec, 3, 4, 3, fewer)
