"""The fused kernel's geometry (K2c) on the CPU, against the JAX package: the
two-disc footprint, line and polygon obstacle slots and dynamic obstacles.

- Every function of ``geometry/distances.py`` and the footprints'
  ``distances`` against JAX, values and gradients (``torch.func.grad``
  against ``jax.grad``), float64 at 1e-10 and float32 at 1e-5 (values) and
  1e-4 (gradients), on inputs drawn from a numpy seed with exact ties
  appended: a segment parameter exactly 0 and 1 (JAX's clip passes 0.5
  there), a point on a polygon vertex and one equally near two edges (an
  equal split among tied edges), a point equally near both discs of the
  two-disc footprint (the minimum splits 0.5/0.5), masked slots.
- Dynamic obstacles: the per-stage prediction and the obstacle rows against
  JAX's ``constraints.obstacle_inequalities`` at the trajectory's dt.
- The kernel's closed-form derivatives (``fused_kkt_system``) against the
  port's AD path (``al_sqp._kkt_system``) at 1e-10 in float64, for the
  two-disc footprint, line slots, polygon slots with a varying vertex count
  and dynamic obstacles of all four families, at random iterates and at
  iterates with the ties above on the trajectory.
- The scope (``OcpSpec``, ``fused_supported``, the dispatch), the families
  of ``benchmarks.py``, the step structure and the operation count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.geometry import distances as jd
from mpc_local_planner_tpu.geometry import footprints as jfp
from mpc_local_planner_tpu.ocp import constraints as jC
from mpc_local_planner_tpu.ops.fused_al_sqp_pallas import fused_supported as j_fused_supported

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.geometry import distances as td
from mpc_local_planner_tpu_torch.geometry import footprints as tfp
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet as TObstacleSet
from mpc_local_planner_tpu_torch.ocp import constraints as tC
from mpc_local_planner_tpu_torch.ocp.grid import Primal, initial_primal
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec, Scenario
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp

N = 8
TOL = {"f64": dict(value=1e-10, grad=1e-10), "f32": dict(value=1e-5, grad=1e-4)}
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}
KKT_NAMES = ("Fz", "Gz", "rz", "Hzz", "Hzu", "Huu", "hz", "hu", "PN", "pN")
# a two-disc footprint whose offsets are exact in binary, so that a point on
# the body's y axis is exactly as near to both discs
TIED_DISCS = dict(front_offset=0.25, front_radius=0.2, rear_offset=-0.25, rear_radius=0.2)
CANONICAL = dict(front_offset=0.15, front_radius=0.2, rear_offset=-0.15, rear_radius=0.2)


def _np(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: _np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


# --------------------------------------------------------------------------- #
# distance primitives
# --------------------------------------------------------------------------- #
def _primitive_inputs(np_dtype):
    """(p, q, a, b, verts, nv, verts2, nv2, values, mask): random rows, then
    rows with exact ties."""
    rng = np.random.default_rng(7)
    K, V = 12, 5
    p = rng.uniform(-1.0, 3.0, (K, 2))
    q = rng.uniform(-1.0, 3.0, (K, 2))
    a = rng.uniform(-1.0, 3.0, (K, 2))
    b = a + rng.uniform(-1.5, 1.5, (K, 2))
    center = rng.uniform(0.5, 2.0, (K, 1, 2))
    ang = np.sort(rng.uniform(0.0, 2 * np.pi, (K, V)), axis=-1)
    rad = rng.uniform(0.3, 0.9, (K, V))
    verts = center + np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1)
    nv = rng.integers(3, V + 1, K)
    verts2 = np.roll(verts, 3, axis=0) + 0.4
    nv2 = np.roll(nv, 5)
    square = np.array([[1.0, 1.0], [2.0, 1.0], [2.0, 2.0], [1.0, 2.0], [1.0, 2.0]])
    ties = [  # (p, a, b): t exactly 0; t exactly 1; p on the square's vertex;
        # p equally near the square's edges 3 and 0 (t = 1 and t = 0 at once)
        ((0.0, 0.5), (0.0, 1.0), (1.0, 1.0)),
        ((1.0, 0.5), (0.0, 1.0), (1.0, 1.0)),
        ((1.0, 1.0), (1.0, 1.0), (2.0, 1.0)),
        ((0.5, 0.5), (1.0, 1.0), (1.0, 2.0)),
    ]
    p = np.concatenate([p, [t[0] for t in ties]])
    q = np.concatenate([q, [(0.5, 0.5)] * len(ties)])
    a = np.concatenate([a, [t[1] for t in ties]])
    b = np.concatenate([b, [t[2] for t in ties]])
    verts = np.concatenate([verts, [square] * len(ties)])
    nv = np.concatenate([nv, [4] * len(ties)])
    verts2 = np.concatenate([verts2, [square + 1.5] * len(ties)])
    nv2 = np.concatenate([nv2, [4] * len(ties)])
    values = rng.uniform(0.0, 2.0, (len(p), 4))
    values[-1] = 1.0  # all tied
    mask = rng.uniform(size=values.shape) > 0.3
    mask[:, 0] = True
    f = lambda x: np.asarray(x, dtype=np_dtype)  # noqa: E731
    return (f(p), f(q), f(a), f(b), f(verts), nv.astype(np.int32), f(verts2),
            nv2.astype(np.int32), f(values), mask)


# name: (function of the torch module or the jax module, argument indices
# into _primitive_inputs, indices of the float arguments differentiated)
PRIMITIVES = {
    "point_to_segment": ("point_to_segment", (0, 2, 3), (0, 1, 2)),
    "segments_intersect": ("segments_intersect", (0, 1, 2, 3), ()),
    "segment_to_segment": ("segment_to_segment", (0, 1, 2, 3), (0, 1, 2, 3)),
    "point_to_polygon_signed": ("point_to_polygon_signed", (0, 4, 5), (0, 1)),
    "segment_to_polygon": ("segment_to_polygon", (0, 1, 4, 5), (0, 1, 2)),
    "polygon_to_polygon": ("polygon_to_polygon", (4, 5, 6, 7), (0, 2)),
    "polygon_edges": ("_polygon_edges", (4, 5), (0,)),
    "softmin": ("softmin", (8, 9), (0,)),
}


def _call(module, name, args):
    fn = getattr(module, name)
    out = fn(*args, 0.3) if name == "softmin" else fn(*args)
    return out


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("prim", sorted(PRIMITIVES))
def test_torch_distance_primitives_match_jax(prim, dtype_name):
    name, idx, diff = PRIMITIVES[prim]
    np_dtype, _ = DTYPES[dtype_name]
    inputs = _primitive_inputs(np_dtype)
    args = [inputs[i] for i in idx]
    tol = TOL[dtype_name]
    j_args = [jnp.asarray(x) for x in args]
    t_args = [torch.from_numpy(np.array(x)) for x in args]
    j_out = _call(jd, name, j_args)
    t_out = _call(td, name, t_args)
    j_leaves = j_out if isinstance(j_out, tuple) else (j_out,)
    t_leaves = t_out if isinstance(t_out, tuple) else (t_out,)
    for t, j in zip(t_leaves, j_leaves):
        j = np.asarray(j)
        assert t.dtype == torch.from_numpy(np.array(j)).dtype, prim
        if j.dtype == np.bool_:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=prim)
        else:
            np.testing.assert_allclose(t.numpy(), j, atol=tol["value"], rtol=0, err_msg=prim)
    if not diff:
        return

    def scalar(module, *xs):
        full = list(j_args if module is jd else t_args)
        for k, x in zip(diff, xs):
            full[k] = x
        out = _call(module, name, full)
        out = out[1] if isinstance(out, tuple) else out  # _polygon_edges: the wrapped ends
        return out.sum()

    j_grads = jax.grad(lambda *xs: scalar(jd, *xs), argnums=tuple(range(len(diff))))(
        *[jnp.asarray(args[k]) for k in diff]
    )
    t_in = [torch.from_numpy(np.array(args[k])) for k in diff]
    t_grads = torch.func.grad(lambda *xs: scalar(td, *xs), argnums=tuple(range(len(diff))))(*t_in)
    for k, (t, j) in enumerate(zip(t_grads, j_grads)):
        np.testing.assert_allclose(
            t.numpy(), np.asarray(j), atol=tol["grad"], rtol=0, err_msg=f"{prim} grad {k}"
        )


# --------------------------------------------------------------------------- #
# footprints over all four slot families, static and predicted
# --------------------------------------------------------------------------- #
def _obstacle_arrays(np_dtype, batch=(), seed=11):
    """An ObstacleSet as numpy arrays with all four families (2 of each, one
    masked; polygons of 5 padded vertices, 4 and 3 active), with
    velocities, and slots placed for the tie poses of ``_poses``."""
    rng = np.random.default_rng(seed)
    f = lambda x: np.asarray(x, dtype=np_dtype)  # noqa: E731
    sq = np.array([[1.0, 1.0], [2.0, 1.0], [2.0, 2.0], [1.0, 2.0], [1.0, 2.0]])
    tri = np.array([[-1.0, -1.0], [0.0, -1.5], [-0.5, -0.5], [0.0, 0.0], [0.0, 0.0]])
    arrays = dict(
        points=f([[0.0, 1.0], [2.5, 0.3]]), point_vels=f(rng.uniform(-0.4, 0.4, (2, 2))),
        point_mask=np.array([True, False]),
        circles=f([[3.0, 3.0], [-1.0, 2.0]]), circle_radii=f([0.3, 0.2]),
        circle_vels=f(rng.uniform(-0.4, 0.4, (2, 2))), circle_mask=np.array([True, True]),
        lines=f([[[0.0, -1.0], [1.0, -1.0]], [[3.0, 0.0], [3.0, 1.0]]]),
        line_vels=f(rng.uniform(-0.4, 0.4, (2, 2))), line_mask=np.array([True, False]),
        polygons=f([sq, tri]), polygon_nv=np.array([4, 3], dtype=np.int32),
        polygon_vels=f(rng.uniform(-0.4, 0.4, (2, 2))), polygon_mask=np.array([True, True]),
    )
    return {k: np.broadcast_to(v, batch + v.shape).copy() for k, v in arrays.items()}


def _poses(np_dtype):
    """Random poses, then tie poses: at (0, 0, 0) the point (0, 1) is
    exactly as near to both discs at ±0.25; (0, -0.5) meets the line (0,-1)
    → (1,-1) at t = 0 exactly; (0.5, 0.5) is equally near the square's two
    edges at its vertex (1, 1)."""
    rng = np.random.default_rng(12)
    poses = np.concatenate([
        rng.uniform(-1.0, 3.0, (9, 3)),
        [[0.0, 0.0, 0.0], [0.0, -0.5, 0.0], [0.5, 0.5, 0.0], [1.0, 1.0, 0.0]],
    ])
    return poses.astype(np_dtype)


FOOTPRINTS = {
    "point": (jfp.PointFootprint, tfp.PointFootprint, {}),
    "circular": (jfp.CircularFootprint, tfp.CircularFootprint, dict(radius=0.2)),
    "two_circles": (jfp.TwoCirclesFootprint, tfp.TwoCirclesFootprint, TIED_DISCS),
    "canonical": (jfp.TwoCirclesFootprint, tfp.TwoCirclesFootprint, CANONICAL),
}


@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("kind", sorted(FOOTPRINTS))
def test_torch_footprint_distances_match_jax(kind, dynamic, dtype_name):
    """Per-pose distances to every slot of all four families (and their
    pose gradients); dynamic: each pose against the set predicted to its
    own time (``predict_stages``)."""
    np_dtype, _ = DTYPES[dtype_name]
    jcls, tcls, kw = FOOTPRINTS[kind]
    jf, tf = jcls(**kw), tcls(**kw)
    poses = _poses(np_dtype)
    arrays = _obstacle_arrays(np_dtype)
    jo = jax.tree_util.tree_map(jnp.asarray, jfp.ObstacleSet(**arrays))
    to = convert.from_numpy(TObstacleSet, arrays, "cpu")
    tol = TOL[dtype_name]
    if dynamic:
        # each pose against the set predicted to its own time: JAX predicts
        # an unbatched set, the port a set with a lane axis
        times = np.linspace(0.0, 1.2, len(poses)).astype(np_dtype)
        jo = jo.predict_stages(jnp.asarray(times))
        t_pred = convert.from_numpy(
            TObstacleSet, {k: v[None] for k, v in arrays.items()}, "cpu"
        ).predict_stages(torch.from_numpy(times)[None])
        for name in ("points", "circles", "lines", "polygons", "polygon_nv", "line_mask"):
            np.testing.assert_allclose(
                getattr(t_pred, name)[0].numpy(), np.asarray(getattr(jo, name)),
                atol=tol["value"], rtol=0, err_msg=name,
            )
        to = TObstacleSet(*(getattr(t_pred, f.name)[0] for f in dataclasses.fields(TObstacleSet)))
    d_j = jf.distances(jnp.asarray(poses), jo)
    d_t = tf.distances(torch.from_numpy(poses), to)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=tol["value"], rtol=0)
    assert np.all(d_t.numpy()[:, [1, 5]] >= 1e6 - 1.0)  # the masked point and line slots
    g_j = jax.grad(lambda p: jf.distances(p, jo).sum())(jnp.asarray(poses))
    g_t = torch.func.grad(lambda p: tf.distances(p, to).sum())(torch.from_numpy(poses))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=tol["grad"], rtol=0)
    if kind == "two_circles" and not dynamic:
        # pose 9 is exactly as near to the point (0, 1) from both discs: the
        # minimum splits the heading gradient, which cancels
        front = tfp.CircularFootprint(0.2).distances(
            torch.tensor([[0.25, 0.0, 0.0], [-0.25, 0.0, 0.0]], dtype=d_t.dtype), to)
        assert front[0, 0] == front[1, 0]
        slot0 = torch.func.grad(lambda p: tf.distances(p, to)[0])(torch.from_numpy(poses[9]))
        assert slot0[2].item() == 0.0


def test_torch_footprint_factory_and_scope():
    assert isinstance(tfp.make_footprint("two_circles", **CANONICAL), tfp.TwoCirclesFootprint)
    line = tfp.make_footprint("line", line_start=(-0.1, 0.0), line_end=(0.35, 0.0))
    assert isinstance(line, tfp.LineFootprint) and line.line_end == (0.35, 0.0)
    rect = tfp.make_footprint("polygon", vertices=[[0.25, 0.15], [-0.25, 0.15], [-0.25, -0.15]])
    assert isinstance(rect, tfp.PolygonFootprint) and rect.vertices[1] == (-0.25, 0.15)
    with pytest.raises(ValueError, match="unknown footprint"):
        tfp.make_footprint("hexagon")
    spec = dataclasses.replace(
        tb.config3_carlike_min_time(N=N, obstacle_cap=4),
        footprint=tfp.TwoCirclesFootprint(**CANONICAL), enable_dynamic_obstacles=True,
    )
    assert k2a.fused_supported(spec)
    assert tfp.disc_footprint(spec.footprint) == ((0.15, 0.2), (-0.15, 0.2))
    # a footprint of no shipped class: the JAX spec admits it and JAX
    # fused_supported refuses it, and so does the port
    jother = dataclasses.replace(jb.config3_carlike_min_time(N=N, obstacle_cap=4),
                                 footprint=object())
    other = dataclasses.replace(spec, footprint=object())
    assert k2a.fused_supported(other) is j_fused_supported(jother) is False


@pytest.mark.parametrize("kind", ["circular", "canonical"])
def test_torch_dynamic_obstacle_rows_match_jax(kind):
    """``constraints.obstacle_inequalities`` with dynamic obstacles of all
    four families, each pose k at t = k·dt: the port on a lane batch (and a
    candidate axis in front) against JAX lane by lane; the pose gradient
    too, with dt held as stage data (no gradient)."""
    jcls, tcls, kw = FOOTPRINTS[kind]
    B = 3
    jspec = dataclasses.replace(jb.config3_carlike_min_time(N=N, obstacle_cap=8),
                                footprint=jcls(**kw), enable_dynamic_obstacles=True)
    tspec = dataclasses.replace(tb.config3_carlike_min_time(N=N, obstacle_cap=8),
                                footprint=tcls(**kw), enable_dynamic_obstacles=True)
    rng = np.random.default_rng(13)
    xs = rng.uniform(-1.0, 3.0, (B, N + 1, 3))
    dt = rng.uniform(0.1, 0.4, B)
    arrays = _obstacle_arrays(np.float64, batch=(B,))
    jo = jax.tree_util.tree_map(jnp.asarray, jfp.ObstacleSet(**arrays))
    tscen = Scenario(
        x0=torch.zeros(B, 3, dtype=torch.float64), xf=torch.zeros(B, 3, dtype=torch.float64),
        obstacles=convert.from_numpy(TObstacleSet, arrays, "cpu"),
        via_points=torch.zeros(B, 0, 3, dtype=torch.float64),
        via_mask=torch.zeros(B, 0, dtype=torch.bool), u_prev=torch.zeros(B, 2, dtype=torch.float64),
    )

    def j_rows(xs_b, dt_b, o_b):
        scen = jb.Scenario(x0=jnp.zeros(3), xf=jnp.zeros(3), obstacles=o_b,
                           via_points=jnp.zeros((0, 3)), via_mask=jnp.zeros((0,), bool),
                           u_prev=jnp.zeros(2))
        return jC.obstacle_inequalities(jspec, xs_b, dt_b, scen)

    g_j = jax.vmap(j_rows)(jnp.asarray(xs), jnp.asarray(dt), jo)
    g_t = tC.obstacle_inequalities(tspec, torch.from_numpy(xs), torch.from_numpy(dt), tscen)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-10, rtol=0)
    # candidates in front of the lane axis: the same rows per candidate
    xs2 = torch.from_numpy(np.stack([xs, xs + 0.1]))
    dt2 = torch.from_numpy(np.stack([dt, dt * 1.5]))
    g2 = tC.obstacle_inequalities(tspec, xs2, dt2, tscen)
    g_j2 = jax.vmap(j_rows)(jnp.asarray(xs + 0.1), jnp.asarray(dt * 1.5), jo)
    np.testing.assert_allclose(g2[0].numpy(), g_t.numpy(), atol=0, rtol=0)
    np.testing.assert_allclose(g2[1].numpy(), np.asarray(g_j2), atol=1e-10, rtol=0)
    gx_j = jax.grad(lambda x, d: jax.vmap(j_rows)(x, d, jo).sum(), argnums=(0, 1))(
        jnp.asarray(xs), jnp.asarray(dt))
    gx_t = torch.func.grad(
        lambda x, d: tC.obstacle_inequalities(tspec, x, d, tscen).sum(), argnums=(0, 1)
    )(torch.from_numpy(xs), torch.from_numpy(dt))
    for t, j in zip(gx_t, gx_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-10, rtol=0)
    assert float(torch.abs(gx_t[1]).max()) == 0.0  # dt is stage data


# --------------------------------------------------------------------------- #
# closed forms against the AD path (float64)
# --------------------------------------------------------------------------- #
CF_CASES = {
    # footprint, slot families, dynamic
    "two_circles": (tfp.TwoCirclesFootprint(**CANONICAL), dict(mp=1, mc=3), False),
    "lines": (tfp.CircularFootprint(0.2), dict(mc=2, ml=3), False),
    "polygons": (tfp.CircularFootprint(0.15), dict(mc=1, mg=2, V=5, vary_nv=True), False),
    "dynamic": (tfp.TwoCirclesFootprint(**CANONICAL),
                dict(mp=1, mc=2, ml=2, mg=1, V=4, dynamic=True), True),
}


def _place_near(obs, xs, rng):
    """Move the slots onto the trajectory (stages 2-5 and x_N), so that
    their rows are active."""
    T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))  # noqa: E731
    B = xs.shape[0]
    at = lambda k: xs[:, k, :2] + T(0.15 * rng.normal(size=(B, 2)))  # noqa: E731
    upd = {}
    if obs.points.shape[1]:
        upd["points"] = torch.stack([at(3 + i % 2 * (N - 3)) for i in range(obs.points.shape[1])], 1)
    if obs.circles.shape[1]:
        mc = obs.circles.shape[1]
        upd["circles"] = torch.stack([at(N if i == mc - 1 else 2 + i) for i in range(mc)], 1)
    if obs.lines.shape[1]:
        mids = torch.stack([at(3 + i) for i in range(obs.lines.shape[1])], 1)
        half = T(0.4 * rng.normal(size=mids.shape))
        upd["lines"] = torch.stack([mids - half, mids + half], 2)
    if obs.polygons.shape[1]:
        shift = torch.stack([at(4 + i) for i in range(obs.polygons.shape[1])], 1)
        upd["polygons"] = obs.polygons - obs.polygons.mean(dim=2, keepdim=True) + shift[:, :, None]
    return dataclasses.replace(obs, **upd)


def _cf_iterate(case, seed, ties=False, batch=6):
    """A float64 iterate of the flagship with the case's footprint and slots
    placed on the trajectory; with ``ties``: a point obstacle exactly as
    near to both discs at stage 4 (TIED_DISCS, θ = 0), a line met at t = 0
    exactly at stage 5, a polygon vertex equally near two edges at stage 6,
    each row's multiplier making μ + ρg > 0."""
    fp, fam, dyn = CF_CASES[case]
    M = sum(fam.get(k, 0) for k in ("mp", "mc", "ml", "mg"))
    spec = dataclasses.replace(tb.config3_carlike_min_time(N=N, obstacle_cap=M), footprint=fp,
                               enable_dynamic_obstacles=dyn)
    gen = torch.Generator().manual_seed(seed)
    scen = tb.random_ensemble(dataclasses.replace(spec, obstacle_cap=0), batch, gen,
                              dtype=torch.float64, device="cpu")
    obs = tb.mixed_obstacles(batch, gen, dtype=torch.float64, device="cpu", **fam)
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
        m[:, :1] = True  # the first slot of each family is live
    obs = dataclasses.replace(obs, **mask)
    if ties:
        if case == "two_circles":
            spec = dataclasses.replace(spec, footprint=tfp.TwoCirclesFootprint(**TIED_DISCS))
            xs[:, 4] = T([1.0, 0.5, 0.0])
            points = obs.points.clone()
            points[:, 0] = T([1.0, 0.75])
            obs = dataclasses.replace(obs, points=points)
        if case == "lines":
            xs[:, 5] = T([1.0, 0.5, 0.25])
            lines = obs.lines.clone()
            lines[:, 0] = T([[1.0, 0.75], [2.0, 0.75]])
            obs = dataclasses.replace(obs, lines=lines)
        if case == "polygons":
            xs[:, 6] = T([0.5, 0.5, 0.1])
            polys = obs.polygons.clone()
            polys[:, 0, :4] = T([[0.75, 0.75], [1.5, 0.75], [1.5, 1.5], [0.75, 1.5]])
            nv = obs.polygon_nv.clone()
            nv[:, 0] = 4
            obs = dataclasses.replace(obs, polygons=polys, polygon_nv=nv)
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


def _closed_forms_and_ad(spec, scen, primal, duals):
    obs_k = al_sqp._stage_obstacles(spec, scen, primal.dt, N + 1)
    ad = al_sqp._kkt_system(
        spec, al_sqp._make_stage_fns(spec), al_sqp._make_terminal_fns(spec),
        primal, scen, duals, obs_k,
    )
    return k2a.fused_kkt_system(spec, primal, scen, duals, obs_k), ad, obs_k


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("case", sorted(CF_CASES))
def test_torch_k2c_closed_forms_match_the_ad_path(case, ties):
    spec, scen, primal, duals = _cf_iterate(case, 21, ties=ties)
    cf, ad, obs_k = _closed_forms_and_ad(spec, scen, primal, duals)
    for name, a, b in zip(KKT_NAMES, cf, ad):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64, name
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0, msg=name)
    hzz, pN_hess = cf[3], cf[8]
    g, grad = k2a.obstacle_rows(spec, primal.xs[:, 1:], tree_map(lambda a: a[:, 1:], obs_k))
    live = duals.mu_obs + duals.rho[:, None, None] * g > 0  # rows of stage k+1
    assert bool(live.any())
    if case in ("two_circles", "dynamic"):
        # the discs sit off the pose: the θ rows of the pose block are live
        assert bool((hzz[:, 1:, 2, 2] > 0).any()) and bool((pN_hess[:, 0, 2] != 0).any())
    else:
        assert bool((hzz[:, :, :3, 2] == 0).all())
    if ties:
        k = {"two_circles": 4, "lines": 5, "polygons": 6}.get(case)
        if k is not None:
            g_k, grad_k = k2a.obstacle_rows(spec, primal.xs[:, k], tree_map(lambda a: a[:, k], obs_k))
            j = {"two_circles": 0, "lines": spec.obstacle_cap - 3, "polygons": 1}[case]
            if case == "two_circles":
                # the discs tie: the heading gradient of the row cancels
                assert bool((grad_k[:, j, 2] == 0).all())
            if case == "lines":
                # met at t == 0 exactly, 0.25 from the pose
                np.testing.assert_allclose(g_k[:, j].numpy(), 0.1 - (0.25 - 0.2), atol=1e-10)
            if case == "polygons":
                # at the vertex (0.75, 0.75) both edges are tied, t = 1 and t = 0
                d = 0.25 * np.sqrt(2.0)
                np.testing.assert_allclose(g_k[:, j].numpy(), 0.1 - (d - 0.15), atol=1e-12)


@pytest.mark.parametrize("case", sorted(CF_CASES))
def test_torch_k2c_step_structure_matches_the_plain_tensors(case):
    spec, scen, primal, duals = _cf_iterate(case, 22)
    kkt, _, _ = _closed_forms_and_ad(spec, scen, primal, duals)
    structure = k2a.step_structure(spec)
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
# scope, families, operation count, the wrapper's checks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["flagship", "canonical_carlike", "converter_lines"])
def test_torch_family_spec_matches_jax(name):
    j, t = jb.family_spec(name, N=N), tb.family_spec(name, N=N)
    for f in dataclasses.fields(OcpSpec):
        if f.name in ("model", "footprint", "limits"):
            assert dataclasses.asdict(getattr(t, f.name)) == dataclasses.asdict(
                getattr(j, f.name)), f.name
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert type(t.footprint).__name__ == type(j.footprint).__name__


@pytest.mark.parametrize("name, item", [("nonuniform", "K2f")])
def test_torch_family_spec_names_what_waits(name, item):
    """No family of the JAX package's ``FAMILY_NAMES`` waits any more: the
    last one, the non-uniform grid (kernel branch ``item``), matches JAX's
    spec, and a name JAX does not know raises naming it."""
    assert name in jb.FAMILY_NAMES and item == "K2f"
    j, t = jb.family_spec(name, N=N), tb.family_spec(name, N=N)
    assert t.nonuniform_dt and t.variable_dt
    for f in dataclasses.fields(OcpSpec):
        if f.name not in ("model", "footprint", "limits"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    for family in jb.FAMILY_NAMES:
        tb.family_spec(family, N=N)
    with pytest.raises(ValueError, match="unknown family 'shooting'"):
        tb.family_spec("shooting", N=N)


def test_torch_wall_ensemble_has_the_jax_layout():
    """The wall sampler draws other numbers than ``jax.random`` but the same
    layout: 6 line slots of 0.8 m walls across the corridor, no circle slot,
    masks where the wall sits off the straight line."""
    spec = tb.family_spec("converter_lines", N=N)
    t = tb.family_ensemble("converter_lines", spec, 64, torch.Generator().manual_seed(0),
                           device="cpu")
    j = jb.family_ensemble("converter_lines", jb.family_spec("converter_lines", N=N), 64,
                           jax.random.PRNGKey(0))
    for name, a in _np(j.obstacles).items():
        b = getattr(t.obstacles, name)
        assert tuple(b.shape)[1:] == a.shape[1:] and str(b.dtype).split(".")[-1] == str(
            a.dtype).replace("bool", "bool"), name
    length = torch.linalg.norm(t.obstacles.lines[:, :, 1] - t.obstacles.lines[:, :, 0], dim=-1)
    np.testing.assert_allclose(length.numpy(), 0.8, atol=1e-6)
    assert 0.3 < float(t.obstacles.line_mask.float().mean()) < 0.8
    assert not bool(tb.family_ensemble("canonical_carlike", tb.family_spec("canonical_carlike"),
                                       4, torch.Generator(), device="cpu").obstacles.lines.numel())


def test_torch_mixed_obstacles_layout():
    o = tb.mixed_obstacles(40, torch.Generator().manual_seed(1), mp=1, mc=2, ml=2, mg=3, V=5,
                           dynamic=True, vary_nv=True, device="cpu")
    assert o.polygons.shape == (40, 3, 5, 2) and o.polygon_nv.dtype == torch.int32
    assert int(o.polygon_nv.min()) == 3 and int(o.polygon_nv.max()) == 5
    assert float(torch.abs(o.line_vels).max()) > 0.0
    static = tb.mixed_obstacles(4, torch.Generator(), mc=2, device="cpu")
    assert float(torch.abs(static.circle_vels).max()) == 0.0


def test_torch_k2c_dispatch_and_wrapper_checks():
    spec = dataclasses.replace(
        tb.config3_carlike_min_time(N=N, obstacle_cap=7),
        footprint=tfp.TwoCirclesFootprint(**CANONICAL), enable_dynamic_obstacles=True,
    )
    st = al_sqp.SolverSettings(n_al=3, n_sqp=4)
    gen = torch.Generator().manual_seed(3)
    scen = tb.random_ensemble(dataclasses.replace(spec, obstacle_cap=0), 4, gen, device="cpu")
    obs = tb.mixed_obstacles(4, gen, mp=1, mc=2, ml=2, mg=2, V=6, dynamic=True, device="cpu")
    scen = dataclasses.replace(scen, obstacles=obs)
    assert al_sqp.fused_dispatch_ok(spec, st, scen, torch.float32, "cuda")
    init, duals = al_sqp.default_init(spec, st, scen)
    ins, outs = k2a.kernel_io(spec, scen, init, duals)
    assert len(ins) == 26 and ins[13].dtype == torch.int32
    with pytest.raises(ValueError, match="3\\+2\\+2 obstacle slots, the spec has M=6"):
        k2a.kernel_io(dataclasses.replace(spec, obstacle_cap=6), scen, init, duals)
    wrong_nv = dataclasses.replace(obs, polygon_nv=obs.polygon_nv.long())
    with pytest.raises(TypeError, match="polygon_nv is torch.int64"):
        k2a.kernel_io(spec, dataclasses.replace(scen, obstacles=wrong_nv), init, duals)
    params = k2a._params(spec, st, obs)
    assert (params.Mc, params.Ml, params.Mg, params.V, params.n_disc, params.dynamic) == (
        3, 2, 2, 6, 2, 1)
    assert list(params.disc_off) == [0.15, -0.15]
    wide = dataclasses.replace(obs, polygons=torch.zeros(4, 2, 17, 2))
    with pytest.raises(NotImplementedError, match="17 padded vertices"):
        k2a.fused_solve_plain(spec, st, dataclasses.replace(scen, obstacles=wide), init, duals)


def test_torch_k2c_flops_count_the_geometry():
    flagship = tb.config3_carlike_min_time(N=30, obstacle_cap=8)
    base = k2a.k2a_flops(flagship, 3, 4, 3)
    assert base == 788_378  # unchanged by the geometry's count
    canonical = tb.family_spec("canonical_carlike")
    assert k2a.k2a_flops(canonical, 3, 4, 3) > base  # two discs, the θ chain
    lines = tb.family_spec("converter_lines")
    walls = tb.family_ensemble("converter_lines", lines, 8, torch.Generator(), device="cpu")
    circles6 = k2a.k2a_flops(lines, 4, 4, 3)
    assert k2a.k2a_flops(lines, 4, 4, 3, walls.obstacles) > circles6
    dyn = dataclasses.replace(lines, enable_dynamic_obstacles=True)
    assert k2a.k2a_flops(dyn, 4, 4, 3, walls.obstacles) > k2a.k2a_flops(lines, 4, 4, 3,
                                                                           walls.obstacles)
    # polygons count this run's active edges
    spec = dataclasses.replace(flagship, obstacle_cap=2)
    few = tb.mixed_obstacles(8, torch.Generator(), mg=2, V=5, device="cpu")
    more = dataclasses.replace(few, polygon_nv=torch.full_like(few.polygon_nv, 5))
    fewer = dataclasses.replace(few, polygon_nv=torch.full_like(few.polygon_nv, 3))
    assert k2a.k2a_flops(spec, 3, 4, 3, more) > k2a.k2a_flops(spec, 3, 4, 3, fewer)


def test_torch_kkt_rounding_covers_the_riccati_conditioning():
    """One ulp on the KKT inputs of each iteration (``agreement.
    kkt_roundings``) moves the plain version where one ulp on its states
    does not: on lane 2 of this dynamic line-slot case (a float32 warm
    state, the trust-capped dt step 0.3·dt) the Riccati sweep amplifies the
    rounding of its own inputs a thousand times more than that of the
    states. A kernel that forms those inputs in another order differs from
    the plain version by that much (on the card, PERF.md §6), so the f64
    check counts both moves as the plain version's own."""
    g = torch.Generator().manual_seed(2)
    spec = dataclasses.replace(
        tb.config3_carlike_min_time(N=30, obstacle_cap=5),
        footprint=tfp.CircularFootprint(0.2), enable_dynamic_obstacles=True,
    )
    scen = tb.random_ensemble(dataclasses.replace(spec, obstacle_cap=0), 128, g, device="cpu")
    scen = dataclasses.replace(scen, obstacles=tb.mixed_obstacles(
        128, g, device="cpu", mc=2, ml=3, dynamic=True))
    scen = tree_map(lambda a: a[:8].contiguous(), scen)
    st = al_sqp.SolverSettings(n_al=3, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3,
                               tol_ineq=1e-3, alphas=(1.0, 0.5, 0.22))
    init, duals = al_sqp.default_init(spec, st, scen)
    for _ in range(2):
        r = k2a.fused_solve_plain(spec, st, scen, init, duals)
        init, duals = r.primal, al_sqp.shift_duals(r.duals, st, 0)
    scen, init, duals = tree_map(
        lambda a: a.double() if a.is_floating_point() else a, (scen, init, duals))
    one = dataclasses.replace(st, n_al=1, n_sqp=1)
    plain = lambda i, **kw: k2a.fused_solve_plain(spec, one, scen, i, duals, **kw)  # noqa: E731
    out_p = plain(init)
    outs_q, outs_r, _ = agreement.plain_runs(plain, init)

    def moves(outs):
        return torch.stack([agreement._rel_errs(q, out_p).amax(dim=0) for q in outs]).amax(dim=0)

    sens_x, sens_r = moves(outs_q), moves(outs_r)
    assert float(sens_r[2]) > 100.0 * float(sens_x[2]) + 1e-12
    assert float(sens_r[2]) < agreement.CHAOTIC  # a determined lane, held to its bound
    others = torch.arange(8) != 2
    assert bool((sens_r[others] < 1e-9).all())  # the other lanes stay tight


def test_torch_empty_slot_families_add_no_work(monkeypatch):
    """A scenario with only point and circle slots (the flagship's) computes
    no segment or polygon distance, in the AD path's footprints and in the
    kernel's plain version: the un-fused flagship keeps its launch count."""
    def refuse(*args, **kwargs):
        raise AssertionError("a slot family with no slot was computed")

    for module, name in ((tfp, "point_to_segment"), (tfp, "point_to_polygon_signed"),
                         (k2a, "_point_seg"), (k2a, "_polygon_rows")):
        monkeypatch.setattr(module, name, refuse)
    spec = tb.config3_carlike_min_time(N=N, obstacle_cap=8)
    scen = tb.random_ensemble(spec, 3, torch.Generator().manual_seed(0), device="cpu")
    pose = torch.zeros(3, 3)
    assert spec.footprint.distances(pose, scen.obstacles).shape == (3, 8)
    g, grad = k2a.obstacle_rows(spec, pose, scen.obstacles)
    assert g.shape == (3, 8) and grad.shape == (3, 8, 3)
