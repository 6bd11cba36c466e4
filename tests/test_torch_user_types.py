"""User-defined models and footprints, and polygon footprints of 1 and 2
vertices, on the CPU against the JAX package.

The JAX spec checks neither the model nor the footprint: a model is any
object with ``f``, ``control_dim`` and the two bound maps, a footprint any
object with ``distances``, and JAX ``fused_supported`` sends a model to the
fused kernel only by its exact type and a footprint by ``isinstance`` (so a
subclass of a shipped footprint runs there on its base class's fields). The
port does the same:

- a subclass of ``UnicycleModel`` whose ``f`` is half the unicycle's and a
  model that subclasses ``BaseRobotSE2`` directly, on config #2 (N=8, 2
  slots, 4 lanes, goals pulled in to 20% of their distance), a 2-vertex
  polygon footprint and a ``CircularFootprint`` subclass with its own
  ``distances`` on config #3's circle slots (16 lanes, goals at 40%), one
  slot beside each path: the port's ``make_solver(device="cpu")`` against
  JAX ``vmap(solve_single)`` at a 4×4 budget from the straight-line seed,
  float64, every lane at the f64 parity
  rule of ``tests/test_torch_nonuniform_solves.py`` (xs, us, dt and cost
  1e-9, the multipliers 1e-9 + ρ·1e-13 + ten times JAX's own one-ulp move
  on the lane, equal conv flags; tighter than the north star's 5e-5 and
  5e-3);
- the polygon footprints of 2 and 1 vertices: the 2-vertex polygon's
  distances to circle slots are exactly the minimum of ``LineFootprint``'s
  over the segment's two directions (its two edges; their crossings
  cancel), the 1-vertex polygon's exactly ``PointFootprint``'s at the
  vertex, both within 1e-12 of JAX's ``PolygonFootprint``; the fused
  kernel's plain version ``fused_solve_plain`` at 1 and 2 vertices against
  the port's un-fused solve, the slot nearer the path, at the f64 rule of
  ``tests/test_torch_footprints_lp_solves.py`` (as above without the
  one-ulp move);
- the routing grid: the four models, a subclass of each and a direct
  ``BaseRobotSE2`` model, crossed with the five footprints, a subclass of
  each and polygons of 1, 2, 8 and 9 vertices: the port's
  ``fused_supported`` equals JAX's on every case, an admitted spec builds
  the kernel's parameters with JAX ``_footprint_static``'s geometry, a
  refused one is refused by the plain version too;
- ``benchmarks.FAMILY_NAMES`` equals JAX's, and ``family_spec`` builds each;
- the members a user's model inherits from ``BaseRobotSE2``: each model of
  the grid has JAX's ``continuous_time`` and ``equilibrium_control()`` zeros
  of ``(control_dim,)`` (in torch's default dtype, float32 unless
  ``torch.set_default_dtype`` says otherwise, as JAX's follows x64; JAX's
  dtype is not compared, as this suite turns on x64), a ``BaseRobotSE2`` subclass without
  ``control_bounds`` makes ``OcpSpec.control_box()`` raise
  ``NotImplementedError`` in both packages, and ``Primal.batch_shape()``
  equals JAX's on both grids at the batch shapes (), (4,) and (2, 3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.geometry import footprints as jfp
from mpc_local_planner_tpu.ocp.grid import Primal as JPrimal
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.ocp.spec import OcpSpec as JOcpSpec
from mpc_local_planner_tpu.ops import fused_al_sqp_pallas as j_fused
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.systems import base as j_base
from mpc_local_planner_tpu.systems import models as jm

from test_torch_cycle import _to_jax
from test_torch_footprints_lp_solves import _assert_f64_matches
from test_torch_nonuniform_solves import _J_TYPES, _assert_f64_matches_to_rounding, _jax_own_move
from test_torch_quadratic import np_tree, to_torch
from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.geometry import footprints as tfp
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
from mpc_local_planner_tpu_torch.ocp.grid import Primal as TPrimal
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.solvers import al_sqp
from mpc_local_planner_tpu_torch.systems import base as t_base
from mpc_local_planner_tpu_torch.systems import models as tm

N = 8
SETTINGS = dict(n_al=4, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
                alphas=(1.0, 0.5, 0.22))
SEGMENT = ((-0.25, 0.0), (0.25, 0.0))
RECTANGLE = ((0.25, 0.15), (-0.25, 0.15), (-0.25, -0.15), (0.25, -0.15))


# --------------------------------------------------------------------------- #
# user-defined types, each in both packages
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class JHalfUnicycle(jm.UnicycleModel):
    """A unicycle at half speed."""

    def f(self, x, u):
        return 0.5 * super().f(x, u)


@dataclasses.dataclass(frozen=True)
class THalfUnicycle(tm.UnicycleModel):
    def f(self, x, u):
        return 0.5 * super().f(x, u)


@dataclasses.dataclass(frozen=True)
class JSlewingDrive(j_base.BaseRobotSE2):
    """A differential drive whose heading rate is ``turn`` times the command
    and which slips sideways in proportion to it."""

    turn: float = 0.8
    slip: float = 0.1
    control_dim = 2

    def f(self, x, u):
        th, v, om = x[..., 2], u[..., 0], u[..., 1]
        side = self.slip * om
        return jnp.stack([v * jnp.cos(th) - side * jnp.sin(th),
                          v * jnp.sin(th) + side * jnp.cos(th), self.turn * om], axis=-1)

    def control_bounds(self, limits):
        return (jnp.array([-limits.max_vel_x_backwards, -limits.max_vel_theta]),
                jnp.array([limits.max_vel_x, limits.max_vel_theta]))

    def control_rate_bounds(self, limits):
        return jnp.full((2,), -jnp.inf), jnp.full((2,), jnp.inf)


@dataclasses.dataclass(frozen=True)
class TSlewingDrive(t_base.BaseRobotSE2):
    turn: float = 0.8
    slip: float = 0.1
    control_dim = 2

    def f(self, x, u):
        th, v, om = x[..., 2], u[..., 0], u[..., 1]
        side = self.slip * om
        return torch.stack([v * torch.cos(th) - side * torch.sin(th),
                            v * torch.sin(th) + side * torch.cos(th), self.turn * om], dim=-1)

    def control_bounds(self, limits):
        return (torch.tensor([-limits.max_vel_x_backwards, -limits.max_vel_theta],
                             dtype=torch.float64),
                torch.tensor([limits.max_vel_x, limits.max_vel_theta], dtype=torch.float64))

    def control_rate_bounds(self, limits):
        return (torch.full((2,), -torch.inf, dtype=torch.float64),
                torch.full((2,), torch.inf, dtype=torch.float64))


@dataclasses.dataclass(frozen=True)
class JPaddedDisc(jfp.CircularFootprint):
    """A disc that keeps ``pad`` more clearance than its radius."""

    pad: float = 0.05

    def distances(self, pose, obs):
        return super().distances(pose, obs) - self.pad


@dataclasses.dataclass(frozen=True)
class TPaddedDisc(tfp.CircularFootprint):
    pad: float = 0.05

    def distances(self, pose, obs):
        return super().distances(pose, obs) - self.pad


def _subclass(base):
    """A frozen-dataclass subclass of ``base`` that changes nothing."""
    return dataclasses.dataclass(frozen=True)(type("User" + base.__name__, (base,), {}))


# --------------------------------------------------------------------------- #
# whole solves against JAX vmap(solve_single)
# --------------------------------------------------------------------------- #
# case: (base config, batch, ensemble key, goal pull, the first circle slot's
# lateral offset from the path's midpoint (metres; a pair spreads it over
# the lanes), (JAX, port) model or None, (JAX, port) footprint or None)
SOLVE_CASES = {
    "unicycle_subclass": ("config2", 4, 5, 0.2, 0.6, (JHalfUnicycle(), THalfUnicycle()), None),
    "base_se2_model": ("config2", 4, 5, 0.2, 0.6, (JSlewingDrive(), TSlewingDrive()), None),
    "polygon_2_vertices": ("config3", 16, 0, 0.4, (0.3, 0.8), None,
                           (jfp.PolygonFootprint(SEGMENT), tfp.PolygonFootprint(SEGMENT))),
    "circular_subclass": ("config3", 16, 0, 0.4, (0.3, 0.8), None,
                          (JPaddedDisc(0.2), TPaddedDisc(0.2))),
}


def _specs(case):
    config, *_, model, footprint = SOLVE_CASES[case]
    if config == "config2":
        jspec = jb.config2_diffdrive_obstacles(N=N, obstacle_cap=2)
        tspec = tb.config2_diffdrive_obstacles(N=N, obstacle_cap=2)
    else:
        jspec = jb.config3_carlike_min_time(N=N, obstacle_cap=4)
        tspec = tb.config3_carlike_min_time(N=N, obstacle_cap=4)
    for pair, field in ((model, "model"), (footprint, "footprint")):
        if pair is not None:
            jspec = dataclasses.replace(jspec, **{field: pair[0]})
            tspec = dataclasses.replace(tspec, **{field: pair[1]})
    return jspec, tspec


def _beside_path(scen, lateral):
    """``scen`` (a numpy tree) with its first circle slot beside the
    straight path's midpoint, ``lateral`` metres to the left (a pair
    spreads the offset over the lanes), so that the obstacle rows are
    live."""
    x0, xf = scen["x0"], scen["xf"]
    d = xf[:, :2] - x0[:, :2]
    normal = np.stack([-d[:, 1], d[:, 0]], axis=-1) / np.linalg.norm(d, axis=-1)[:, None]
    if isinstance(lateral, tuple):
        lateral = np.linspace(*lateral, len(x0))[:, None]
    obs = dict(scen["obstacles"], circles=scen["obstacles"]["circles"].copy(),
               circle_mask=scen["obstacles"]["circle_mask"].copy())
    obs["circles"][:, 0] = x0[:, :2] + 0.5 * d + lateral * normal
    obs["circle_mask"][:, 0] = True
    return dict(scen, obstacles=obs)


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """The inputs (numpy trees: ``random_ensemble``'s scenarios, the goals
    pulled in, one slot ``_beside_path``), JAX's float64 solve from them
    and, per lane, the largest move of JAX's multipliers when its solve
    starts from states one ulp up and down."""
    _, batch, key, pull, lateral, _, _ = SOLVE_CASES[case]
    jspec, _ = _specs(case)
    scen = jb.random_ensemble(jspec, batch, jax.random.PRNGKey(key), dtype=jnp.float64)
    scen = dataclasses.replace(scen, xf=scen.x0 + pull * (scen.xf - scen.x0))
    scen = _beside_path(np_tree(scen), lateral)
    jst = j_al.SolverSettings(**SETTINGS)
    init = np_tree(j_initial_primal(jspec, _to_jax(_J_TYPES[0], scen)))
    duals = np_tree(jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
        j_al.init_duals(jspec, jst, jnp.float64)))
    solve = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, jst, s, i, d)))
    inputs = (scen, init, duals)
    out = np_tree(solve(*(_to_jax(c, a) for c, a in zip(_J_TYPES, inputs))))
    return inputs, out, _jax_own_move(solve, *inputs, out)


def _port_solve(spec, inputs, path="unfused"):
    st = al_sqp.SolverSettings(**SETTINGS)
    args = to_torch(*inputs)
    if path == "unfused":
        solve = al_sqp.make_solver(spec, st, device="cpu")
    else:
        solve = functools.partial(k2a.fused_solve_plain, spec, st)
    before = riccati_cuda.lqr_solve_cuda.launches
    out = convert.to_numpy(solve(*args))
    assert riccati_cuda.lqr_solve_cuda.launches == before  # CPU: the plain KKT solve
    return out


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_torch_user_types_solve_like_jax(case):
    jspec, tspec = _specs(case)
    inputs, j, move = _jax_case(case)
    t = _port_solve(tspec, inputs)
    _assert_f64_matches_to_rounding(t, j, move)
    assert j["converged"].any() and (j["duals"]["mu_obs"] > 0).any()
    # the routing of a float32 CUDA solve, decided without a card: exactly as
    # JAX's, so the model subclasses take the un-fused path and the
    # footprints the kernel
    scen = to_torch(*inputs)[0]
    admitted = al_sqp.fused_dispatch_ok(
        tspec, al_sqp.SolverSettings(**SETTINGS), scen, torch.float32, torch.device("cuda"))
    assert admitted == j_fused.fused_supported(jspec) == (SOLVE_CASES[case][5] is None)


# --------------------------------------------------------------------------- #
# polygon footprints of 2 and 1 vertices
# --------------------------------------------------------------------------- #
def _poses(scen, rng, n=8):
    """The lanes' starts and goals and ``n`` sets of random poses among the
    slots, one pose a lane each."""
    lanes = scen.x0.shape[0]
    out = [scen.x0, scen.xf]
    for _ in range(n):
        out.append(np.concatenate([rng.uniform(-0.5, 2.5, (lanes, 2)),
                                   rng.uniform(-4.0, 4.0, (lanes, 1))], axis=-1))
    return [np.array(p, dtype=np.float64) for p in out]


@pytest.mark.parametrize("vertices", [1, 2])
def test_torch_few_vertex_polygon_distances(vertices):
    jspec = jb.config3_carlike_min_time(N=N, obstacle_cap=4)
    scen = jb.random_ensemble(jspec, 16, jax.random.PRNGKey(0), dtype=jnp.float64)
    tobs = convert.from_numpy(ObstacleSet, np_tree(scen.obstacles), "cpu")
    verts = SEGMENT if vertices == 2 else ((0.1, -0.05),)
    tpoly, jpoly = tfp.PolygonFootprint(verts), jfp.PolygonFootprint(verts)
    for pose in _poses(scen, np.random.default_rng(vertices)):
        tp = torch.from_numpy(pose)
        d = tpoly.distances(tp, tobs)
        if vertices == 2:
            want = torch.minimum(tfp.LineFootprint(*SEGMENT).distances(tp, tobs),
                                 tfp.LineFootprint(*SEGMENT[::-1]).distances(tp, tobs))
        else:  # the point at the vertex
            c, s = np.cos(pose[:, 2]), np.sin(pose[:, 2])
            at = pose.copy()
            at[:, 0] += c * verts[0][0] - s * verts[0][1]
            at[:, 1] += s * verts[0][0] + c * verts[0][1]
            want = tfp.PointFootprint().distances(torch.from_numpy(at), tobs)
        torch.testing.assert_close(d, want, atol=1e-15, rtol=0)
        if vertices == 2:
            assert torch.equal(d, want)
        np.testing.assert_allclose(d.numpy(), np.asarray(jpoly.distances(pose, scen.obstacles)),
                                   atol=1e-12, rtol=0)
    assert tpoly.inscribed_radius == pytest.approx(jpoly.inscribed_radius, abs=1e-15)
    with pytest.raises(ValueError, match="got 0"):
        tfp.PolygonFootprint(())


@pytest.mark.parametrize("vertices", [1, 2])
def test_torch_few_vertex_polygon_plain_kernel_matches_unfused(vertices):
    """The kernel's plain version at 1 and 2 footprint vertices against the
    port's un-fused solve on the 2-vertex case's inputs."""
    verts = SEGMENT if vertices == 2 else ((0.1, -0.05),)
    _, tspec = _specs("polygon_2_vertices")
    tspec = dataclasses.replace(tspec, footprint=tfp.PolygonFootprint(verts))
    assert k2a.fused_supported(tspec)
    scen, init, duals = _jax_case("polygon_2_vertices")[0]
    inputs = (_beside_path(scen, (0.1, 0.6)), init, duals)
    plain = _port_solve(tspec, inputs, path="plain")
    _assert_f64_matches(plain, _port_solve(tspec, inputs))
    assert plain["converged"].any() and (plain["duals"]["mu_obs"] > 0).any()


# --------------------------------------------------------------------------- #
# the routing grid
# --------------------------------------------------------------------------- #
MODEL_PAIRS = {
    "unicycle": (jm.UnicycleModel, tm.UnicycleModel, {}),
    "simple_car": (jm.SimpleCarModel, tm.SimpleCarModel, dict(wheelbase=0.5)),
    "front_wheel": (jm.SimpleCarFrontWheelDrivingModel, tm.SimpleCarFrontWheelDrivingModel,
                    dict(wheelbase=0.5)),
    "bicycle": (jm.KinematicBicycleModelVelocityInput, tm.KinematicBicycleModelVelocityInput,
                dict(lf=0.3, lr=0.2)),
}
FOOTPRINT_PAIRS = {
    "point": ("PointFootprint", {}),
    "circular": ("CircularFootprint", dict(radius=0.2)),
    "two_circles": ("TwoCirclesFootprint", dict(front_offset=0.15, rear_offset=-0.15)),
    "line": ("LineFootprint", dict(line_start=(-0.1, 0.0), line_end=(0.35, 0.05))),
    "polygon": ("PolygonFootprint", dict(vertices=RECTANGLE)),
}
OCTAGON = tuple((0.3 * np.cos(2 * np.pi * i / 8), 0.2 * np.sin(2 * np.pi * i / 8))
                for i in range(8))


def _models():
    """(name, JAX model, port model) of the grid."""
    out = []
    for name, (jcls, tcls, kw) in MODEL_PAIRS.items():
        out.append((name, jcls(**kw), tcls(**kw)))
        out.append((f"{name}_subclass", _subclass(jcls)(**kw), _subclass(tcls)(**kw)))
    out.append(("base_se2", JSlewingDrive(), TSlewingDrive()))
    return out


def _footprints():
    """(name, JAX footprint, port footprint) of the grid."""
    out = []
    for name, (cls, kw) in FOOTPRINT_PAIRS.items():
        jcls, tcls = getattr(jfp, cls), getattr(tfp, cls)
        out.append((name, jcls(**kw), tcls(**kw)))
        out.append((f"{name}_subclass", _subclass(jcls)(**kw), _subclass(tcls)(**kw)))
    for n, verts in ((1, ((0.1, -0.05),)), (2, SEGMENT), (8, OCTAGON),
                     (9, OCTAGON + ((0.35, 0.0),))):
        out.append((f"polygon_{n}", jfp.PolygonFootprint(verts), tfp.PolygonFootprint(verts)))
    return out


@pytest.mark.parametrize("model", [name for name, _, _ in _models()])
def test_torch_fused_supported_routes_as_jax(model):
    _, jmodel, tmodel = {m[0]: m for m in _models()}[model]
    jbase = jb.config3_carlike_min_time(N=N, obstacle_cap=4)
    tbase = tb.config3_carlike_min_time(N=N, obstacle_cap=4)
    st = al_sqp.SolverSettings(**SETTINGS)
    obs = tb.random_ensemble(tbase, 2, torch.Generator().manual_seed(0),
                             dtype=torch.float64, device="cpu").obstacles
    exact = type(tmodel) in k2a.MODEL_IDS
    for name, jfoot, tfoot in _footprints():
        jspec = dataclasses.replace(jbase, model=jmodel, footprint=jfoot)
        tspec = dataclasses.replace(tbase, model=tmodel, footprint=tfoot)
        want = j_fused.fused_supported(jspec)
        assert k2a.fused_supported(tspec) == want, name
        if want:
            discs, segment, polygon = j_fused._footprint_static(jfoot)
            p = k2a._params(tspec, st, obs)
            got = {0: (tuple(zip(p.disc_off, p.disc_r))[: p.n_disc], None, None),
                   1: (None, tuple(zip(p.fp_v[0:4:2], p.fp_v[1:4:2])), None),
                   2: (None, None, tuple(zip(p.fp_v[0:2 * p.fp_nv:2],
                                             p.fp_v[1:2 * p.fp_nv:2])))}[p.fp_kind]
            assert got == (discs, segment, polygon), name
            assert k2a.k2a_flops(tspec, 3, 4, 3) > 0
        elif not exact:
            with pytest.raises(NotImplementedError, match=f"model {type(tmodel).__name__}"):
                k2a._check_scope(tspec, st, None)
    if not exact:
        x = torch.zeros(3, dtype=torch.float64)
        with pytest.raises(NotImplementedError, match="no closed form"):
            k2a.dyn(tspec, x, torch.zeros(2, dtype=torch.float64))
    # every footprint of the grid is admitted by the spec, as in JAX
    assert all(isinstance(OcpSpec(model=tmodel, footprint=t), OcpSpec) for _, _, t in _footprints())


def test_torch_family_names_match_jax():
    assert tb.FAMILY_NAMES == jb.FAMILY_NAMES
    for name in tb.FAMILY_NAMES:
        jspec, tspec = jb.family_spec(name), tb.family_spec(name)
        for field in ("N", "objective", "obstacle_cap", "via_cap", "nonuniform_dt"):
            assert getattr(tspec, field) == getattr(jspec, field), (name, field)
        assert type(tspec.footprint).__name__ == type(jspec.footprint).__name__


# --------------------------------------------------------------------------- #
# the members of BaseRobotSE2 and Primal
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model", [name for name, _, _ in _models()])
def test_torch_model_base_members_match_jax(model):
    _, jmodel, tmodel = {m[0]: m for m in _models()}[model]
    assert tmodel.continuous_time is True and jmodel.continuous_time is True
    j = np.asarray(jmodel.equilibrium_control())
    t = tmodel.equilibrium_control(device="cpu")
    assert t.dtype == torch.float32 and t.device == torch.device("cpu")
    assert tuple(t.shape) == j.shape == (tmodel.control_dim,)
    np.testing.assert_array_equal(t.numpy(), j)
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # torch's counterpart of JAX's x64 switch
    try:
        assert tmodel.equilibrium_control(device="cpu").dtype == torch.float64
    finally:
        torch.set_default_dtype(default)
    if torch.cuda.is_available():
        assert tmodel.equilibrium_control().device.type == "cuda"
    else:  # None is the card, as at every entry point
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmodel.equilibrium_control()


@dataclasses.dataclass(frozen=True)
class JNoBounds(j_base.BaseRobotSE2):
    """A unicycle written on the base class that leaves out ``control_bounds``."""

    control_dim = 2

    def f(self, x, u):
        th = x[..., 2]
        return jnp.stack([u[..., 0] * jnp.cos(th), u[..., 0] * jnp.sin(th), u[..., 1]], axis=-1)


@dataclasses.dataclass(frozen=True)
class TNoBounds(t_base.BaseRobotSE2):
    control_dim = 2

    def f(self, x, u):
        th = x[..., 2]
        return torch.stack([u[..., 0] * torch.cos(th), u[..., 0] * torch.sin(th), u[..., 1]],
                           dim=-1)


def test_torch_base_model_without_control_bounds_raises_as_jax():
    """The hook raises in both packages, reached through the spec."""
    for spec in (JOcpSpec(model=JNoBounds(), footprint=jfp.PointFootprint()),
                 OcpSpec(model=TNoBounds(), footprint=tfp.PointFootprint())):
        with pytest.raises(NotImplementedError):
            spec.control_box()
        assert spec.model.continuous_time is True


@pytest.mark.parametrize("per_stage", [False, True], ids=["uniform", "nonuniform"])
@pytest.mark.parametrize("batch", [(), (4,), (2, 3)], ids=str)
def test_torch_primal_batch_shape_matches_jax(batch, per_stage):
    n = 8
    rng = np.random.default_rng(len(batch))
    xs, us = rng.standard_normal(batch + (n + 1, 3)), rng.standard_normal(batch + (n, 2))
    dt = rng.uniform(0.1, 0.4, batch + ((n,) if per_stage else ()))
    j = JPrimal(jnp.asarray(xs), jnp.asarray(us), jnp.asarray(dt)).batch_shape()
    t = TPrimal(torch.from_numpy(xs), torch.from_numpy(us), torch.from_numpy(dt)).batch_shape()
    assert t == tuple(j) == batch + ((n,) if per_stage else ())
    assert isinstance(t, tuple)
