"""PyTorch port vs the JAX package, module by module (f64, CPU).

Each test feeds the same numpy inputs (seeded) to a JAX function and to its
counterpart in ``mpc_local_planner_tpu_torch`` and compares the outputs.
Tolerance: atol 1e-10 in float64 unless stated — the two sides evaluate the
same formulas, so they agree to rounding.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu.benchmarks import config3_carlike_min_time as j_config3
from mpc_local_planner_tpu.benchmarks import random_ensemble as j_random_ensemble
from mpc_local_planner_tpu.core import so2 as j_so2
from mpc_local_planner_tpu.core.tree import where_tree as j_where_tree
from mpc_local_planner_tpu.geometry import footprints as j_fp
from mpc_local_planner_tpu.geometry.obstacles import ObstacleSet as JObstacleSet
from mpc_local_planner_tpu.ocp import constraints as j_C
from mpc_local_planner_tpu.ocp import grid as j_grid
from mpc_local_planner_tpu.ocp.collocation import collocation_defects as j_defects
from mpc_local_planner_tpu.ocp.collocation import stage_defect as j_stage_defect
from mpc_local_planner_tpu.ocp.costs import total_cost as j_total_cost
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.systems.models import SimpleCarModel as JSimpleCar

from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time as t_config3
from mpc_local_planner_tpu_torch.core import so2 as t_so2
from mpc_local_planner_tpu_torch.core.tree import where_tree as t_where_tree
from mpc_local_planner_tpu_torch.geometry import footprints as t_fp
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet as TObstacleSet
from mpc_local_planner_tpu_torch.ocp import constraints as t_C
from mpc_local_planner_tpu_torch.ocp import grid as t_grid
from mpc_local_planner_tpu_torch.ocp.collocation import collocation_defects as t_defects
from mpc_local_planner_tpu_torch.ocp.collocation import stage_defect as t_stage_defect
from mpc_local_planner_tpu_torch.ocp.costs import total_cost as t_total_cost
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec as TOcpSpec
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.solvers import al_sqp as t_al
from mpc_local_planner_tpu_torch.systems.models import SimpleCarModel as TSimpleCar

ATOL = 1e-10
B, N, M = 4, 8, 4


def _np(tree):
    """A JAX container as a nested dict of numpy arrays."""
    if dataclasses.is_dataclass(tree):
        return {f.name: _np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def _specs(**kw):
    j = dataclasses.replace(j_config3(N=N, obstacle_cap=M), **kw)
    t = dataclasses.replace(t_config3(N=N, obstacle_cap=M), **kw)
    return j, t


def _scenarios(seed=3):
    jspec, _ = _specs()
    js = j_random_ensemble(jspec, B, jax.random.PRNGKey(seed), dtype=jnp.float64)
    return js, convert.from_numpy(TScenario, _np(js), "cpu")


def _primal(seed=0):
    """A perturbed straight-line primal (f64 numpy) for the fixture lanes."""
    js, _ = _scenarios()
    jspec, _ = _specs()
    p = j_grid.initial_primal(jspec, js)
    rng = np.random.default_rng(seed)
    xs = np.asarray(p.xs) + 0.05 * rng.standard_normal(p.xs.shape)
    us = np.asarray(p.us) + 0.1 * rng.standard_normal(p.us.shape)
    dt = np.asarray(p.dt) * (1.0 + 0.2 * rng.standard_normal(p.dt.shape))
    return xs, us, dt


# --------------------------------------------------------------------------- #
# core
# --------------------------------------------------------------------------- #
def test_torch_normalize_angle_wraps_ties_like_jnp_mod():
    v = np.array([-math.pi, math.pi, 3 * math.pi, -3 * math.pi, 0.0, 2 * math.pi,
                  -2 * math.pi, 1e-17, math.pi - 1e-15, -math.pi + 1e-15, 7.5, -7.5])
    # exact: both compute the remainder with the divisor's sign
    np.testing.assert_array_equal(
        t_so2.normalize_angle(_t(v)).numpy(), np.asarray(j_so2.normalize_angle(v))
    )
    assert t_so2.normalize_angle(_t(np.array([math.pi])))[0].item() == -math.pi


def test_torch_se2_helpers_match():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(5, 3)) * 3, rng.normal(size=(5, 3)) * 3
    _close(t_so2.angle_diff(_t(a[:, 2]), _t(b[:, 2])), j_so2.angle_diff(a[:, 2], b[:, 2]))
    _close(t_so2.se2_boxminus(_t(a), _t(b)), j_so2.se2_boxminus(a, b))
    _close(t_so2.se2_boxplus(_t(a), _t(b)), j_so2.se2_boxplus(a, b))
    _close(t_so2.se2_interpolate(_t(a), _t(b), 0.3), j_so2.se2_interpolate(a, b, 0.3))
    t = rng.uniform(size=(5,))
    _close(t_so2.se2_interpolate(_t(a), _t(b), _t(t)), j_so2.se2_interpolate(a, b, t))
    _close(t_so2.rot2d(_t(a[:, 2])), j_so2.rot2d(a[:, 2]))


def test_torch_where_tree_broadcasts_like_jax():
    rng = np.random.default_rng(2)
    xs_a, xs_b = rng.normal(size=(2, 4, 3, 3))
    dt_a, dt_b = rng.normal(size=(2, 4))
    mask = np.array([True, False, True, False])
    jp = j_where_tree(mask, j_grid.Primal(xs_a, xs_a, dt_a), j_grid.Primal(xs_b, xs_b, dt_b))
    tp = t_where_tree(
        _t(mask), t_grid.Primal(_t(xs_a), _t(xs_a), _t(dt_a)),
        t_grid.Primal(_t(xs_b), _t(xs_b), _t(dt_b)),
    )
    _close(tp.xs, jp.xs, 0)
    _close(tp.dt, jp.dt, 0)


# --------------------------------------------------------------------------- #
# systems
# --------------------------------------------------------------------------- #
def test_torch_simple_car_dynamics_bounds_and_linearization():
    jspec, tspec = _specs()
    rng = np.random.default_rng(4)
    x, u = rng.normal(size=(6, 3)), rng.normal(size=(6, 2)) * 0.5
    jm, tm = JSimpleCar(wheelbase=0.5), TSimpleCar(wheelbase=0.5)
    _close(tm.f(_t(x), _t(u)), jm.f(x, u))
    A_t, B_t = tm.linearize(_t(x[0]), _t(u[0]))
    A_j, B_j = jm.linearize(x[0], u[0])
    _close(A_t, A_j)
    _close(B_t, B_j)
    for t_box, j_box in (
        (tspec.control_box(), jspec.control_box()),
        (tspec.control_rate_box(), jspec.control_rate_box()),
    ):
        for tb, jb in zip(t_box, j_box):
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert (tspec.nx, tspec.nu, tspec.min_time) == (jspec.nx, jspec.nu, jspec.min_time)


@pytest.mark.parametrize(
    "override",
    [
        dict(collocation="midpoint_differences"),
        dict(objective="quadratic_form"),
        dict(qf_diag=(1.0, 1.0, 1.0)),
        dict(variable_dt=False),
        dict(nonuniform_dt=True),
        dict(via_cap=2),
        dict(enable_dynamic_obstacles=True),
        dict(model=object()),
        dict(footprint=object()),
    ],
)
def test_torch_spec_refuses_families_outside_the_slice(override):
    kw = dataclasses.asdict(t_config3(N=N, obstacle_cap=M))
    kw.update(model=TSimpleCar(0.5), footprint=t_fp.CircularFootprint(0.2))
    kw["limits"] = t_config3().limits
    kw.update(override)
    with pytest.raises(NotImplementedError, match="ROADMAP M9"):
        TOcpSpec(**kw)


# --------------------------------------------------------------------------- #
# geometry
# --------------------------------------------------------------------------- #
def _obstacles():
    pts = [(0.5, 0.2), (1.5, -0.4)]
    circles = [(1.0, 0.0, 0.25), (2.0, 0.5, 0.3), (0.3, -1.0, 0.2)]
    jo = JObstacleSet.from_lists(
        points=pts[:1], circles=circles[:2], capacities=(2, 3, 0, 0), dtype=jnp.float64,
        point_vels=[(0.1, 0.0)], circle_vels=[(0.0, -0.2), (0.3, 0.1)],
    )
    return jo, convert.from_numpy(TObstacleSet, _np(jo), "cpu")


@pytest.mark.parametrize("kind", ["point", "circular"])
def test_torch_footprint_distances_with_masked_slots(kind):
    jo, to = _obstacles()
    jf = j_fp.PointFootprint() if kind == "point" else j_fp.CircularFootprint(radius=0.2)
    tf = t_fp.PointFootprint() if kind == "point" else t_fp.CircularFootprint(radius=0.2)
    rng = np.random.default_rng(5)
    poses = rng.normal(size=(7, 3))
    poses[0, :2] = (0.5, 0.2)  # exactly on the point obstacle: the _EPS sqrt
    d_t = tf.distances(_t(poses), to)
    _close(d_t, jf.distances(poses, jo))
    assert np.all(d_t.numpy()[:, [1, 4]] >= 1e6 - 1.0)  # masked slots: BIG_DISTANCE
    g_t = torch.func.grad(lambda p: tf.distances(p, to).sum())(_t(poses[0]))
    g_j = jax.grad(lambda p: jf.distances(p, jo).sum())(poses[0])
    _close(g_t, g_j)


def test_torch_obstacle_prediction_per_stage():
    jo, to = _obstacles()
    times = np.linspace(0.0, 2.0, 5)
    jp = jo.predict_stages(times)
    tp = jax.tree_util.tree_map(lambda a: a[None], _np(jo))
    tp = convert.from_numpy(TObstacleSet, tp, "cpu").predict_stages(_t(times)[None])
    for name in ("points", "circles", "circle_radii", "circle_mask", "lines", "polygons"):
        _close(getattr(tp, name)[0].double(), getattr(jp, name))


# --------------------------------------------------------------------------- #
# ocp: collocation, costs, constraints
# --------------------------------------------------------------------------- #
def test_torch_stage_defect_and_jacobians():
    jspec, tspec = _specs()
    rng = np.random.default_rng(6)
    xk, xk1 = rng.normal(size=(2, 5, 3))
    uk = rng.normal(size=(5, 2)) * 0.4
    dt = rng.uniform(0.1, 0.4, size=(5,))

    def jd(a, b, c, d):
        return j_stage_defect(jspec.model, "forward_differences", a, b, c, d)

    def td(a, b, c, d):
        return t_stage_defect(tspec.model, "forward_differences", a, b, c, d)

    _close(td(_t(xk), _t(uk), _t(xk1), _t(dt)), jax.vmap(jd)(xk, uk, xk1, dt))
    jac_j = jax.vmap(jax.jacfwd(jd, argnums=(0, 1, 2, 3)))(xk, uk, xk1, dt)
    jac_t = torch.func.vmap(torch.func.jacfwd(td, argnums=(0, 1, 2, 3)))(
        _t(xk), _t(uk), _t(xk1), _t(dt)
    )
    for a, b in zip(jac_t, jac_j):
        _close(a, b)


def test_torch_collocation_defects_and_total_cost():
    jspec, tspec = _specs()
    js, ts = _scenarios()
    xs, us, dt = _primal()
    _close(t_defects(tspec.model, "forward_differences", _t(xs), _t(us), _t(dt)),
           j_defects(jspec.model, "forward_differences", xs, us, dt))
    _close(t_total_cost(tspec, _t(xs), _t(us), _t(dt), ts),
           jax.vmap(lambda a, b, c, s: j_total_cost(jspec, a, b, c, s))(xs, us, dt, js))


@pytest.mark.parametrize(
    "name", ["obstacle", "rate", "box", "dt", "ball", "terminal_eq"]
)
def test_torch_constraint_functions(name):
    jspec, tspec = _specs(ball_radius=0.3, ball_weights=(1.0, 1.0, 0.5))
    js, ts = _scenarios()
    xs, us, dt = _primal()
    pick = {
        "obstacle": (
            lambda: t_C.obstacle_inequalities(tspec, _t(xs), _t(dt), ts),
            lambda: jax.vmap(lambda a, d, s: j_C.obstacle_inequalities(jspec, a, d, s))(xs, dt, js),
        ),
        "rate": (
            lambda: t_C.control_rate_inequalities(tspec, _t(us), _t(dt), ts.u_prev),
            lambda: j_C.control_rate_inequalities(jspec, us, dt, np.asarray(js.u_prev)),
        ),
        "box": (
            lambda: t_C.control_box_inequalities(tspec, _t(us)),
            lambda: j_C.control_box_inequalities(jspec, us),
        ),
        "dt": (
            lambda: t_C.dt_inequalities(tspec, _t(dt), torch.float64),
            lambda: j_C.dt_inequalities(jspec, dt, jnp.float64),
        ),
        "ball": (
            lambda: t_C.terminal_ball_inequality(tspec, _t(xs), ts.xf),
            lambda: j_C.terminal_ball_inequality(jspec, xs, np.asarray(js.xf)),
        ),
        "terminal_eq": (
            lambda: t_C.terminal_equality(tspec, _t(xs), ts.xf),
            lambda: j_C.terminal_equality(jspec, xs, np.asarray(js.xf)),
        ),
    }
    t_fn, j_fn = pick[name]
    out_t, out_j = t_fn(), j_fn()
    assert tuple(out_t.shape) == tuple(np.shape(out_j))
    _close(out_t, out_j)


# --------------------------------------------------------------------------- #
# ocp: grid and warm starts; duals
# --------------------------------------------------------------------------- #
def test_torch_initial_primal():
    jspec, tspec = _specs()
    js, ts = _scenarios()
    jp, tp = j_grid.initial_primal(jspec, js), t_grid.initial_primal(tspec, ts)
    for name in ("xs", "us", "dt"):
        _close(getattr(tp, name), getattr(jp, name))


@pytest.mark.parametrize("fn", ["resample", "shift"])
def test_torch_warm_starts(fn):
    jspec, tspec = _specs()
    xs, us, dt = _primal()
    x0 = xs[:, 1, :]
    jp = j_grid.Primal(jnp.asarray(xs), jnp.asarray(us), jnp.asarray(dt))
    tp = t_grid.Primal(_t(xs), _t(us), _t(dt))
    if fn == "resample":
        jo = j_grid.warm_start_resample(jp, x0, steps=1, spec=jspec)
        to = t_grid.warm_start_resample(tp, _t(x0), steps=1, spec=tspec)
    else:
        jo = j_grid.warm_start_shift(jp, x0, steps=2, spec=jspec)
        to = t_grid.warm_start_shift(tp, _t(x0), steps=2, spec=tspec)
    for name in ("xs", "us", "dt"):
        _close(getattr(to, name), getattr(jo, name))


def test_torch_take_stages():
    rng = np.random.default_rng(7)
    a3 = rng.normal(size=(3, 6, 2))
    a2 = rng.normal(size=(3, 6))
    src = rng.integers(0, 6, size=(3, 6))
    _close(t_grid._take_stages(_t(a3), _t(src)), j_grid._take_stages(a3, src), 0)
    _close(t_grid._take_stages(_t(a2), _t(src)), j_grid._take_stages(a2, src), 0)


def test_torch_init_and_shift_duals():
    jspec, tspec = _specs()
    jst, tst = j_al.SolverSettings(rho0=7.0), t_al.SolverSettings(rho0=7.0)
    jd = j_al.init_duals(jspec, jst, jnp.float64)
    td = t_al.init_duals(tspec, tst, torch.float64, "cpu", batch=(B,))
    for f in dataclasses.fields(td):
        assert tuple(getattr(td, f.name).shape[1:]) == np.shape(getattr(jd, f.name))
        _close(getattr(td, f.name)[0], getattr(jd, f.name), 0)
    rng = np.random.default_rng(8)
    dual_np = {f.name: rng.normal(size=getattr(td, f.name).shape) for f in dataclasses.fields(td)}
    j_in = j_al.DualState(**{k: jnp.asarray(v) for k, v in dual_np.items()})
    t_in = convert.from_numpy(t_al.DualState, dual_np, "cpu")
    jo, to = j_al.shift_duals(j_in, jst, steps=1), t_al.shift_duals(t_in, tst, steps=1)
    for f in dataclasses.fields(to):
        _close(getattr(to, f.name), getattr(jo, f.name), 0)


def test_torch_convert_round_trips_names_shapes_dtypes():
    js, ts = _scenarios()
    back = convert.to_numpy(ts)
    ref = _np(js)
    for key in ("x0", "xf", "via_points", "via_mask", "u_prev"):
        assert back[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(back[key], ref[key])
    for key, val in ref["obstacles"].items():
        assert back["obstacles"][key].dtype == val.dtype, key
        np.testing.assert_array_equal(back["obstacles"][key], val)
