"""The Controller's small pieces: the port against the JAX package (CPU, f64).

``twist_from_control`` of the four models and ``make_robot_dynamics``; the
``ObstacleSet`` helpers (``capacities``, ``total_capacity``,
``masks_concat``, ``num_active``, ``total_slots``, ``padded_to`` with its
over-capacity refusal, ``from_lists``); ``Scenario.goal_only``;
``TimeSeries`` and ``TimeSeriesSE2`` in both interpolation modes,
``stack_time_series`` and ``interpolate_angle``. Inputs are made with numpy
from a seed. Tolerance: 1e-12 absolute (the same arithmetic in another
order), and exact for integers, masks and shapes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu.core import so2 as j_so2
from mpc_local_planner_tpu.core import time_series as j_ts
from mpc_local_planner_tpu.geometry.obstacles import ObstacleSet as JObstacleSet
from mpc_local_planner_tpu.ocp.spec import Scenario as JScenario
from mpc_local_planner_tpu.systems import models as j_models

from mpc_local_planner_tpu_torch.core import so2 as t_so2
from mpc_local_planner_tpu_torch.core import time_series as t_ts
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet as TObstacleSet
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.systems import models as t_models

ATOL = 1e-12
RNG_SEED = 12


def _close(got, want, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0.0, atol=atol)


def _assert_trees(t_obj, j_obj, atol=ATOL):
    for f in dataclasses.fields(j_obj):
        jv, tv = getattr(j_obj, f.name), getattr(t_obj, f.name)
        if dataclasses.is_dataclass(jv):
            _assert_trees(tv, jv, atol)
        else:
            _close(tv, jv, atol)


MODELS = [
    ("unicycle", {}),
    ("simple_car", {"wheelbase": 0.5}),
    ("simple_car_front_wheel_driving", {"wheelbase": 0.7}),
    ("kinematic_bicycle_vel_input", {"lf": 0.3, "lr": 0.2}),
]


@pytest.mark.parametrize("name, params", MODELS)
def test_torch_twist_from_control_matches_jax(name, params):
    rng = np.random.default_rng(RNG_SEED)
    x = rng.uniform(-3.0, 3.0, (5, 7, 3))
    u = rng.uniform(-1.0, 1.0, (5, 7, 2))
    jm = j_models.make_robot_dynamics(name, **params)
    tm = t_models.make_robot_dynamics(name, **params)
    assert type(tm).__name__ == type(jm).__name__
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    want = jm.twist_from_control(jnp.asarray(x), jnp.asarray(u))
    _close(tm.twist_from_control(torch.from_numpy(x), torch.from_numpy(u)), want)


def test_torch_make_robot_dynamics_refuses_what_jax_refuses():
    assert sorted(t_models.ROBOT_TYPES) == sorted(j_models.ROBOT_TYPES)
    with pytest.raises(ValueError) as j_err:
        j_models.make_robot_dynamics("hovercraft")
    with pytest.raises(ValueError) as t_err:
        t_models.make_robot_dynamics("hovercraft")
    assert str(t_err.value) == str(j_err.value)


def _obstacle_lists(rng):
    return dict(
        points=[tuple(p) for p in rng.uniform(-2, 2, (3, 2))],
        circles=[(*rng.uniform(-2, 2, 2), r) for r in rng.uniform(0.1, 0.4, 2)],
        lines=[tuple(map(tuple, ln)) for ln in rng.uniform(-2, 2, (2, 2, 2))],
        polygons=[rng.uniform(-2, 2, (3, 2)).tolist(), rng.uniform(-2, 2, (5, 2)).tolist()],
        point_vels=[tuple(v) for v in rng.uniform(-1, 1, (3, 2))],
        circle_vels=[tuple(v) for v in rng.uniform(-1, 1, (2, 2))],
        line_vels=[tuple(v) for v in rng.uniform(-1, 1, (2, 2))],
        polygon_vels=[tuple(v) for v in rng.uniform(-1, 1, (2, 2))],
    )


@pytest.mark.parametrize("capacities, max_v", [(None, None), ((5, 4, 3, 3), 6)])
def test_torch_obstacle_set_from_lists_and_helpers_match_jax(capacities, max_v):
    lists = _obstacle_lists(np.random.default_rng(RNG_SEED))
    jo = JObstacleSet.from_lists(**lists, capacities=capacities,
                                 max_polygon_vertices=max_v, dtype=jnp.float64)
    to = TObstacleSet.from_lists(**lists, capacities=capacities,
                                 max_polygon_vertices=max_v, dtype=torch.float64,
                                 device="cpu")
    _assert_trees(to, jo)
    assert to.polygon_nv.dtype == torch.int32
    assert to.capacities == jo.capacities
    assert to.total_capacity == jo.total_capacity
    assert to.total_slots() == jo.total_slots()
    _close(to.masks_concat(), jo.masks_concat())
    _close(to.num_active(), jo.num_active())
    assert to.num_active().dtype == torch.int32


def test_torch_obstacle_set_padded_to_matches_jax_and_refuses_over_capacity():
    lists = _obstacle_lists(np.random.default_rng(RNG_SEED + 1))
    jo = JObstacleSet.from_lists(circles=lists["circles"], points=lists["points"],
                                 dtype=jnp.float64)
    to = TObstacleSet.from_lists(circles=lists["circles"], points=lists["points"],
                                 dtype=torch.float64)
    for target in (5, 9):
        jp, tp = jo.padded_to(target), to.padded_to(target)
        assert tp.total_slots() == jp.total_slots() == target
        _assert_trees(tp, jp)
    assert to.padded_to(to.total_slots()) is to
    # a batched set pads every lane
    jb = JObstacleSet(**{f.name: jnp.broadcast_to(getattr(jo, f.name), (3,) + getattr(
        jo, f.name).shape) for f in dataclasses.fields(jo)})
    tb = to._map(lambda _n, a: a.expand((3,) + a.shape))
    _assert_trees(tb.padded_to(8), jb.padded_to(8))
    with pytest.raises(ValueError) as j_err:
        jo.padded_to(3)
    with pytest.raises(ValueError) as t_err:
        to.padded_to(3)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("batch", [(), (4,)])
def test_torch_goal_only_matches_jax(batch):
    rng = np.random.default_rng(RNG_SEED + 2)
    x0 = rng.uniform(-1, 1, batch + (3,))
    xf = rng.uniform(-1, 1, batch + (3,))
    lists = _obstacle_lists(rng)
    jo = JObstacleSet.from_lists(circles=lists["circles"], dtype=jnp.float64)
    to = TObstacleSet.from_lists(circles=lists["circles"], dtype=torch.float64)
    js = JScenario.goal_only(x0, xf, nu=2, obstacle_set=jo, via_cap=3, dtype=jnp.float64)
    ts = TScenario.goal_only(x0, xf, nu=2, obstacle_set=to, via_cap=3,
                             dtype=torch.float64, device="cpu")
    _assert_trees(ts, js)
    assert ts.obstacles.circles.is_contiguous()
    # no obstacle set: an empty one
    _assert_trees(TScenario.goal_only(x0, xf, dtype=torch.float64),
                  JScenario.goal_only(x0, xf, dtype=jnp.float64))


def _series(rng, T=6, D=4):
    times = np.cumsum(rng.uniform(0.1, 0.5, T)) - 0.2
    values = rng.uniform(-3.0, 3.0, (T, D))
    values[:, 2] = rng.uniform(-np.pi, np.pi, T)
    return times, values


@pytest.mark.parametrize("cls", ["TimeSeries", "TimeSeriesSE2"])
@pytest.mark.parametrize("mode", ["linear", "zoh"])
def test_torch_time_series_interpolate_matches_jax(cls, mode):
    rng = np.random.default_rng(RNG_SEED + 3)
    times, values = _series(rng)
    jt = getattr(j_ts, cls)(times=jnp.asarray(times), values=jnp.asarray(values))
    tt = getattr(t_ts, cls)(times=torch.from_numpy(times), values=torch.from_numpy(values))
    # inside, before and after the support, the sample times themselves
    queries = np.concatenate([rng.uniform(times[0] - 1, times[-1] + 1, 11), times])
    _close(tt.interpolate(torch.from_numpy(queries), mode=mode),
           jt.interpolate(jnp.asarray(queries), mode=mode))
    for q in (float(times[2]) + 0.05, float(times[-1]) + 2.0, -5.0):
        _close(tt.interpolate(q, mode=mode), jt.interpolate(q, mode=mode))
    assert tt.num_samples == jt.num_samples and tt.value_dim == jt.value_dim
    _close(tt.first(), jt.first())
    _close(tt.last(), jt.last())
    _close(tt.shifted(0.3).times, jt.shifted(0.3).times)


def test_torch_time_series_se2_blends_across_the_seam_and_stacks_like_jax():
    times = np.array([0.0, 1.0])
    values = np.array([[0.0, 0.0, np.pi - 0.1], [1.0, 0.0, -np.pi + 0.1]])
    jt = j_ts.TimeSeriesSE2(times=jnp.asarray(times), values=jnp.asarray(values))
    tt = t_ts.TimeSeriesSE2(times=torch.from_numpy(times), values=torch.from_numpy(values))
    v = tt.interpolate(0.5)
    assert abs(abs(float(v[2])) - np.pi) < 1e-9  # the short arc, not 0
    _close(v, jt.interpolate(0.5))
    other = t_ts.TimeSeriesSE2(times=torch.from_numpy(times + 1.0),
                               values=torch.from_numpy(values * 0.5))
    st = t_ts.stack_time_series((tt, other))
    sj = j_ts.stack_time_series((jt, j_ts.TimeSeriesSE2(
        times=jnp.asarray(times + 1.0), values=jnp.asarray(values * 0.5))))
    assert isinstance(st, t_ts.TimeSeriesSE2)
    _close(st.times, sj.times)
    _close(st.values, sj.values)
    rng = np.random.default_rng(RNG_SEED + 4)
    a, b, t = (rng.uniform(-4, 4, 9), rng.uniform(-4, 4, 9), rng.uniform(0, 1, 9))
    _close(t_so2.interpolate_angle(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t)),
           j_so2.interpolate_angle(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
