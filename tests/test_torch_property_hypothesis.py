"""The nine properties of ``tests/test_property_hypothesis.py`` on the port,
each draw also held to the JAX package (CPU, float64).

Each property keeps the JAX file's strategies, invariant and tolerance and
runs on the port's functions: the SO(2) wrap, the SE(2) ⊞/⊟ round trip and
geodesic interpolation, the distance kernels' metric bounds and rigid-motion
invariance, the footprints' SE(2) equivariance and the config loader's
numeric jitter and unknown keys. On every draw the port's values agree with
JAX's within 1e-12 relative + 1e-12 absolute, and the port's
``load_config`` accepts or raises exactly where JAX's does (the same
exception type); where both accept, the whole config, its ``OcpSpec`` and
its solver settings are equal (``tests/test_torch_config.py``'s
``assert_same_config``). Examples are drawn deterministically and kept in no
database, so every run checks the same draws.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from mpc_local_planner_tpu.core import so2 as j_so2
from mpc_local_planner_tpu.geometry import distances as j_dist
from mpc_local_planner_tpu.geometry.footprints import make_footprint as j_make_footprint
from mpc_local_planner_tpu.geometry.obstacles import ObstacleSet as JObstacleSet
from mpc_local_planner_tpu.planner.config import load_config as j_load_config

from test_torch_config import assert_same_config
from mpc_local_planner_tpu_torch.core import so2 as t_so2
from mpc_local_planner_tpu_torch.geometry import distances as t_dist
from mpc_local_planner_tpu_torch.geometry.footprints import make_footprint as t_make_footprint
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet as TObstacleSet
from mpc_local_planner_tpu_torch.planner.config import load_config as t_load_config

finite = st.floats(-50.0, 50.0, allow_nan=False, allow_infinity=False)
angle = st.floats(-12.0, 12.0, allow_nan=False, allow_infinity=False)
pt = st.tuples(finite, finite)

DRAWS = dict(deadline=None, derandomize=True, database=None)
COMMON = dict(DRAWS, max_examples=40)


def T(v):
    return torch.as_tensor(np.asarray(v, np.float64))


def J(v):
    return jnp.asarray(v, jnp.float64)


def agree(t, j):
    """The port's value against JAX's: 1e-12 relative + 1e-12 absolute."""
    np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64),
                               rtol=1e-12, atol=1e-12)


def both(name, module_t, module_j, *args):
    """``name`` of the port on ``args``, held to JAX's; the port's value as
    numpy."""
    t = getattr(module_t, name)(*map(T, args)).numpy()
    agree(t, getattr(module_j, name)(*map(J, args)))
    return t


@settings(**COMMON)
@given(theta=angle, k=st.integers(-3, 3))
def test_torch_normalize_angle_range_idempotence_periodicity(theta, k):
    w = float(both("normalize_angle", t_so2, j_so2, theta))
    assert -np.pi <= w <= np.pi
    assert abs(float(both("normalize_angle", t_so2, j_so2, w)) - w) < 1e-12
    wk = float(both("normalize_angle", t_so2, j_so2, theta + 2 * np.pi * k))
    # equal up to the ±π seam
    assert min(abs(wk - w), abs(abs(wk - w) - 2 * np.pi)) < 1e-9


@settings(**COMMON)
@given(x=st.tuples(finite, finite, angle), d=st.tuples(finite, finite, angle))
def test_torch_se2_boxplus_boxminus_roundtrip(x, d):
    plus = both("se2_boxplus", t_so2, j_so2, x, d)
    r = both("se2_boxminus", t_so2, j_so2, plus, x)
    expect = np.array(d, np.float64)
    expect[2] = float(t_so2.normalize_angle(T(d[2])))
    err = np.abs(r - expect)
    err[2] = min(err[2], abs(err[2] - 2 * np.pi))  # ±π seam
    assert np.all(err < 1e-9)
    # x ⊖ x = 0
    assert np.allclose(both("se2_boxminus", t_so2, j_so2, x, x), 0.0, atol=1e-12)


@settings(**COMMON)
@given(x=st.tuples(finite, finite, angle), y=st.tuples(finite, finite, angle))
def test_torch_se2_interpolate_endpoints_and_geodesic_midpoint(x, y):
    def interp(t):
        out = t_so2.se2_interpolate(T(x), T(y), t).numpy()
        agree(out, j_so2.se2_interpolate(J(x), J(y), t))
        return out

    def wrapped(a, b):
        return abs(float(t_so2.angle_diff(T(a), T(b))))

    p0, p1, pm = interp(0.0), interp(1.0), interp(0.5)
    assert np.allclose(p0[:2], x[:2], atol=1e-12) and wrapped(p0[2], x[2]) < 1e-9
    assert np.allclose(p1[:2], y[:2], atol=1e-12) and wrapped(p1[2], y[2]) < 1e-9
    # the midpoint's angle is the same wrapped distance from both ends
    assert abs(wrapped(pm[2], x[2]) - wrapped(pm[2], y[2])) < 1e-9


def _rigid(theta, t):
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    return lambda p: (R @ np.asarray(p, np.float64)) + np.asarray(t, np.float64)


@settings(**COMMON)
@given(p=pt, a=pt, b=pt, theta=angle, t=pt)
def test_torch_point_to_segment_bounds_and_rigid_invariance(p, a, b, theta, t):
    d = float(both("point_to_segment", t_dist, j_dist, p, a, b))
    pe = np.asarray(p, np.float64)
    d_end = min(np.linalg.norm(pe - np.asarray(a)), np.linalg.norm(pe - np.asarray(b)))
    # the AD-safe norm's 1e-6 floor allows that much above the exact bound
    assert -1e-12 <= d <= d_end + 1.1e-6
    g = _rigid(theta, t)
    d2 = float(both("point_to_segment", t_dist, j_dist, g(p), g(a), g(b)))
    assert abs(d - d2) < 1e-8 * (1.0 + abs(d))


@settings(**COMMON)
@given(p1=pt, p2=pt, q1=pt, q2=pt)
def test_torch_segment_to_segment_symmetry_and_upper_bound(p1, p2, q1, q2):
    d = float(both("segment_to_segment", t_dist, j_dist, p1, p2, q1, q2))
    d_sym = float(both("segment_to_segment", t_dist, j_dist, q1, q2, p1, p2))
    assert abs(d - d_sym) < 1e-10
    # bounded above by every endpoint-to-other-segment distance
    ub = min(float(both("point_to_segment", t_dist, j_dist, *args)) for args in (
        (p1, q1, q2), (p2, q1, q2), (q1, p1, p2), (q2, p1, p2)))
    assert d <= ub + 1e-9


j_polygon_signed = jax.jit(j_dist.point_to_polygon_signed)  # one compile per vertex count


@settings(**COMMON)
@given(p=pt, theta=angle, t=pt, nv=st.integers(3, 6), seed=st.integers(0, 2**31 - 1))
def test_torch_polygon_signed_distance_rigid_invariance(p, theta, t, nv, seed):
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, size=nv))
    rad = rng.uniform(0.3, 3.0, size=nv)
    verts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)  # star-convex

    def signed(point, vs):
        out = float(t_dist.point_to_polygon_signed(T(point), T(vs), torch.tensor(nv)))
        agree(out, j_polygon_signed(J(point), J(vs), jnp.asarray(nv, jnp.int32)))
        return out

    g = _rigid(theta, t)
    d = signed(p, verts)
    d2 = signed(g(p), np.stack([g(v) for v in verts]))
    assert abs(d - d2) < 1e-8 * (1.0 + abs(d))


FOOTPRINTS = {
    "point": {},
    "circular": {"radius": 0.3},
    "line": {"line_start": (-0.2, 0.0), "line_end": (0.3, 0.0)},
    "two_circles": {
        "front_offset": 0.2,
        "front_radius": 0.25,
        "rear_offset": -0.2,
        "rear_radius": 0.25,
    },
    "polygon": {"vertices": [(-0.3, -0.2), (0.4, -0.2), (0.4, 0.2), (-0.3, 0.2)]},
}


@functools.lru_cache(maxsize=None)
def _j_distances(ftype):
    return jax.jit(j_make_footprint(ftype, **FOOTPRINTS[ftype]).distances)


@settings(**DRAWS, max_examples=15)
@given(ftype=st.sampled_from(sorted(FOOTPRINTS)), pose=st.tuples(finite, finite, angle),
       ox=finite, oy=finite, orad=st.floats(0.05, 1.0), theta=angle, t=pt)
def test_torch_footprint_distance_se2_equivariance(ftype, pose, ox, oy, orad, theta, t):
    """Moving the pose and the obstacles by one rigid motion leaves every
    footprint-obstacle distance unchanged."""
    t_fp = t_make_footprint(ftype, **FOOTPRINTS[ftype])

    def distances(pose, point, circle):
        t_obs = TObstacleSet.from_lists(points=[point], circles=[circle], dtype=torch.float64,
                                        device="cpu")
        j_obs = JObstacleSet.from_lists(points=[point], circles=[circle], dtype=jnp.float64)
        out = t_fp.distances(T(pose), t_obs).numpy()
        agree(out, _j_distances(ftype)(J(pose), j_obs))
        return out

    d0 = distances(pose, (ox, oy), (oy, ox, orad))
    g = _rigid(theta, t)
    d1 = distances((*g(pose[:2]), pose[2] + theta), tuple(g((ox, oy))), (*g((oy, ox)), orad))
    np.testing.assert_allclose(d0, d1, atol=1e-7, rtol=1e-7)


BASE_CFG = {
    "robot": {"type": "unicycle", "unicycle": {"max_vel_x": 0.4, "max_vel_theta": 0.3}},
    "grid": {"grid_size_ref": 15, "dt_ref": 0.3},
    "planning": {
        "objective": {
            "type": "quadratic_form",
            "quadratic_form": {
                "state_weights": [2.0, 2.0, 2.0],
                "control_weights": [1.0, 1.0],
            },
        }
    },
    "collision": {"min_obstacle_dist": 0.2, "obstacle_capacity": 4},
    "footprint_model": {"type": "circular", "radius": 0.2},
}


def _numeric_leaves(d, prefix=()):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _numeric_leaves(v, prefix + (k,))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield prefix + (k,)


def _set_leaf(d, path, value):
    d = copy.deepcopy(d)
    node = d
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    return d


LEAVES = sorted(_numeric_leaves(BASE_CFG))


def _load(load, cfg):
    """(the config, None) or (None, the exception type's name)."""
    try:
        out = load(copy.deepcopy(cfg))
        out.to_ocp_spec()
        return out, None
    except (KeyError, ValueError, TypeError) as e:
        return None, type(e).__name__


def _load_both(cfg):
    """The port's config and JAX's, or the exception type's name, after
    checking that they accept and refuse alike and agree where they accept."""
    (t, t_err), (j, j_err) = _load(t_load_config, cfg), _load(j_load_config, cfg)
    assert t_err == j_err
    if t is not None:
        assert_same_config(t, j)
    return t, t_err


@settings(**DRAWS, max_examples=30)
@given(idx=st.integers(0, len(LEAVES) - 1), scale=st.floats(0.25, 4.0, allow_nan=False))
def test_torch_config_loader_fuzz_numeric_jitter(idx, scale):
    """Jittering any numeric leaf of a canonical config still loads and
    transcribes, and exactly as JAX's loader does."""
    path = LEAVES[idx]
    node = BASE_CFG
    for k in path:
        node = node[k]
    value = node * scale
    if path[-1] in ("grid_size_ref", "obstacle_capacity"):
        value = max(2, int(value))
    cfg, err = _load_both(_set_leaf(BASE_CFG, path, value))
    assert err is None
    cfg.to_ocp_spec()


@settings(**DRAWS, max_examples=30)
@given(idx=st.integers(0, len(LEAVES) - 1),
       name=st.sampled_from(["bogus_key", "typo_parm", "not_a_field", "xyzzy"]))
def test_torch_config_loader_rejects_unknown_keys_anywhere(idx, name):
    """An unknown key at any depth raises, in both loaders alike."""
    path = LEAVES[idx][:-1] + (name,)
    bad = _set_leaf(BASE_CFG, path, 1.0)
    with pytest.raises((KeyError, ValueError, TypeError)):
        t_load_config(copy.deepcopy(bad))
    assert _load_both(bad)[1] is not None
