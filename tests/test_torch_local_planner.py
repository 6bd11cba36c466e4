"""The planner shell: the port's ``planner/local_planner.py`` and ``native.py``
against the JAX package's (CPU).

* Every host function (plan pruning, the lookahead cut, the goal heading,
  via points, the costmap scans and converters, the blob tracker, the
  footprint cost and the trajectory veto) against JAX's on seeded costmaps
  and plans: numpy in, numpy out, exactly equal.
* The port's native library (built by g++ from ``native/costmap.cpp``
  into the package's ``_build/``) against the Python versions, as
  ``tests/test_native.py`` holds JAX's.
* ``LocalPlanner.compute_velocity_commands`` against JAX's for a few cycles
  in each converter mode (points, polygons, lines, dynamic) on small dict
  configs (N=8), both in float32 as the JAX shell runs. Before each cycle
  JAX's Controller state is handed to the port
  (``convert.controller_state_*``). What the shell builds — the scenario
  and the plan it hands to ``Controller.step`` — equals JAX's exactly, as
  do the veto decisions and the tracker state; the solve's twist, states
  and controls are held to the float32 tolerances of
  ``tests/test_torch_quadratic.py`` (5e-5) where both converged, and the
  converged flags equal.
"""

import dataclasses as dc

import numpy as np
import pytest
import torch

from mpc_local_planner_tpu.planner import local_planner as jlp
from mpc_local_planner_tpu.planner.config import load_config as j_load
from mpc_local_planner_tpu.planner.controller import Controller as JController

from mpc_local_planner_tpu_torch import convert, native
from mpc_local_planner_tpu_torch.planner import local_planner as tlp
from mpc_local_planner_tpu_torch.planner.config import load_config as t_load
from mpc_local_planner_tpu_torch.planner.controller import Controller as TController

SEEDS = [0, 1, 2, 3]
F32_TOL = 5e-5


def costmap_pair(seed, H=40, W=50, n_cells=30, blobs=3):
    """The same seeded costmap for both packages: scattered lethal cells and
    a few blocks (clusters for the converters)."""
    rng = np.random.default_rng(seed)
    data = np.zeros((H, W), dtype=np.uint8)
    data.flat[rng.integers(0, H * W, size=n_cells)] = 254
    for _ in range(blobs):
        y, x = rng.integers(2, H - 6), rng.integers(2, W - 8)
        h, w = rng.integers(1, 4), rng.integers(2, 7)
        data[y:y + h, x:x + w] = 254
    data[rng.integers(0, H), :] = np.where(rng.random(W) < 0.3, 128, 0).astype(np.uint8)
    origin, res = (-1.0, -2.0), 0.1
    return (jlp.Costmap(data=data, origin=origin, resolution=res),
            tlp.Costmap(data=data.copy(), origin=origin, resolution=res))


def plan_of(seed, P=30):
    rng = np.random.default_rng(100 + seed)
    t = np.linspace(0, 1, P)
    return np.stack([3.0 * t + 0.02 * rng.standard_normal(P),
                     rng.uniform(0.3, 0.8) * np.sin(np.pi * t),
                     rng.uniform(-0.5, 0.5, P)], axis=1)


def assert_same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# host functions, port against JAX
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", SEEDS)
def test_torch_plan_functions_match_jax(seed):
    plan = plan_of(seed)
    rng = np.random.default_rng(seed)
    for robot in rng.uniform([-0.2, -0.2, -1.0], [3.2, 0.8, 1.0], (4, 3)):
        for dist in (0.0, 0.3, 1.0):
            assert_same(tlp.prune_global_plan(plan, robot[:2], dist),
                        jlp.prune_global_plan(plan, robot[:2], dist))
        for look in (0.5, 1.5, 10.0):
            assert_same(tlp.transform_global_plan(plan, robot, look),
                        jlp.transform_global_plan(plan, robot, look))
    for n in (0, 1, 2, 5, 30):
        for k in (1, 3, 8):
            assert tlp.estimate_local_goal_orientation(plan[:n], k) == (
                jlp.estimate_local_goal_orientation(plan[:n], k))
    for sep in (-1.0, 0.0, 0.25, 0.7, 5.0):
        assert_same(tlp.extract_via_points(plan, sep), jlp.extract_via_points(plan, sep))
    assert_same(tlp.prune_global_plan(plan[:0], (0.0, 0.0)),
                jlp.prune_global_plan(plan[:0], (0.0, 0.0)))


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_costmap_scans_match_jax(seed):
    jcm, tcm = costmap_pair(seed)
    rng = np.random.default_rng(seed)
    for pose in rng.uniform([-1.0, -2.0, -np.pi], [4.0, 2.0, np.pi], (5, 3)):
        for kw in ({}, dict(behind_dist=0.5, cutoff_dist=1.5),
                   dict(behind_dist=0.5, cutoff_dist=3.0, force_inclusion_dist=1.0),
                   dict(threshold=128)):
            assert_same(tlp.costmap_to_obstacle_points(tcm, pose, **kw),
                        jlp.costmap_to_obstacle_points(jcm, pose, **kw))
    for threshold, min_cluster in ((254, 2), (254, 1), (128, 3)):
        t_cl = tlp._cluster_cells(tcm, threshold, min_cluster)
        assert len(t_cl) > 0
        assert_same(tuple(t_cl), tuple(jlp._cluster_cells(jcm, threshold, min_cluster)))
    pts = rng.normal(size=(20, 2))
    for a, b in ((pts[0], pts[1]), (pts[2], pts[2]), (pts[3], pts[3] + 1e-13)):
        assert_same(tlp._line_point_dist(a, b, pts), jlp._line_point_dist(a, b, pts))


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_converters_and_tracker_match_jax(seed):
    jcm, tcm = costmap_pair(seed)
    for kw in ({}, dict(inlier_dist=0.05, min_inliers=3, max_out=4), dict(min_cluster=4)):
        assert_same(tlp.extract_line_segments(tcm, **kw), jlp.extract_line_segments(jcm, **kw))
    for kw in ({}, dict(min_cluster=1, max_out=3), dict(threshold=128)):
        assert_same(tlp.cluster_centroids(tcm, **kw), jlp.cluster_centroids(jcm, **kw))
    # a few frames of blobs moving, one missed detection, tracks dying
    rng = np.random.default_rng(seed)
    cen = np.column_stack([rng.uniform(0, 3, (4, 2)), rng.uniform(0.1, 0.3, 4)])
    t_tr, j_tr, t_id, j_id = np.zeros((0, 8)), np.zeros((0, 8)), 0, 0
    for k, frame in enumerate([cen, cen + 0.05, cen[:2] + 0.1, np.zeros((0, 3)),
                               cen[:, :2] + 0.2, cen[1:] + 0.25, np.zeros((0, 3))]):
        kw = dict(dt=0.1, gate_dist=0.4, vel_alpha=0.6, max_out=3 + k % 3, max_missed=k % 3)
        t_tr, t_id = tlp.tracker_update(t_tr, frame, next_id=t_id, **kw)
        j_tr, j_id = jlp.tracker_update(j_tr, frame, next_id=j_id, **kw)
        assert_same(t_tr, j_tr)
        assert t_id == j_id


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_footprint_cost_and_veto_match_jax(seed):
    jcm, tcm = costmap_pair(seed)
    rng = np.random.default_rng(seed)
    for pose in rng.uniform([-1.5, -2.5, -3.0], [4.5, 2.5, 3.0], (12, 3)):
        for r in (0.0, 0.05, 0.25):
            assert tlp.footprint_cost(tcm, pose, r) == jlp.footprint_cost(jcm, pose, r)
    for _ in range(6):
        xs = np.column_stack([rng.uniform(-0.5, 3.5, 8), rng.uniform(-1.5, 1.5, 8),
                              rng.uniform(-3, 3, 8)])
        for kw in ({}, dict(footprint_radius=0.15), dict(check_poses=3),
                   dict(footprint_radius=0.1, min_resolution_angular=0.5)):
            assert tlp.is_pose_trajectory_feasible(tcm, xs, **kw) == (
                jlp.is_pose_trajectory_feasible(jcm, xs, **kw))


# --------------------------------------------------------------------------- #
# the native library against the Python versions
# --------------------------------------------------------------------------- #
def test_torch_native_is_built_from_the_source_here():
    assert native.available()
    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert native.SOURCE.name == "costmap.cpp" and native.SOURCE.parent.name == "native"
    assert native.load() is native.load()  # memoized


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_native_matches_python(seed):
    _, cm = costmap_pair(seed)
    rng = np.random.default_rng(seed)
    for pose in rng.uniform([-0.5, -1.5, -3.0], [3.5, 1.5, 3.0], (4, 3)):
        ref = tlp.costmap_to_obstacle_points(cm, pose, behind_dist=1.0, cutoff_dist=2.0,
                                             force_inclusion_dist=0.5)
        nat = native.extract_points(cm, pose, behind_dist=1.0, cutoff_dist=2.0,
                                    force_inclusion_dist=0.5)
        assert sorted(map(tuple, np.round(ref, 9))) == sorted(map(tuple, np.round(nat, 9)))
    for pose in [(0.5, 0.3), (1.0, 1.0), (-0.5, -1.5), (10.0, 10.0)]:
        for r in (0.0, 0.25):
            assert native.footprint_cost(cm, pose, r) == tlp.footprint_cost(cm, pose, r)
    for _ in range(5):
        xs = np.column_stack([rng.uniform(-0.5, 3.5, 6), rng.uniform(-1.5, 1.5, 6),
                              rng.uniform(-3, 3, 6)])
        assert native.trajectory_feasible(cm, xs, 0.15) == tlp.is_pose_trajectory_feasible(
            cm, xs, 0.15)
    a, b = tlp.cluster_centroids(cm), native.cluster_centroids(cm)
    assert a.shape == b.shape
    np.testing.assert_allclose(a[np.lexsort(a.T)], b[np.lexsort(b.T)], atol=1e-12)
    cen0 = a[:3]
    t_py, nid_py = tlp.tracker_update(np.zeros((0, 8)), cen0, dt=0.1)
    t_c, nid_c = native.tracker_update(np.zeros((0, 8)), cen0, dt=0.1)
    t_py, nid_py = tlp.tracker_update(t_py, cen0 + 0.05, dt=0.1, next_id=nid_py)
    t_c, nid_c = native.tracker_update(t_c, cen0 + 0.05, dt=0.1, next_id=nid_c)
    np.testing.assert_allclose(t_py, t_c, atol=1e-12)
    assert nid_py == nid_c


def test_torch_native_lines_and_polygons_cover_the_blobs():
    data = np.zeros((60, 60), dtype=np.uint8)
    data[20, 10:40] = 254      # a wall: y = 2.05, x in [1, 4]
    data[30:33, 45:48] = 254   # a compact blob
    cm = tlp.Costmap(data=data, origin=(0.0, 0.0), resolution=0.1)
    a, b = tlp.extract_line_segments(cm), native.extract_lines(cm)
    assert a.shape == b.shape
    la = a[np.argmax(np.linalg.norm(a[:, 1] - a[:, 0], axis=1))]
    lb = b[np.argmax(np.linalg.norm(b[:, 1] - b[:, 0], axis=1))]
    assert min(np.linalg.norm(la - lb), np.linalg.norm(la - lb[::-1])) < 0.15
    polys = native.extract_polygons(cm)
    assert len(polys) == 2
    areas = [0.5 * abs(np.dot(p[:, 0], np.roll(p[:, 1], 1)) - np.dot(p[:, 1], np.roll(p[:, 0], 1)))
             for p in polys]
    assert max(areas) == pytest.approx(0.2 * 0.2, rel=1e-6)


# --------------------------------------------------------------------------- #
# LocalPlanner, port against JAX
# --------------------------------------------------------------------------- #
def shell_config(mode):
    col = {"min_obstacle_dist": 0.1, "costmap_converter": mode, "obstacle_capacity": 12,
           "collision_check_no_poses": 4}
    if mode == "polygons":
        col.update(obstacle_capacity=0, polygon_capacity=3, max_polygon_vertices=8)
    elif mode == "lines":
        col.update(obstacle_capacity=0, line_capacity=3)
    elif mode == "dynamic":
        col.update(obstacle_capacity=6, dynamic_capacity=2, tracker_vel_alpha=1.0,
                   enable_dynamic_obstacles=True)
    return {
        "controller": {"max_global_plan_lookahead_dist": 1.5, "global_plan_viapoint_sep": 0.4,
                       "publish_ocp_results": True},
        "robot": {"type": "unicycle", "unicycle": {"max_vel_x": 0.4, "max_vel_x_backwards": 0.2,
                                                   "max_vel_theta": 0.4}},
        "grid": {"grid_size_ref": 8, "dt_ref": 0.3},
        "planning": {"objective": {"type": "quadratic_form", "quadratic_form": {
            "state_weights": [2.0, 2.0, 2.0], "control_weights": [1.0, 1.0]}},
            "terminal_cost": {"type": "quadratic", "quadratic": {
                "final_state_weights": [10.0, 10.0, 10.0]}},
            "via_points_position_weight": 0.5},
        "collision": col,
        "via_capacity": 2,
        "footprint_model": {"type": "circular", "radius": 0.15},
        "solver": {"iterations": 3, "inner_iterations": 4, "warm_iterations": 2,
                   "warm_inner_iterations": 3, "tol_eq": 1e-3, "tol_ineq": 1e-3},
    }


def shell_costmap(cx):
    """A wall below the path, a block above it and a blob at x = cx moving
    along y = -0.6 (one cell a cycle)."""
    data = np.zeros((40, 60), dtype=np.uint8)
    data[5, 5:40] = 254
    data[24:27, 20:23] = 254
    mx = int((cx + 0.5) / 0.1)
    data[9:12, mx:mx + 3] = 254
    return dict(data=data, origin=(-0.5, -1.5), resolution=0.1)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _spy(planner):
    """Record what the shell hands to Controller.step."""
    seen = []
    step = planner.controller.step

    def spy(scen, plan=None, **kw):
        seen.append((scen, plan, kw))
        return step(scen, plan=plan, **kw)

    planner.controller.step = spy
    return seen


def _scenario_np(scen):
    out = {}
    for f in dc.fields(scen):
        v = getattr(scen, f.name)
        if f.name == "obstacles":
            for g in dc.fields(v):
                out[f"obstacles.{g.name}"] = _np(getattr(v, g.name))
        else:
            out[f.name] = _np(v)
    return out


@pytest.mark.parametrize("mode", ["points", "polygons", "lines", "dynamic"])
def test_torch_local_planner_cycles_match_jax(mode):
    cfg = shell_config(mode)
    jp = jlp.LocalPlanner(j_load(cfg))
    tp = tlp.LocalPlanner(t_load(cfg), device="cpu")
    assert tp.controller.dtype == torch.float32 and isinstance(tp.controller, TController)
    assert isinstance(jp.controller, JController)
    t = np.linspace(0, 1, 30)
    plan = np.stack([3.0 * t, 0.3 * np.sin(np.pi * t), np.zeros_like(t)], axis=1)
    jp.set_plan(plan)
    tp.set_plan(plan)
    j_seen, t_seen = _spy(jp), _spy(tp)
    x, u = np.zeros(3), np.zeros(2)
    extras = [(1.2, 0.9, 0.1)]
    results = converged = 0
    for k in range(4):
        cm = shell_costmap(1.0 + 0.1 * k)
        convert.controller_state_from_numpy(tp.controller,
                                            convert.controller_state_to_numpy(jp.controller))
        j_twist, j_res = jp.compute_velocity_commands(x, u, costmap=jlp.Costmap(**cm),
                                                      extra_obstacles=extras)
        t_twist, t_res = tp.compute_velocity_commands(x, u, costmap=tlp.Costmap(**cm),
                                                      extra_obstacles=extras)
        # the shell's own work: exactly JAX's
        j_scen, j_plan, j_kw = j_seen[-1]
        t_scen, t_plan, t_kw = t_seen[-1]
        got, want = _scenario_np(t_scen), _scenario_np(j_scen)
        assert got.keys() == want.keys()
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{mode} {k} {name}")
        np.testing.assert_array_equal(_np(t_plan), _np(j_plan))
        assert t_kw == j_kw
        np.testing.assert_array_equal(tp._global_plan, jp._global_plan)
        np.testing.assert_array_equal(tp._tracks, jp._tracks)
        assert tp._next_track_id == jp._next_track_id
        assert (t_res is None) == (j_res is None)
        if j_res is None:
            np.testing.assert_array_equal(t_twist, j_twist)
            continue
        results += 1
        # the solve, at float32
        conv = bool(_np(t_res.solve.converged))
        assert conv == bool(_np(j_res.solve.converged))
        if conv:
            converged += 1
            for got_a, want_a in ((t_twist, j_twist), (t_res.x_seq.values, j_res.x_seq.values),
                                  (t_res.u_seq.values, j_res.u_seq.values)):
                np.testing.assert_allclose(_np(got_a), _np(want_a), atol=F32_TOL, rtol=0)
        ocp_t, ocp_j = tp.last_ocp_result, jp.last_ocp_result
        assert (ocp_t.dim_states, ocp_t.dim_controls, ocp_t.optimal_solution_found) == (
            ocp_j.dim_states, ocp_j.dim_controls, ocp_j.optimal_solution_found)
        # the robot follows JAX's command on both sides
        x = np.asarray(_np(j_res.solve.primal.xs)[1], dtype=np.float64)
        u = np.asarray(_np(j_res.u0), dtype=np.float64)
    assert results >= 2 and converged >= 1
    goal = plan[-1]
    assert tp.is_goal_reached(goal + 0.01) == jp.is_goal_reached(goal + 0.01) is True
    assert tp.is_goal_reached(x) == jp.is_goal_reached(x)


def test_torch_local_planner_state_feedback_and_errors():
    cfg = shell_config("points")
    cfg["controller"]["prefer_x_feedback"] = True
    tp = tlp.LocalPlanner(t_load(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="no global plan set"):
        tp.compute_velocity_commands(np.zeros(3), np.zeros(2))
    assert tp.is_goal_reached(np.zeros(3)) is False
    t = np.linspace(0, 1, 20)
    tp.set_plan(np.stack([2.0 * t, 0 * t, 0 * t], axis=1))
    seen = _spy(tp)
    tp.set_state_feedback([0.1, 0.05, 0.02], stamp=1.0)
    twist, res = tp.compute_velocity_commands(np.zeros(3), np.zeros(2))
    assert res is not None and twist.shape == (3,)
    np.testing.assert_array_equal(_np(seen[-1][0].x0), np.float32([0.1, 0.05, 0.02]))
    model = tp.controller.spec.model
    a, b = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([4.0, 5.0, 6.0])
    assert model.merge_state_feedback_and_odom(a, b, True) is a
    assert model.merge_state_feedback_and_odom(a, b, False) is b
    assert torch.equal(model.position_from_state(a), a[:2])
    assert model.pose_from_state(a) is a and model.steady_state_from_pose(a) is a
