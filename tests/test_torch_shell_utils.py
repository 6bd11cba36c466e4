"""The shell's utilities: the port's ``msgs``, ``utils/conversion``,
``utils/publisher`` and ``utils/worlds`` against the JAX package's (CPU).

* ``OptimalControlResult.from_control_result`` on both Controllers' results
  for the same scenario (float64, both cold) and
  ``unflatten``; ``StateFeedback``.
* The conversions on random inputs: equal to 1e-15.
* ``Publisher`` under matplotlib's Agg backend: every marker kind, the
  footprints of every type, a PNG written.
* Every world builder cell for cell: walls with door gaps drawn either way,
  borders, the rooms, the corridor, the clutter of several seeds, a stamped
  disc, the pedestrian's costmaps; ``min_clearance``.
* ``run_episode`` for 5 cycles at N=8 on a two-room world: the trajectory
  against JAX's (both LocalPlanners in float32, the robot in float64) to
  1e-4 m, the vetoes and the outcome equal.
"""

import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import msgs as jmsgs
from mpc_local_planner_tpu.planner.config import load_config as j_load
from mpc_local_planner_tpu.planner.controller import Controller as JController
from mpc_local_planner_tpu.utils import conversion as jconv
from mpc_local_planner_tpu.utils import worlds as jw

from mpc_local_planner_tpu_torch import msgs as tmsgs
from mpc_local_planner_tpu_torch.geometry import footprints as tfp
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
from mpc_local_planner_tpu_torch.planner.config import load_config as t_load
from mpc_local_planner_tpu_torch.planner.controller import Controller as TController
from mpc_local_planner_tpu_torch.utils import conversion as tconv
from mpc_local_planner_tpu_torch.utils import worlds as tw
from mpc_local_planner_tpu_torch.utils.publisher import Publisher
from test_torch_controller import single_np, to_jax, to_torch


def robot_config(N=8):
    return {
        "robot": {"type": "unicycle", "unicycle": {"max_vel_x": 0.4, "max_vel_x_backwards": 0.2,
                                                   "max_vel_theta": 0.4}},
        "grid": {"grid_size_ref": N, "dt_ref": 0.3},
        "planning": {"objective": {"type": "quadratic_form", "quadratic_form": {
            "state_weights": [2.0, 2.0, 2.0], "control_weights": [1.0, 1.0]}},
            "terminal_cost": {"type": "quadratic", "quadratic": {
                "final_state_weights": [10.0, 10.0, 10.0]}}},
        "collision": {"min_obstacle_dist": 0.1, "obstacle_capacity": 12},
        "footprint_model": {"type": "circular", "radius": 0.2},
        "solver": {"iterations": 3, "inner_iterations": 4, "warm_iterations": 2,
                   "warm_inner_iterations": 3, "tol_eq": 1e-3, "tol_ineq": 1e-3},
    }


# --------------------------------------------------------------------------- #
# msgs and conversion
# --------------------------------------------------------------------------- #
def test_torch_optimal_control_result_matches_jax():
    cfg = robot_config()
    cfg["collision"]["obstacle_capacity"] = 2
    j_ctrl = JController(j_load(cfg), dtype=np.float64)
    t_ctrl = TController(t_load(cfg), dtype=torch.float64, device="cpu")
    tree = single_np([0.0, 0.0, 0.1], [1.0, 0.3, 0.2], [(0.5, -0.3, 0.1)], 2)
    j_res, t_res = j_ctrl.step(to_jax(tree)), t_ctrl.step(to_torch(tree))  # both cold
    got = tmsgs.OptimalControlResult.from_control_result(t_res, cpu_time=0.25)
    want = jmsgs.OptimalControlResult.from_control_result(j_res, cpu_time=0.25)
    assert (got.dim_states, got.dim_controls, got.optimal_solution_found, got.cpu_time) == (
        want.dim_states, want.dim_controls, want.optimal_solution_found, want.cpu_time)
    for name in ("time_states", "states", "time_controls", "controls"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=name)
    xs, us = got.unflatten()
    assert xs.shape == (9, 3) and us.shape == (8, 2)
    np.testing.assert_array_equal(xs, t_res.x_seq.values.numpy())
    fb = tmsgs.StateFeedback(stamp=1.5, state=[0.1, 0.2, 0.3])
    jfb = jmsgs.StateFeedback(stamp=1.5, state=[0.1, 0.2, 0.3])
    assert (fb.stamp, fb.state) == (jfb.stamp, jfb.state)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_conversions_match_jax(seed):
    rng = np.random.default_rng(seed)
    poses2 = rng.normal(size=(7, 2))
    poses3 = rng.normal(size=(5, 3))
    np.testing.assert_array_equal(tconv.poses_to_plan_array(list(poses2)),
                                  jconv.poses_to_plan_array(list(poses2)))
    np.testing.assert_array_equal(tconv.poses_to_plan_array(list(poses3)),
                                  jconv.poses_to_plan_array(list(poses3)))
    np.testing.assert_array_equal(tconv.poses_to_plan_array([poses2[0]]),
                                  jconv.poses_to_plan_array([poses2[0]]))
    twist = rng.normal(size=(11, 3))
    twist[0, 0] = 0.0
    twist[1, 0] = -1e-9
    for wb in (0.3, 1.2):
        np.testing.assert_allclose(tconv.ackermann_from_twist(twist, wb),
                                   jconv.ackermann_from_twist(twist, wb), atol=1e-15, rtol=0)
        np.testing.assert_allclose(tconv.ackermann_from_twist(twist[3], wb, min_speed=0.5),
                                   jconv.ackermann_from_twist(twist[3], wb, min_speed=0.5),
                                   atol=1e-15, rtol=0)

    class Series:
        times = torch.linspace(0, 1, 6, dtype=torch.float64)
        values = torch.from_numpy(rng.normal(size=(6, 4)))

    t_times, t_poses = tconv.time_series_to_poses(Series)
    j_times, j_poses = jconv.time_series_to_poses(
        type("S", (), {"times": Series.times.numpy(), "values": Series.values.numpy()}))
    np.testing.assert_array_equal(t_times, j_times)
    np.testing.assert_array_equal(t_poses, j_poses)


# --------------------------------------------------------------------------- #
# the publisher
# --------------------------------------------------------------------------- #
def test_torch_publisher_draws_every_kind(tmp_path):
    pub = Publisher()
    pub.publish_global_plan(np.stack([np.linspace(0, 2, 5), np.zeros(5), np.zeros(5)], 1))
    pub.publish_local_plan(torch.zeros(4, 3))
    obs = ObstacleSet.from_lists(
        points=[(0.5, 0.5), (1.0, -0.2)], circles=[(1.5, 0.5, 0.2)],
        lines=[((0.0, 1.0), (1.0, 1.0))], polygons=[[(2.0, 0.0), (2.5, 0.0), (2.2, 0.4)]],
        capacities=(3, 2, 2, 2), max_polygon_vertices=4)
    pub.publish_obstacles(obs)
    pub.publish_via_points(torch.tensor([[0.5, 0.0, 0.0], [1.0, 0.0, 0.0]]),
                           torch.tensor([True, False]))
    for fp in (tfp.CircularFootprint(0.2), tfp.PointFootprint(),
               tfp.TwoCirclesFootprint(front_offset=0.2, front_radius=0.1, rear_offset=-0.1,
                                       rear_radius=0.15),
               tfp.LineFootprint(line_start=(-0.2, 0.0), line_end=(0.2, 0.0)),
               tfp.PolygonFootprint(vertices=((0.2, 0.1), (-0.2, 0.1), (-0.2, -0.1),
                                              (0.2, -0.1)))):
        pub.publish_robot_footprint(np.array([1.0, 0.5, 0.3]), fp)
    ax = pub.ax()
    assert len(ax.lines) >= 8 and len(ax.patches) >= 4
    out = tmp_path / "scene.png"
    pub.save(str(out), title="port")
    assert out.stat().st_size > 1000


# --------------------------------------------------------------------------- #
# the worlds
# --------------------------------------------------------------------------- #
def _same_costmap(t_cm, j_cm):
    assert t_cm.origin == j_cm.origin and t_cm.resolution == j_cm.resolution
    assert t_cm.data.dtype == j_cm.data.dtype == np.uint8
    np.testing.assert_array_equal(t_cm.data, j_cm.data)


WORLD_CASES = [
    ("two_rooms", {}), ("two_rooms", dict(door_width=1.1, size=5.0, resolution=0.1)),
    ("corridor_corner", {}), ("corridor_corner", dict(width=1.4, resolution=0.1)),
    ("cluttered_room", {}), ("cluttered_room", dict(n_boxes=9, seed=4, resolution=0.1)),
    ("cluttered_room", dict(n_boxes=3, seed=7, box=0.6, keepout=1.0)),
]


@pytest.mark.parametrize("name, kw", WORLD_CASES)
def test_torch_worlds_match_jax_cell_for_cell(name, kw):
    _same_costmap(getattr(tw, name)(**kw), getattr(jw, name)(**kw))


def test_torch_world_builder_and_discs_match_jax():
    def build(mod):
        w = mod.WorldBuilder(4.0, 3.0, 0.05, origin=(-1.0, 0.5))
        w.add_border(0.15)
        w.add_wall(0.0, 1.0, 2.5, 1.0, gaps=[(0.5, 0.4), (1.6, 0.3)])
        w.add_wall(2.9, 3.4, -0.5, 3.4, thickness=0.2, gaps=[(1.0, 0.5)])  # right to left
        w.add_wall(1.0, 3.2, 1.0, 0.6, gaps=[(0.8, 0.6)])                  # downwards
        w.add_box(-0.8, 2.6, -0.4, 3.1)
        return w.costmap()

    t_cm, j_cm = build(tw), build(jw)
    _same_costmap(t_cm, j_cm)
    assert tw._split_segments(0.0, 3.0, [(1.0, 0.4), (0.9, 0.4), (2.9, 0.5)]) == (
        jw._split_segments(0.0, 3.0, [(1.0, 0.4), (0.9, 0.4), (2.9, 0.5)]))
    for cx, cy, r in ((0.5, 1.5, 0.2), (-1.0, 0.5, 0.3), (2.95, 3.45, 0.12)):
        _same_costmap(tw.stamp_disc(t_cm, cx, cy, r), jw.stamp_disc(j_cm, cx, cy, r))
    t_at, t_ped = tw.pedestrian_crossing(ped_vel=(0.1, -0.3))
    j_at, j_ped = jw.pedestrian_crossing(ped_vel=(0.1, -0.3))
    for t in (0.0, 1.3, 7.0):
        assert t_ped(t) == j_ped(t)
        _same_costmap(t_at(t), j_at(t))
    traj = np.array([[0.3, 1.2, 0.0], [1.0, 2.0, 0.0], [2.0, 1.5, 0.0]])
    assert tw.min_clearance(t_cm, traj) == jw.min_clearance(j_cm, traj)
    empty = tw.WorldBuilder(1.0, 1.0).costmap()
    assert tw.min_clearance(empty, traj) == jw.min_clearance(
        jw.WorldBuilder(1.0, 1.0).costmap(), traj) == np.inf


def test_torch_run_episode_matches_jax():
    cfg = robot_config()
    cm_t = tw.two_rooms(door_width=1.0, size=4.0, resolution=0.1)
    cm_j = jw.two_rooms(door_width=1.0, size=4.0, resolution=0.1)
    start, goal = np.array([0.8, 0.8, 0.0]), np.array([3.2, 2.5, 0.0])
    t_out = tw.run_episode(t_load(cfg), cm_t, start, goal, max_cycles=5, device="cpu")
    j_out = jw.run_episode(j_load(cfg), cm_j, start, goal, max_cycles=5)
    assert t_out[0] == j_out[0] is False and t_out[2] == j_out[2]
    assert t_out[1].shape == j_out[1].shape == (6, 3)
    np.testing.assert_allclose(t_out[1], j_out[1], atol=1e-4, rtol=0)
    assert np.linalg.norm(t_out[1][-1, :2] - start[:2]) > 0.2  # the robot moved
