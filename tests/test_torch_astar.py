"""The wall family's A* plan seeds against the JAX package's (CPU): the
costmap, the inflation, ``astar_plan`` and ``lines_astar_plans``.

The port keeps its own numpy copy of these host-side functions; they must
give the same plans, cell for cell and pose for pose, and the same ``ok``
flags. Held exactly: the same numpy arithmetic in the same order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.planner import local_planner as j_lp
from mpc_local_planner_tpu.utils import worlds as j_worlds

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.planner import local_planner as t_lp
from mpc_local_planner_tpu_torch.utils import worlds as t_worlds


def np_tree(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: np_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def _grid(seed, H=40, W=60, walls=6):
    rng = np.random.default_rng(seed)
    data = np.zeros((H, W), np.uint8)
    for _ in range(walls):
        y, x = rng.integers(0, H), rng.integers(0, W)
        if rng.uniform() < 0.5:
            data[y, x : x + rng.integers(5, 20)] = 254
        else:
            data[y : y + rng.integers(5, 20), x] = 254
    data[rng.integers(0, H, 30), rng.integers(0, W, 30)] = 100  # below lethal
    return data


def test_torch_costmap_matches_jax():
    data = _grid(0)
    jc = j_lp.Costmap(data=data, origin=(-1.0, 0.5), resolution=0.1)
    tc = t_lp.Costmap(data=data, origin=(-1.0, 0.5), resolution=0.1)
    assert t_lp.LETHAL_OBSTACLE == j_lp.LETHAL_OBSTACLE == 254
    rng = np.random.default_rng(1)
    for x, y in rng.uniform(-2.0, 6.0, size=(200, 2)):
        assert tc.world_to_map(x, y) == jc.world_to_map(x, y)
        assert tc.cell_cost(x, y) == jc.cell_cost(x, y)


@pytest.mark.parametrize("radius", [0, 1, 2, 4])
def test_torch_inflate_matches_jax(radius):
    data = _grid(radius + 2)
    np.testing.assert_array_equal(t_worlds.inflate(data, radius), j_worlds.inflate(data, radius))


@pytest.mark.parametrize("seed", range(6))
def test_torch_astar_plan_matches_jax(seed):
    data = _grid(seed + 10)
    args = dict(origin=(0.0, 0.0), resolution=0.1)
    jc, tc = j_lp.Costmap(data=data, **args), t_lp.Costmap(data=data, **args)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        start, goal = rng.uniform(0.2, 3.8, size=2), rng.uniform(0.2, 5.8, size=2)
        start[1], goal[1] = min(start[1], 3.8), min(goal[1], 3.8)
        for simplify in (True, False):
            try:
                want = j_worlds.astar_plan(jc, start, goal, robot_radius=0.15, simplify=simplify)
            except ValueError as err:
                with pytest.raises(ValueError, match=str(err).split(" ")[0]):
                    t_worlds.astar_plan(tc, start, goal, robot_radius=0.15, simplify=simplify)
                continue
            got = t_worlds.astar_plan(tc, start, goal, robot_radius=0.15, simplify=simplify)
            np.testing.assert_array_equal(got, want)


def _ensemble(B=8, seed=5):
    jspec = jb.family_spec("converter_lines", N=12)
    scen = jb.family_ensemble("converter_lines", jspec, B, jax.random.PRNGKey(seed))
    return scen, convert.from_numpy(Scenario, np_tree(scen), "cpu")


def test_torch_lines_astar_plans_match_jax():
    jscen, tscen = _ensemble()
    want, want_ok = jb.lines_astar_plans(jscen)
    got, ok = tb.lines_astar_plans(tscen)
    np.testing.assert_array_equal(ok, np.asarray(want_ok))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ok.sum() >= 6
    # a lane whose goal is walled in falls back to the straight line, ok False
    lines = np.array(jscen.obstacles.lines)
    mask = np.array(jscen.obstacles.line_mask)
    xf = np.asarray(jscen.xf[0, :2])
    box = [((-0.3, -0.3), (0.3, -0.3)), ((0.3, -0.3), (0.3, 0.3)), ((0.3, 0.3), (-0.3, 0.3)),
           ((-0.3, 0.3), (-0.3, -0.3))]
    for j, (a, c) in enumerate(box):
        lines[0, j] = (xf + a, xf + c)
        mask[0, j] = True
    jbad = dataclasses.replace(jscen, obstacles=dataclasses.replace(
        jscen.obstacles, lines=jnp.asarray(lines), line_mask=jnp.asarray(mask)))
    tbad = convert.from_numpy(Scenario, np_tree(jbad), "cpu")
    want, want_ok = jb.lines_astar_plans(jbad)
    got, ok = tb.lines_astar_plans(tbad)
    assert not ok[0] and not want_ok[0]
    np.testing.assert_array_equal(ok, np.asarray(want_ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_torch_lines_astar_plans_across_processes_are_the_same():
    _, tscen = _ensemble(B=5, seed=7)
    one, ok1 = tb.lines_astar_plans(tscen, n_points=12)
    two, ok2 = tb.lines_astar_plans(tscen, n_points=12, processes=2)
    np.testing.assert_array_equal(ok1, ok2)
    np.testing.assert_array_equal(one.numpy(), two.numpy())
    assert one.shape == (5, 12, 3)
