"""Via points on the CPU, the cold problems and path D's cycle (the warm
solves are ``tests/test_torch_via_solves.py``'s; two files, so that a
parallel run spreads the JAX compiles):

- The problems of ``tests/test_via_golden.py`` (a unicycle through two via
  points, from the straight-line seed at the cold preset) and of
  ``tests/test_via_ordered.py`` (the crossing tour: ordered from the plan
  that visits the via points in list order, unordered from the straight
  line): the port's un-fused solve and ``fused_solve_plain`` against JAX
  ``vmap(solve_single)`` in float64 at 1e-9 (the multipliers at 1e-9 +
  ρ·1e-13); the golden problem's answer also against JAX's
  ``solve_golden`` (SLSQP) within the JAX test's 2e-3 on T.
- Path D's fleet cycle with ``stuck_restart`` and the rescue chained twice,
  against the JAX cycle (``tests/test_torch_k2c_cycle.py``'s harness).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.ocp.grid import primal_from_plan as j_primal_from_plan
from mpc_local_planner_tpu.ocp.spec import Scenario as JScenario
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.solvers.golden import solve_golden

import test_torch_k2c_cycle as cycle_harness
from test_torch_footprints_lp_solves import _assert_f64_matches
from test_torch_quadratic import np_tree, to_torch
from test_torch_via_solves import _solver
from test_via_ordered import LIMITS, _spec as j_ordered_spec, _tour_plan
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.geometry.footprints import PointFootprint
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec
from mpc_local_planner_tpu_torch.solvers import al_sqp
from mpc_local_planner_tpu_torch.systems.models import RobotLimits, UnicycleModel


# --------------------------------------------------------------------------- #
# the golden and the ordered-tour problems (float64, the cold preset)
# --------------------------------------------------------------------------- #
def _golden_specs():
    """tests/test_via_golden.py's problem: a unicycle, a point footprint, N=20,
    two via points at weight 100, fixed terminal pose."""
    kw = dict(N=20, objective="minimum_time_via_points", variable_dt=True, dt_min=1e-3,
              dt_max=1.0, dt_ref=0.3, xf_fixed=(True, True, True), via_cap=2,
              via_position_weight=100.0)
    from mpc_local_planner_tpu.geometry.footprints import PointFootprint as JPoint
    from mpc_local_planner_tpu.ocp.spec import OcpSpec as JSpec
    from mpc_local_planner_tpu.systems.models import RobotLimits as JLimits
    from mpc_local_planner_tpu.systems.models import UnicycleModel as JUnicycle

    lim = dict(max_vel_x=0.4, max_vel_x_backwards=0.2, max_vel_theta=0.4)
    return (JSpec(model=JUnicycle(), footprint=JPoint(), limits=JLimits(**lim), **kw),
            OcpSpec(model=UnicycleModel(), footprint=PointFootprint(),
                    limits=RobotLimits(**lim), **kw))


def _tour_specs(ordered):
    """tests/test_via_ordered.py's crossing tour at N=30."""
    lim = dict(max_vel_x=0.5, max_vel_x_backwards=0.2, max_vel_theta=0.8)
    jspec = dataclasses.replace(j_ordered_spec(ordered, N=30),
                                limits=dataclasses.replace(LIMITS, **lim))
    kw = {f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)
          if f.name not in ("model", "footprint", "limits")}
    return jspec, OcpSpec(model=UnicycleModel(), footprint=PointFootprint(),
                          limits=RobotLimits(**lim), **kw)


@functools.lru_cache(maxsize=None)
def jax_cold(problem):
    """One scenario (a batch of 1) at the cold preset, float64: the inputs
    (numpy trees) and the JAX solve; the golden problem's T from
    ``solve_golden`` polishing the JAX answer."""
    if problem == "golden":
        jspec, _ = _golden_specs()
        xf, vias = [2.0, 0.0, 0.0], [[0.7, 0.35, 0.0], [1.4, -0.3, 0.0]]
    else:
        jspec, _ = _tour_specs(problem == "tour_ordered")
        xf, vias = [3.0, 0.0, 0.0], [[2.0, 0.45, 0.0], [1.0, -0.45, 0.0]]
    scen = JScenario.goal_only(jnp.array([[0.0, 0.0, 0.0]]), jnp.array([xf]), via_cap=2,
                               dtype=jnp.float64)
    scen = dataclasses.replace(scen, via_points=jnp.array([vias], jnp.float64),
                               via_mask=jnp.ones((1, 2), bool))
    if problem == "tour_ordered":  # seeded from the plan through the via points in order
        init = jax.vmap(lambda x0: j_primal_from_plan(jspec, _tour_plan(), x0))(scen.x0)
    else:
        init = j_initial_primal(jspec, scen)
    st = j_al.SolverSettings.for_spec(jspec)
    duals = jax.tree_util.tree_map(lambda a: a[None], j_al.init_duals(jspec, st, jnp.float64))
    r = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, st, s, i, d)))(
        scen, init, duals)
    golden_T = None
    if problem == "golden":
        one = jax.tree_util.tree_map(lambda a: a[0], (scen, r.primal))
        sol, res = solve_golden(jspec, one[0], init=one[1], tol=1e-11)
        assert res.status in (0, 8), res.message
        golden_T = float(sol.dt) * jspec.N
    return (np_tree(scen), np_tree(init), np_tree(duals)), np_tree(r), golden_T


@pytest.mark.parametrize("path", ["unfused", "plain"])
@pytest.mark.parametrize("problem", ["golden", "tour_ordered", "tour_unordered"])
def test_torch_via_cold_solve_matches_jax_and_the_golden_answer(problem, path):
    (scen, init, duals), j, golden_T = jax_cold(problem)
    spec = _golden_specs()[1] if problem == "golden" else _tour_specs(
        problem == "tour_ordered")[1]
    st = al_sqp.SolverSettings.for_spec(spec)
    t = convert.to_numpy(_solver(spec, st, path)(*to_torch(scen, init, duals)))
    _assert_f64_matches(t, j)
    assert t["converged"].all()
    xs = t["primal"]["xs"][0]
    reached = [int(np.argmin(np.linalg.norm(xs[:, :2] - vp[:2], axis=1)))
               for vp in scen["via_points"][0]]
    for vp in scen["via_points"][0]:  # the trajectory passes near both via points
        assert np.min(np.linalg.norm(xs[:, :2] - vp[:2], axis=1)) < 0.15
    T = float(t["primal"]["dt"][0]) * spec.N
    if problem == "golden":
        assert abs(T - golden_T) / golden_T < 2e-3, (T, golden_T)
    elif problem == "tour_ordered":  # list order: via 0 before via 1
        assert reached[0] < reached[1]
    else:  # geometric order: via 1 (x = 1) first
        assert reached[1] < reached[0]


# --------------------------------------------------------------------------- #
# path D's fleet cycle against the JAX cycle
# --------------------------------------------------------------------------- #
def test_torch_via_fleet_cycle_with_stuck_restart_matches_jax():
    """``tests/test_torch_k2c_cycle.py``'s cycle (stuck and diverged lanes
    restarted, the rescue chained twice, ``rho0_fail``) on path D's family,
    its via points pulled in with the goals."""
    family = "via_points"
    paths = dict(cycle_harness.PATHS, via_points=(7, 300.0))
    scen, r, stuck = cycle_harness._start_state(family, paths)
    assert scen["via_mask"].all() and scen["via_points"].shape[-2] == 4
    ts2, tr2, tk2 = cycle_harness._cycle_torch(family, scen, r, stuck, paths)
    js2, jr2, jk2 = cycle_harness._cycle_jax(family, scen, r, stuck, paths)
    cycle_harness.assert_cycles_match(scen, r, stuck, (ts2, tr2, tk2), (js2, jr2, jk2))
