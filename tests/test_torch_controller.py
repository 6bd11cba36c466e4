"""The Controller: the port's ``planner/controller.py`` against the JAX
package's ``Controller`` (CPU, f64).

Both Controllers run the same configs on the same scenarios, made with numpy
from a seed (N=8, budgets of at most 2×2). Before each cycle JAX's warm
state is handed to the port (``convert.controller_state_from_numpy``), so
nothing drifts from cycle to cycle, and the cycle's ``ControlResult`` (u0,
twist, the state and control time series, the solve result) and the warm
state it leaves are held together:

* a batched B=4 fleet: cold, warm with ``elapsed`` (per-lane shifts), a
  one-lane goal change past ``force_reinit_new_goal_dist``, the 2-slot
  rescue, ``stuck_restart_cycles=1`` and one polish launch; then a JAX warm
  state handed to a fresh port Controller through numpy steps as JAX does;
* an unbatched minimum-time run seeded from a plan (obstacles from
  ``ObstacleSet.from_lists`` padded to the spec's slots);
* ``solver.type: lsq_lm``;
* ``precompile``'s count, ``calibrate_cycle_budget(phase_ms=...)``, the
  ``__init__`` refusals, and
  the float64 tier's settings: the preset drops the config's rho0 and
  rho_growth, as the JAX Controller builds it (captured from both packages'
  ``make_f64_fallback``).

Grid adaptation and ``reconfigure`` are in
``tests/test_torch_controller_adapt.py``. Tolerance: flags, horizons and
counters exact; every float of a lane within 1e-9 plus ten times the lane's
largest move in JAX's own cycle from the scenario one ulp away (these
unconverged 2×2 minimum-time solves amplify rounding: a lane's u0 moves
1e-9 under one ulp on its goal); the multipliers also within 1e-9 of the
lane's largest multiplier (they reach 1e6 with ρ).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_local_planner_tpu.solvers.f64_fallback as j_f64
from mpc_local_planner_tpu.geometry.obstacles import ObstacleSet as JObstacleSet
from mpc_local_planner_tpu.ocp.spec import Scenario as JScenario
from mpc_local_planner_tpu.planner.config import load_config as j_load
from mpc_local_planner_tpu.planner.controller import Controller as JController

import mpc_local_planner_tpu_torch.solvers.f64_fallback as t_f64
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.planner import Controller as TController
from mpc_local_planner_tpu_torch.planner import load_config as t_load

ATOL = 1e-9
N = 8


def carlike(N=N, slots=3, footprint=None, **solver):
    """The flagship's car at a small size: minimum time, xf fixed, budgets
    2×2 unless ``solver`` says otherwise."""
    base = {"tol_eq": 1e-3, "tol_ineq": 1e-3, "iterations": 2, "inner_iterations": 2,
            "warm_iterations": 2, "warm_inner_iterations": 2}
    return {
        "robot": {"type": "simple_car", "simple_car": {
            "wheelbase": 0.5, "max_vel_x": 0.4, "max_vel_x_backwards": 0.2,
            "max_steering_angle": 1.0, "acc_lim_x": 0.5}},
        "grid": {"grid_size_ref": N, "dt_ref": 0.3, "xf_fixed": [True, True, True],
                 "variable_grid": {"enable": True, "min_dt": 0.001, "max_dt": 0.5}},
        "planning": {"objective": {"type": "minimum_time"}},
        "collision": {"min_obstacle_dist": 0.1, "obstacle_capacity": slots},
        "footprint_model": footprint or {"type": "circular", "radius": 0.2},
        "solver": {**base, **solver},
    }


def controllers(cfg, batch=None):
    return (JController(j_load(cfg), batch=batch, dtype=jnp.float64),
            TController(t_load(cfg), batch=batch, dtype=torch.float64, device="cpu"))


# --------------------------------------------------------------------------- #
# scenarios as numpy trees with the JAX containers' field names
# --------------------------------------------------------------------------- #
def obstacles_np(batch, circles, radii, mask):
    z = np.zeros
    return dict(
        points=z(batch + (0, 2)), point_vels=z(batch + (0, 2)), point_mask=z(batch + (0,), bool),
        circles=circles, circle_radii=radii, circle_vels=z(circles.shape),
        circle_mask=mask, lines=z(batch + (0, 2, 2)), line_vels=z(batch + (0, 2)),
        line_mask=z(batch + (0,), bool), polygons=z(batch + (0, 8, 2)),
        polygon_nv=z(batch + (0,), np.int32), polygon_vels=z(batch + (0, 2)),
        polygon_mask=z(batch + (0,), bool),
    )


def fleet_np(rng, B, slots=3):
    x0 = np.zeros((B, 3))
    ang = rng.uniform(-0.6, 0.6, B)
    dist = rng.uniform(0.5, 1.8, B)
    xf = np.stack([dist * np.cos(ang), dist * np.sin(ang), ang], axis=-1)
    t = rng.uniform(0.3, 0.7, (B, slots))
    side = rng.choice([-1.0, 1.0], (B, slots)) * rng.uniform(0.35, 0.6, (B, slots))
    circles = (t[..., None] * xf[:, None, :2]
               + side[..., None] * np.stack([-np.sin(ang), np.cos(ang)], -1)[:, None, :])
    mask = np.broadcast_to(np.arange(slots) < 2, (B, slots))
    return dict(x0=x0, xf=xf, obstacles=obstacles_np((B,), circles,
                                                     rng.uniform(0.1, 0.2, (B, slots)), mask),
                via_points=np.zeros((B, 0, 3)), via_mask=np.zeros((B, 0), bool),
                u_prev=np.zeros((B, 2)))


def to_jax(tree):
    obs = JObstacleSet(**{k: jnp.asarray(v) for k, v in tree["obstacles"].items()})
    return JScenario(**{k: (obs if k == "obstacles" else jnp.asarray(v))
                        for k, v in tree.items()})


def to_torch(tree):
    return convert.from_numpy(TScenario, tree, "cpu")


def with_state(tree, x0=None, u_prev=None, xf=None):
    out = dict(tree)
    for k, v in (("x0", x0), ("u_prev", u_prev), ("xf", xf)):
        if v is not None:
            out[k] = np.array(v)
    return out


# --------------------------------------------------------------------------- #
# comparisons
# --------------------------------------------------------------------------- #
def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def flat(res, ctrl):
    """Every output of a cycle, by name: the ControlResult and the warm state
    the cycle leaves (None where there is none)."""
    out = {"u0": res.u0, "twist": res.twist}
    for name in ("x_seq", "u_seq"):
        out[f"{name}.times"] = getattr(res, name).times
        out[f"{name}.values"] = getattr(res, name).values

    def walk(prefix, tree):
        if dataclasses.is_dataclass(tree):
            tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}.{k}", v)
        else:
            out[prefix] = tree

    walk("solve", res.solve)
    walk("state", convert.controller_state_to_numpy(ctrl))
    return {k: (v if v is None or isinstance(v, int) else _np(v)) for k, v in out.items()}


def _lanes(a, batched):
    return a.reshape((a.shape[0], -1) if batched else (1, -1))


def assert_cycle_matches(got, want, moved, batched):
    """The port's cycle ``got`` against JAX's ``want``: flags, counters and
    horizons equal; every float of a lane within 1e-9 plus ten times the
    lane's largest move in JAX's own cycle from the scenario one ulp away
    (``moved``); the multipliers also within 1e-9 of the lane's largest
    multiplier (they reach 1e6 with ρ)."""
    assert got.keys() == want.keys()
    floats = [k for k, v in want.items()
              if v is not None and not isinstance(v, int) and v.dtype.kind == "f"]

    def lane_max(keys, fn):
        return np.max([_lanes(fn(k), batched).max(axis=1, initial=0.0) for k in keys], axis=0)

    duals = [k for k in floats if ".duals." in k]
    rest = [k for k in floats if k not in duals]
    move = lane_max(rest, lambda k: np.abs(moved[k] - want[k]))
    dual_move = lane_max(duals, lambda k: np.abs(moved[k] - want[k]))
    dual_size = lane_max(duals, lambda k: np.abs(want[k]))
    for k, w in want.items():
        g = got[k]
        if w is None or isinstance(w, int):
            assert g == w, k
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k not in floats:
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        tol = (ATOL + 10 * dual_move + ATOL * dual_size) if k in duals else ATOL + 10 * move
        err = _lanes(np.abs(g - w), batched).max(axis=1, initial=0.0)
        assert np.all(err <= tol), (k, err, tol)


def one_ulp(tree):
    return with_state(tree, x0=np.nextafter(tree["x0"], np.inf),
                      xf=np.nextafter(tree["xf"], np.inf))


def step_both(j_ctrl, t_ctrl, tree, plan=None, **kw):
    """One cycle of both Controllers from the same warm state: JAX's state is
    handed to the port through numpy first, so nothing drifts from cycle to
    cycle. JAX runs the cycle twice, from the scenario one ulp away (its
    own move under rounding) and from the scenario itself."""
    convert.controller_state_from_numpy(t_ctrl, convert.controller_state_to_numpy(j_ctrl))
    j_plan = None if plan is None else jnp.asarray(plan)
    t_plan = None if plan is None else torch.from_numpy(plan)
    before = dict(j_ctrl.__dict__)
    moved = flat(j_ctrl.step(to_jax(one_ulp(tree)), plan=j_plan, **kw), j_ctrl)
    j_ctrl.__dict__.update(before)
    j_res = j_ctrl.step(to_jax(tree), plan=j_plan, **kw)
    t_res = t_ctrl.step(to_torch(tree), plan=t_plan, **kw)
    assert_cycle_matches(flat(t_res, t_ctrl), flat(j_res, j_ctrl), moved,
                         batched=j_ctrl.batch is not None)
    return j_res, t_res


def advance(tree, j_res):
    """The demo's feedback: converged lanes move to their planned stage 1
    and apply u0; the rest hold."""
    conv = np.asarray(j_res.solve.converged)[..., None]
    xs = np.asarray(j_res.solve.primal.xs)
    us = np.asarray(j_res.solve.primal.us)
    return with_state(tree, x0=np.where(conv, xs[..., 1, :], tree["x0"]),
                      u_prev=np.where(conv, us[..., 0, :], tree["u_prev"]))


# --------------------------------------------------------------------------- #
# the batched fleet
# --------------------------------------------------------------------------- #
def test_torch_batched_controller_cycles_match_jax():
    B = 4
    cfg = carlike(rescue_slots=2, rescue_iterations=2, rescue_inner_iterations=2,
                  stuck_restart_cycles=1, polish_launches=1)
    j_ctrl, t_ctrl = controllers(cfg, batch=B)
    tree = fleet_np(np.random.default_rng(5), B)
    j_res, _ = step_both(j_ctrl, t_ctrl, tree)                 # cold
    tree = advance(tree, j_res)
    # the same interval covers a different number of stages on each lane
    steps = np.clip(np.round(0.6 / np.asarray(j_ctrl._primal.dt)), 1, N // 2)
    assert len(set(steps.tolist())) > 1, steps
    j_res, _ = step_both(j_ctrl, t_ctrl, tree, elapsed=0.6)    # per-lane shifts
    tree = advance(tree, j_res)
    xf = np.array(tree["xf"])
    xf[2, :2] += [0.0, 1.5]                                    # lane 2's goal moves
    tree = with_state(tree, xf=xf)
    j_res, _ = step_both(j_ctrl, t_ctrl, tree, elapsed=0.25)
    tree = advance(tree, j_res)
    step_both(j_ctrl, t_ctrl, tree)
    state = convert.controller_state_to_numpy(t_ctrl)
    assert state["steps_since_reinit"] == 3 and state["stuck"].dtype == np.int32


def assert_same_state(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert_same_state(a[k], b[k])
        elif a[k] is None or isinstance(a[k], int):
            assert a[k] == b[k], k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_torch_controller_state_round_trips_through_numpy():
    B = 3
    cfg = carlike(stuck_restart_cycles=2)
    t_ctrl = TController(t_load(cfg), batch=B, dtype=torch.float64, device="cpu")
    empty = convert.controller_state_to_numpy(t_ctrl)
    assert empty["primal"] is None and empty["N"] == N and empty["stuck"] is None
    tree = fleet_np(np.random.default_rng(9), B)
    t_ctrl.step(to_torch(tree))
    state = convert.controller_state_to_numpy(t_ctrl)
    assert state["stuck"].dtype == np.int32 and state["last_ok"].dtype == bool
    other = TController(t_load(cfg), batch=B, dtype=torch.float64, device="cpu")
    convert.controller_state_from_numpy(other, state)
    assert_same_state(convert.controller_state_to_numpy(other), state)
    # the next cycle is the same on both, bit for bit
    a, b = t_ctrl.step(to_torch(tree), elapsed=0.3), other.step(to_torch(tree), elapsed=0.3)
    assert torch.equal(a.u0, b.u0) and torch.equal(a.solve.primal.xs, b.solve.primal.xs)
    assert_same_state(convert.controller_state_to_numpy(other),
                      convert.controller_state_to_numpy(t_ctrl))


# --------------------------------------------------------------------------- #
# one robot
# --------------------------------------------------------------------------- #
def single_np(x0, xf, circles, slots):
    c = np.zeros((slots, 2))
    r = np.zeros(slots)
    for i, (cx, cy, cr) in enumerate(circles):
        c[i], r[i] = (cx, cy), cr
    return dict(x0=np.asarray(x0, float), xf=np.asarray(xf, float),
                obstacles=obstacles_np((), c, r, np.arange(slots) < len(circles)),
                via_points=np.zeros((0, 3)), via_mask=np.zeros((0,), bool), u_prev=np.zeros(2))


def test_torch_unbatched_min_time_controller_from_a_plan_matches_jax():
    cfg = carlike(slots=4, footprint={"type": "two_circles", "front_offset": 0.15,
                                      "front_radius": 0.2, "rear_offset": -0.15,
                                      "rear_radius": 0.2})
    j_ctrl, t_ctrl = controllers(cfg)
    circles = [(0.8, 0.45, 0.15), (1.3, -0.2, 0.15)]
    # the scenario holds 2 circle slots; the Controller pads it to the spec's 4
    tree = single_np([0.0, 0.0, 0.0], [1.8, 0.3, 0.2], circles, 2)
    plan = np.stack([np.linspace(0, 1.8, 6), 0.3 * np.sin(np.linspace(0, 1.6, 6)),
                     np.linspace(0, 0.2, 6)], axis=-1)
    for k in range(3):
        j_res, t_res = step_both(j_ctrl, t_ctrl, tree, plan=plan, elapsed=0.3)
        assert t_res.u0.shape == (2,) and t_res.x_seq.values.shape == (N + 1, 3)
        tree = with_state(tree, x0=np.asarray(j_res.solve.primal.xs[1]),
                          u_prev=np.asarray(j_res.u0))
    goal = to_torch(tree).xf
    assert t_ctrl.is_goal_reached(goal + 0.05, goal) == j_ctrl.is_goal_reached(
        jnp.asarray(tree["xf"]) + 0.05, jnp.asarray(tree["xf"])) is True
    assert t_ctrl.is_goal_reached(goal + 0.15, goal) == j_ctrl.is_goal_reached(
        jnp.asarray(tree["xf"]) + 0.15, jnp.asarray(tree["xf"])) is False


def test_torch_lsq_lm_controller_matches_jax():
    cfg = carlike(slots=2, type="lsq_lm")
    j_ctrl, t_ctrl = controllers(cfg)
    tree = single_np([0.0, 0.0, 0.0], [1.2, 0.4, 0.3], [(0.6, -0.3, 0.1)], 2)
    for k in range(2):
        j_res, _ = step_both(j_ctrl, t_ctrl, tree, elapsed=0.3)
        tree = with_state(tree, x0=np.asarray(j_res.solve.primal.xs[1]))


# --------------------------------------------------------------------------- #
# the host-side surface
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("phase_ms, budget, warm_iters", [(10.0, 25.0, 4), (30.0, 25.0, 3),
                                                          (5.0, 100.0, 3)])
def test_torch_calibrate_cycle_budget_caps_like_jax(phase_ms, budget, warm_iters):
    cfg = carlike(max_cycle_ms=budget, warm_iterations=warm_iters)
    j_ctrl, t_ctrl = controllers(cfg)
    assert t_ctrl.warm_settings.early_exit and j_ctrl.warm_settings.early_exit
    got = t_ctrl.calibrate_cycle_budget(None, phase_ms=phase_ms)
    assert got == j_ctrl.calibrate_cycle_budget(None, phase_ms=phase_ms) == phase_ms
    assert dataclasses.asdict(t_ctrl.warm_settings) == dataclasses.asdict(j_ctrl.warm_settings)
    assert t_ctrl.warm_settings.n_al == max(1, min(warm_iters, int(budget / phase_ms)))
    with pytest.raises(ValueError, match="max_cycle_ms is not set"):
        controllers(carlike())[1].calibrate_cycle_budget(None, phase_ms=1.0)


def test_torch_precompile_caches_what_jax_compiles():
    """One cached solve per (N, warm) of the ladder, as many as the JAX
    Controller's compiled programs; the live state is left as it was."""
    j_ctrl, t_ctrl = controllers(carlike(slots=2))
    tree = single_np([0.0, 0.0, 0.0], [1.2, 0.3, 0.2], [(0.6, -0.3, 0.12)], 2)
    got = t_ctrl.precompile(to_torch(tree), n_values=[N - 1, N])
    assert got == j_ctrl.precompile(to_jax(tree), n_values=[N - 1, N]) == 4
    assert sorted(t_ctrl._cache) == sorted(j_ctrl._cache)
    state = convert.controller_state_to_numpy(t_ctrl)
    assert state["primal"] is None and state["N"] == N


REFUSALS = [
    (dict(type="ipopt"), {}, None),
    (dict(type="lsq_lm", f64_fallback_slots=4), {}, None),
    ({}, {"variable_grid": {"enable": True, "min_dt": 0.001, "max_dt": 0.5,
                            "grid_adaptation": {"enable": True}}}, 4),
    ({}, {"type": "non_uniform_fd_grid", "variable_grid": {
        "enable": True, "grid_adaptation": {"enable": True}}}, None),
    ({}, {"variable_grid": {"enable": True, "grid_adaptation": {
        "enable": True, "mode": "redundant_controls"}}}, None),
    ({}, {"variable_grid": {"enable": False, "grid_adaptation": {"enable": True}}}, None),
    ({}, {"variable_grid": {"enable": True, "grid_adaptation": {
        "enable": True, "min_grid_size": 10, "max_grid_size": 20}}}, None),
]


@pytest.mark.parametrize("solver, grid, batch", REFUSALS)
def test_torch_controller_init_refuses_what_jax_refuses(solver, grid, batch):
    cfg = carlike(**solver)
    cfg["grid"] = {**cfg["grid"], **grid}
    with pytest.raises(ValueError) as j_err:
        JController(j_load(cfg), batch=batch, dtype=jnp.float64)
    with pytest.raises(ValueError) as t_err:
        TController(t_load(cfg), batch=batch, dtype=torch.float64, device="cpu")
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("batch", [None, 4])
def test_torch_f64_tier_settings_drop_the_rho_overrides_as_jax_does(monkeypatch, batch):
    """The float64 tier's preset is the family's cold preset with n_al/n_sqp
    maxed against the config's, early_exit and the warm tolerances: the
    config's rho0 and rho_growth do not reach it (JAX controller.py:275-283,
    kept as it is)."""
    captured = {}

    def capture(tag):
        def make(spec, settings, slots, *args, **kwargs):
            captured[tag] = (spec.N, settings, slots, kwargs.get("device"))
            return lambda scenario, result, fresh=None: result
        return make

    monkeypatch.setattr(j_f64, "make_f64_fallback", capture("jax"))
    monkeypatch.setattr(t_f64, "make_f64_fallback", capture("torch"))
    cfg = carlike(f64_fallback_slots=3, rho0=50.0, rho_growth=3.0, iterations=3,
                  inner_iterations=20, tol_eq=2e-3)
    j_ctrl, t_ctrl = controllers(cfg, batch=batch)
    j_ctrl._f64_pass(None, None)
    t_ctrl._f64_pass(None, None)
    (jn, js, jslots, _), (tn, ts, tslots, tdev) = captured["jax"], captured["torch"]
    assert (tn, tslots) == (jn, jslots) == (N, 3)
    assert tdev == t_ctrl.device
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert (ts.n_al, ts.n_sqp, ts.early_exit, ts.tol_eq) == (16, 20, True, 2e-3)
    assert (ts.rho0, ts.rho_growth) == (100.0, 10.0)  # the preset's, not 50 and 3
    assert t_ctrl.settings.rho0 == 50.0
    # one tier per live N, cached
    t_ctrl._f64_pass(None, None)
    assert list(t_ctrl._f64_cache) == [N]
