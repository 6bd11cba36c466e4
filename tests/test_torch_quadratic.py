"""The diff-drive quadratic-form family on the CPU: BASELINE config #2
(unicycle, disc footprint, circle slots, the quadratic form with Qf, the
terminal ball, a fixed dt), config #1 (integral left-sum, no obstacle slot),
config #2 with the integral trapezoidal form, the hybrid time weight and a
variable dt, and the flagship with the front-wheel-driven car or the
kinematic bicycle. Each case is held against the JAX package, from the same
inputs handed over through numpy:

- the models' ``f`` and bounds, and ``total_cost`` in its three quadratic
  forms with Qf and the hybrid term (1e-12, float64);
- the fused kernel's closed-form derivatives (``fused_kkt_system``) against
  the port's AD path (``al_sqp._kkt_system``) at 1e-10 in float64, at random
  iterates and at ties: the terminal ball exactly active with a zero
  multiplier (the exact Hessian adds ρ/4·g′g′ᵀ there), a rate and a box row
  exactly active;
- the port's un-fused ``solve`` and the kernel's plain version
  ``fused_solve_plain`` against JAX ``vmap(solve_single)`` at the warm
  settings of ``tests/test_fused_solver.py`` (2×3, 8 candidates, 1e-3
  tolerances): float64 on every lane at 1e-9; float32 with that file's
  tolerances (xs and us 5e-5, dt 1e-5, duals 5e-3 absolute or 1e-3
  relative, cost 1e-4 absolute or 1e-5 relative, identical conv flags) on
  the lanes both converged.
  Both start from one warm state: the JAX result of a first 2×3 solve from
  the straight-line seed, goals pulled in to 30% of their distance, on the
  ensemble key that ``tests/test_fused_solver.py`` gives each case. The
  float32 comparison leaves out converged lanes whose answer float32
  rounding alone moves past the tolerance (``assert_matches_jax``): ρ
  reaches 7.5e4 in the second solve, and ρ times one ulp of a converged
  defect moves a multiplier by 7e-3.

It also holds the scope, the operation count and the float64 agreement
rule of ``solvers/agreement.py``; ``tests/test_torch_quadratic_cycle.py``
holds the fleet cycle.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp import costs as j_costs
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.systems import models as jm

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ocp import costs as t_costs
from mpc_local_planner_tpu_torch.ocp.grid import Primal, initial_primal
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec, Scenario
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp
from mpc_local_planner_tpu_torch.systems import models as tm

B, N, M = 12, 8, 4
WARM = dict(
    n_al=2, n_sqp=3, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
    alphas=(1.0, 0.7, 0.5, 0.35, 0.22, 0.14, 0.08, 0.03),
)
KKT_NAMES = ("Fz", "Gz", "rz", "Hzz", "Hzu", "Huu", "hz", "hu", "PN", "pN")
TRAPEZOIDAL = dict(
    integral_form=True, cost_integration="trapezoidal", hybrid_time_weight=0.5,
    variable_dt=True, dt_min=1e-3, dt_max=0.5,
)


def spec_pair(case):
    """(JAX spec, port spec) of a parity case."""
    if case == "config2":
        return jb.config2_diffdrive_obstacles(N=N, obstacle_cap=M), tb.config2_diffdrive_obstacles(
            N=N, obstacle_cap=M)
    if case == "config1":
        return (
            dataclasses.replace(jb.config1_unicycle_quadratic(N=N), integral_form=True),
            dataclasses.replace(tb.config1_unicycle_quadratic(N=N), integral_form=True),
        )
    if case == "trapezoidal":
        j, t = spec_pair("config2")
        return dataclasses.replace(j, **TRAPEZOIDAL), dataclasses.replace(t, **TRAPEZOIDAL)
    j = jb.config3_carlike_min_time(N=N, obstacle_cap=M)
    t = tb.config3_carlike_min_time(N=N, obstacle_cap=M)
    if case == "front-wheel":
        return (
            dataclasses.replace(j, model=jm.SimpleCarFrontWheelDrivingModel(wheelbase=0.5)),
            dataclasses.replace(t, model=tm.SimpleCarFrontWheelDrivingModel(wheelbase=0.5)),
        )
    assert case == "bicycle", case
    return (
        dataclasses.replace(j, model=jm.KinematicBicycleModelVelocityInput(lf=0.3, lr=0.2)),
        dataclasses.replace(t, model=tm.KinematicBicycleModelVelocityInput(lf=0.3, lr=0.2)),
    )


CASES = ("config2", "config1", "trapezoidal", "front-wheel", "bicycle")
# each case's ensemble key: the one tests/test_fused_solver.py gives it
KEYS = {"config2": 3, "config1": 11, "trapezoidal": 9, "front-wheel": 13, "bicycle": 13}


def np_tree(tree):
    if isinstance(tree, dict):
        return tree
    if dataclasses.is_dataclass(tree):
        return {f.name: np_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def to_torch(scen, init, duals):
    return (
        convert.from_numpy(Scenario, np_tree(scen), "cpu"),
        convert.from_numpy(Primal, np_tree(init), "cpu"),
        convert.from_numpy(al_sqp.DualState, np_tree(duals), "cpu"),
    )


TOL = {
    "f64": dict(xs=1e-9, us=1e-9, dt=1e-9, duals=1e-9, rel=0.0, cost=1e-9, cost_rel=0.0),
    "f32": dict(xs=5e-5, us=5e-5, dt=1e-5, duals=5e-3, rel=1e-3, cost=1e-4, cost_rel=1e-5),
}


def _as(tree, dtype):
    if isinstance(tree, dict):
        return {k: _as(v, dtype) for k, v in tree.items()}
    return tree.astype(dtype) if np.issubdtype(tree.dtype, np.floating) else tree


@functools.lru_cache(maxsize=None)
def jax_solver(case):
    """JAX ``vmap(solve_single)`` at the warm settings, jitted once per case
    (float32 and float64 trace it once each)."""
    jspec, _ = spec_pair(case)
    jst = j_al.SolverSettings(**WARM)
    return jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, jst, s, i, d)))


@functools.lru_cache(maxsize=None)
def jax_solves(case, dtype_name):
    """The warm inputs (numpy trees), the JAX solve from them (a first 2×3
    solve from the straight-line seed, then the compared one) and, in
    float32, the JAX float64 solve from the same inputs."""
    jdtype = {"f32": jnp.float32, "f64": jnp.float64}[dtype_name]
    jspec, _ = spec_pair(case)
    scen = jb.random_ensemble(jspec, B, jax.random.PRNGKey(KEYS[case]), dtype=jdtype)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.3 * (scen.xf - scen.x0))
    jst = j_al.SolverSettings(**WARM)
    duals = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), j_al.init_duals(jspec, jst, jdtype)
    )
    solve = jax_solver(case)
    first = solve(scen, j_initial_primal(jspec, scen), duals)
    inputs = (np_tree(scen), np_tree(first.primal), np_tree(first.duals))
    out = np_tree(solve(scen, first.primal, first.duals))
    if dtype_name == "f64":
        return inputs, out, None
    up = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        (scen, first.primal, first.duals),
    )
    return inputs, out, np_tree(solve(*up))


def lanes_within(t, j, lanes, tol):
    """Lanes of ``lanes`` on which result trees ``t`` and ``j`` agree within
    ``tol``."""
    ok = lanes.copy()
    for k in ("xs", "us", "dt"):
        d = np.abs(t["primal"][k] - j["primal"][k]).reshape(B, -1)
        ok &= np.all(d <= tol[k], axis=1)
    ok &= np.abs(t["cost"] - j["cost"]) <= tol["cost"] + tol["cost_rel"] * np.abs(j["cost"])
    for k in j["duals"]:
        a, b = t["duals"][k].reshape(B, -1), j["duals"][k].reshape(B, -1)
        ok &= np.all(np.abs(a - b) <= np.maximum(tol["duals"], tol["rel"] * np.abs(b)), axis=1)
    return ok


def assert_matches_jax(t, j, dtype_name, j64=None, ts_ulp=()):
    """The parity tolerances of the module docstring. In float32 a lane is
    compared where both converged and where float32 rounding alone does not
    move either answer past those tolerances: the JAX float64 solve from the
    same float32 inputs agrees with the JAX float32 one, and the port's
    solves ``ts_ulp`` from states one ulp up and down agree with its own.
    Elsewhere a near-tie of two line-search candidates, or ρ times the
    rounding of a converged defect, leaves the float32 answer undetermined
    at that tolerance."""
    np.testing.assert_array_equal(t["converged"], j["converged"])
    assert t["primal"]["xs"].dtype == j["primal"]["xs"].dtype
    tol = TOL[dtype_name]
    if dtype_name == "f64":
        lanes = np.ones(B, dtype=bool)
    else:
        lanes = lanes_within(_as(j64, np.float32), j, t["converged"] & j["converged"], tol)
        for q in ts_ulp:
            lanes = lanes_within(q, t, lanes, tol)
    np.testing.assert_array_equal(lanes_within(t, j, lanes, tol), lanes)
    return lanes


def check_solves(case, dtype_name, path):
    """The port's solve on ``path`` against the JAX solve of ``jax_solves``."""
    (scen, init, duals), j, j64 = jax_solves(case, dtype_name)
    _, spec = spec_pair(case)
    st = al_sqp.SolverSettings(**WARM)
    if path == "unfused":
        solve = al_sqp.make_solver(spec, st, device="cpu")
    else:
        solve = functools.partial(k2a.fused_solve_plain, spec, st)
    ts, ti, td = to_torch(scen, init, duals)
    before = riccati_cuda.lqr_solve_cuda.launches
    t = convert.to_numpy(solve(ts, ti, td))
    assert riccati_cuda.lqr_solve_cuda.launches == before  # CPU: the plain KKT solve
    ts_ulp = ()
    if dtype_name == "f32":
        ts_ulp = [convert.to_numpy(solve(ts, q, td)) for q in agreement.ulp_perturbed(ti)]
    lanes = assert_matches_jax(t, j, dtype_name, j64, ts_ulp)
    assert lanes.any() and (dtype_name == "f32" or not j["converged"].all())
    return t, j


# --------------------------------------------------------------------------- #
# models and costs
# --------------------------------------------------------------------------- #
MODEL_PAIRS = {
    "unicycle": (jm.UnicycleModel(), tm.UnicycleModel()),
    "front-wheel": (
        jm.SimpleCarFrontWheelDrivingModel(wheelbase=0.7),
        tm.SimpleCarFrontWheelDrivingModel(wheelbase=0.7),
    ),
    "bicycle": (
        jm.KinematicBicycleModelVelocityInput(lf=0.3, lr=0.2),
        tm.KinematicBicycleModelVelocityInput(lf=0.3, lr=0.2),
    ),
}


@pytest.mark.parametrize("name", sorted(MODEL_PAIRS))
def test_torch_models_match_jax(name):
    jmod, tmod = MODEL_PAIRS[name]
    rng = np.random.default_rng(5)
    x, u = rng.normal(size=(40, 3)), rng.normal(size=(40, 2)) * 0.6
    np.testing.assert_allclose(
        tmod.f(torch.from_numpy(x), torch.from_numpy(u)).numpy(), jmod.f(x, u),
        atol=1e-12, rtol=0,
    )
    limits = jm.RobotLimits(
        max_vel_x=0.5, max_vel_x_backwards=0.1, max_vel_theta=0.7, acc_lim_x=0.4,
        dec_lim_x=0.0, acc_lim_theta=0.9, max_steering_angle=0.8, max_steering_rate=0.3,
    )
    tlimits = tm.RobotLimits(**dataclasses.asdict(limits))
    for which in ("control_bounds", "control_rate_bounds"):
        for a, b in zip(getattr(tmod, which)(tlimits), getattr(jmod, which)(limits)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b, dtype=np.float64))
    # torch.func keeps float32: the parameters enter f as float32 tensors
    J = torch.func.jacfwd(tmod.f, argnums=(0, 1))(
        torch.from_numpy(x[0]).float(), torch.from_numpy(u[0]).float()
    )
    assert J[0].dtype == J[1].dtype == torch.float32


@pytest.mark.parametrize("form", ["plain", "left-sum", "trapezoidal"])
def test_torch_total_cost_matches_jax(form):
    """total_cost of the three quadratic forms with Qf and the hybrid term,
    with a candidate axis in front of the lane axis as the line search
    evaluates it."""
    extra = dict(qf_diag=(3.0, 5.0, 7.0), hybrid_time_weight=0.7, q_diag=(2.0, 1.5, 0.5))
    if form != "plain":
        extra.update(integral_form=True, cost_integration=form.replace("-", "_"))
    jspec, tspec = (dataclasses.replace(s, **extra) for s in spec_pair("config2"))
    rng = np.random.default_rng(7)
    xs, us = rng.normal(size=(3, 5, N + 1, 3)), rng.normal(size=(3, 5, N, 2))
    dt, xf = rng.uniform(0.1, 0.5, size=(3, 5)), rng.normal(size=(5, 3))
    jscen = jb.random_ensemble(jspec, 5, jax.random.PRNGKey(0), dtype=jnp.float64)
    jscen = dataclasses.replace(jscen, xf=jnp.asarray(xf))
    tscen = convert.from_numpy(Scenario, np_tree(jscen), "cpu")
    T = torch.from_numpy
    got = t_costs.total_cost(tspec, T(xs), T(us), T(dt), tscen)
    want = j_costs.total_cost(jspec, xs, us, dt, jscen)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)


def test_torch_spec_admits_the_quadratic_family_and_refuses_the_rest():
    _, c2 = spec_pair("config2")
    for kw in (TRAPEZOIDAL, dict(variable_dt=False, objective="minimum_time"),
               dict(model=tm.KinematicBicycleModelVelocityInput()), dict(via_cap=2)):
        assert k2a.fused_supported(dataclasses.replace(c2, **kw))
    with pytest.raises(ValueError, match="hybrid_time_weight"):
        dataclasses.replace(c2, hybrid_time_weight=-1.0)
    with pytest.raises(ValueError, match="cost_integration"):
        dataclasses.replace(c2, cost_integration="simpson")
    # the midpoint and Crank–Nicolson rules (K2b) are admitted, and in the
    # kernel's scope
    for rule in ("midpoint_differences", "crank_nicolson_differences"):
        assert k2a.fused_supported(dataclasses.replace(c2, collocation=rule))
    # the non-uniform grid (K2f) is admitted, and in the kernel's scope
    assert k2a.fused_supported(dataclasses.replace(c2, nonuniform_dt=True, variable_dt=True))
    assert isinstance(c2, OcpSpec) and c2.ball_radius == 0.2 and not c2.variable_dt


# --------------------------------------------------------------------------- #
# closed forms against the AD path (float64)
# --------------------------------------------------------------------------- #
def iterate(case, seed, ties=False, batch=6):
    """A float64 iterate of ``case`` away from the seed (x_N up to about a
    third of a metre off the goal), with obstacles on the trajectory (stage
    3 and x_N) and random duals. ``ties``: a rate row
    and a box row exactly active with zero multipliers and, where the spec
    has a terminal ball, the ball exactly active (radius 0.25, x_N a
    quarter metre from the goal along x) with a zero multiplier."""
    _, spec = spec_pair(case)
    if ties and spec.ball_radius > 0.0:
        spec = dataclasses.replace(spec, ball_radius=0.25)
    scen = tb.random_ensemble(
        spec, batch, torch.Generator().manual_seed(seed), dtype=torch.float64, device="cpu"
    )
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))  # noqa: E731
    init = initial_primal(spec, scen)
    xs = init.xs + T(0.05 * rng.normal(size=init.xs.shape))
    us = init.us + T(0.05 * rng.normal(size=init.us.shape))
    dt = init.dt * T(rng.uniform(0.8, 1.2, size=batch))
    xs[:, N, :2] += T(0.3 * rng.normal(size=(batch, 2)))  # the ball active on some lanes
    if spec.obstacle_cap:
        obs = scen.obstacles
        circles = obs.circles.clone()
        circles[:, 0] = xs[:, 3, :2] + T(0.1 * rng.normal(size=(batch, 2)))
        circles[:, 1] = xs[:, N, :2] + T(0.1 * rng.normal(size=(batch, 2)))
        mask = obs.circle_mask.clone()
        mask[:, :2] = True
        scen = dataclasses.replace(
            scen, obstacles=dataclasses.replace(obs, circles=circles, circle_mask=mask)
        )
    Mc = spec.obstacle_cap
    duals = al_sqp.DualState(
        lam_def=T(rng.normal(size=(batch, N, 3))),
        lam_term=T(rng.normal(size=(batch, 3))),
        mu_obs=T(rng.uniform(0.0, 2.0, size=(batch, N, Mc))),
        mu_rate=T(rng.uniform(0.0, 1.0, size=(batch, N, 4))),
        mu_box=T(rng.uniform(0.0, 1.0, size=(batch, N, 4))),
        mu_dt=T(rng.uniform(0.0, 1.0, size=(batch, 2))),
        mu_ball=T(rng.uniform(0.0, 3.0, size=(batch, 1))),
        rho=T(rng.uniform(50.0, 200.0, size=batch)),
    )
    if ties:
        dt = torch.full_like(dt, 0.25)
        lo_r, hi_r = spec.control_rate_box()
        lo_u, hi_u = spec.control_box()
        us[:, 2, 0] = 0.0
        us[:, 3, 0] = float(hi_r[0]) * dt  # rate row 0 at stage 3: du − acc·dt == 0
        us[:, 2, 1] = float(hi_u[1])  # box row 1 at stage 2: u − hi == 0
        mu_rate, mu_box = duals.mu_rate.clone(), duals.mu_box.clone()
        mu_rate[:, 3, 0] = 0.0
        mu_box[:, 2, 1] = 0.0
        duals = dataclasses.replace(duals, mu_rate=mu_rate, mu_box=mu_box)
        if spec.ball_radius > 0.0:
            xf = scen.xf.clone()
            # goals on a quarter-metre grid: x_N ⊖ xf is exactly (0.25, 0, ·)
            xf[:, :2] = T(np.round(4.0 * rng.uniform(-2.0, 2.0, size=(batch, 2))) / 4.0)
            xs[:, N, 0] = xf[:, 0] + 0.25
            xs[:, N, 1] = xf[:, 1]
            scen = dataclasses.replace(scen, xf=xf)
            duals = dataclasses.replace(duals, mu_ball=torch.zeros_like(duals.mu_ball))
    return spec, scen, Primal(xs=xs, us=us, dt=dt), duals


def ad_and_closed_forms(spec, scen, primal, duals):
    obs_k = al_sqp._stage_obstacles(spec, scen, primal.dt, N + 1)
    ad = al_sqp._kkt_system(
        spec, al_sqp._make_stage_fns(spec), al_sqp._make_terminal_fns(spec),
        primal, scen, duals, obs_k,
    )
    cf = k2a.fused_kkt_system(spec, primal, scen, duals, obs_k)
    return ad, cf


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("case", CASES)
def test_torch_quadratic_closed_forms_match_the_ad_path(case, ties):
    spec, scen, primal, duals = iterate(case, 2, ties=ties)
    ad, cf = ad_and_closed_forms(spec, scen, primal, duals)
    for name, a, b in zip(KKT_NAMES, cf, ad):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64, name
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0, msg=name)
    rho, Fz = duals.rho, cf[0]
    if not spec.variable_dt:  # no free δτ: the transition's dt column is zero
        assert bool((Fz[..., :3, 5] == 0).all())
    if ties:
        g_r = k2a.rate_g(spec, primal.us[:, 3], primal.us[:, 2], primal.dt)
        assert bool((g_r[:, 0] == 0).all())
        assert bool((k2a.box_g(spec, primal.us[:, 2])[:, 1] == 0).all())
    if ties and spec.ball_radius > 0.0:
        gb, gp = k2a.ball_g(spec, primal.xs[:, N], scen.xf)
        assert bool((gb == 0).all())
        # at the tie the ball adds exactly ρ/4·g′g′ᵀ to the pose block of PN
        # (a = 0, so no curvature term), and nothing to pN
        off = dataclasses.replace(spec, ball_radius=0.0)
        PN0, pN0 = k2a.terminal_Pp(
            off, primal.xs[:, N], primal.dt, scen.xf, duals.lam_term, duals.mu_obs[:, N - 1],
            duals.mu_dt, rho, scen.obstacles, duals.mu_ball,
        )
        ball = torch.zeros_like(PN0)
        ball[:, :3, :3] = (rho / 4)[:, None, None] * gp[:, :, None] * gp[:, None, :]
        torch.testing.assert_close(cf[8] - PN0, ball, atol=1e-10, rtol=0)
        torch.testing.assert_close(cf[9], pN0, atol=1e-10, rtol=0)
    if spec.objective == "quadratic_form" and spec.integral_form:
        assert bool((cf[3][..., :3, 5] != 0).any())  # the integral form's dt rows


def test_torch_quadratic_closed_forms_engage_the_ball_multiplier():
    """At a random iterate the ball row is active on some lanes (μ + ρg > 0),
    so its gradient and curvature enter pN and PN there."""
    spec, scen, primal, duals = iterate("config2", 3)
    gb, _ = k2a.ball_g(spec, primal.xs[:, N], scen.xf)
    assert bool((duals.mu_ball[:, 0] + duals.rho * gb > 0).any())


def test_torch_quadratic_kkt_keeps_float32():
    """The AD path's derivatives of the quadratic objective, the terminal
    cost and the ball stay float32 (torch.func promotes a 0-d tensor times a
    Python float to a float64 tangent)."""
    spec, scen, primal, duals = iterate("trapezoidal", 5)
    f32 = lambda t: al_sqp.tree_map(  # noqa: E731
        lambda a: a.float() if a.is_floating_point() else a, t)
    ad, cf = ad_and_closed_forms(spec, f32(scen), f32(primal), f32(duals))
    for name, a, b in zip(KKT_NAMES, ad, cf):
        assert a.dtype == b.dtype == torch.float32, name


# --------------------------------------------------------------------------- #
# whole solves against JAX vmap(solve_single): config #2 and config #1
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("path", ["unfused", "plain"])
@pytest.mark.parametrize("dtype_name", ["f64", "f32"])
@pytest.mark.parametrize("case", CASES)
def test_torch_quadratic_solve_matches_jax(case, dtype_name, path):
    t, j = check_solves(case, dtype_name, path)
    if case == "config2":  # the ball multiplier engages, as in the JAX tests
        assert j["duals"]["mu_ball"].max() > 0.0 and t["duals"]["mu_ball"].max() > 0.0
        dt = t["primal"]["dt"]  # the line search pins a fixed dt at dt_ref
        np.testing.assert_array_equal(dt, np.full(B, 0.3, dtype=dt.dtype))
    if case == "trapezoidal":  # the ball engages; dt moves inside its box
        assert j["duals"]["mu_ball"].max() > 0.0
        assert (t["primal"]["dt"] != t["primal"]["dt"][0]).any()


# --------------------------------------------------------------------------- #
# scope, dispatch and the bound
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", CASES)
def test_torch_quadratic_dispatch_admits_the_family(case):
    _, spec = spec_pair(case)
    scen = tb.random_ensemble(spec, 4, torch.Generator().manual_seed(0), device="cpu")
    st = al_sqp.SolverSettings(**WARM)
    assert al_sqp.fused_dispatch_ok(spec, st, scen, torch.float32, "cuda")
    assert not al_sqp.fused_dispatch_ok(spec, st, scen, torch.float32, "cpu")
    cold = al_sqp.SolverSettings.for_spec(spec)
    assert not al_sqp.fused_dispatch_ok(spec, cold, scen, torch.float32, "cuda")
    init, duals = al_sqp.default_init(spec, st, scen)
    with pytest.raises(ValueError, match="CUDA"):
        k2a.fused_solve_cuda(spec, st, scen, init, duals)
    assert k2a.fused_supported(dataclasses.replace(spec, N=65))  # no horizon cap
    wide = dataclasses.replace(spec, via_cap=9)
    with pytest.raises(NotImplementedError, match="via_cap=9.*JAX fused_supported"):
        k2a.fused_solve_cuda(wide, st, scen, init, duals)
    ins, outs = k2a.kernel_io(spec, scen, init, duals)
    assert len(ins) == 26 and len(outs) == 15
    params = k2a._params(spec, st, scen.obstacles)
    assert params.model == k2a.MODEL_IDS[type(spec.model)]
    assert params.quadratic == (spec.objective == "quadratic_form")
    assert (params.dt_lo, params.dt_hi) == al_sqp.dt_clip(spec)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("case", CASES)
def test_torch_quadratic_step_structure_matches_the_plain_tensors(case, ties):
    """The constants of ``step_structure(spec)``, which ``k2a_flops`` leaves
    out of the bound, are those of the plain version's step inputs."""
    spec, scen, primal, duals = iterate(case, 4, ties=ties)
    obs_k = al_sqp._stage_obstacles(spec, scen, primal.dt, N + 1)
    kkt = k2a.fused_kkt_system(spec, primal, scen, duals, obs_k)
    structure = k2a.step_structure(spec)
    for name, a in zip(KKT_NAMES, kkt):
        if name not in structure:
            continue
        want = k2a.structure_rows(structure[name])
        a = a.reshape(a.shape[:2] + (len(want), len(want[0])))
        for i, row in enumerate(want):
            for jj, c in enumerate(row):
                if c is not None:
                    assert bool((a[:, :, i, jj] == c).all()), (name, i, jj)


def _result(err_xs, converged, rho=None):
    """A one-stage SolveResult per lane whose xs carries ``err_xs``."""
    n = len(err_xs)
    z = lambda *s: torch.zeros((n,) + s, dtype=torch.float64)  # noqa: E731
    xs = z(2, 3)
    xs[:, 1, 0] = torch.tensor(err_xs, dtype=torch.float64)
    rho = z() + 1.0 if rho is None else torch.tensor(rho, dtype=torch.float64)
    return al_sqp.SolveResult(
        primal=Primal(xs=xs, us=z(1, 2), dt=z()),
        duals=al_sqp.DualState(z(1, 3), z(3), z(1, 0), z(1, 4), z(1, 4), z(2), z(1), rho),
        cost=z(), eq_norm=z(), ineq_viol=z(), converged=torch.tensor(converged),
    )


def _agreement(kernel, conv, tie, ulp, rho=None, rho_growth=5.0):
    """f64_agreement of a kernel result whose xs carries ``kernel`` against a
    plain one at zero, with one-ulp runs at ±``ulp`` and tie runs at
    ``tie`` (ρ of the kernel: ``rho``, the rest 1)."""
    n = len(kernel)
    plain = _result([0.0] * n, conv)
    outs_q = [_result(ulp, conv), _result([-e for e in ulp], conv)]
    outs_t = [_result(tie, conv), _result([0.0] * n, conv)]
    return agreement.f64_agreement(
        _result(kernel, conv, rho), plain, outs_q, outs_t, rho_growth, 0.0
    )[:2]


@pytest.mark.parametrize("tie", [False, True], ids=["no-tie", "tie-shown"])
def test_torch_f64_agreement_holds_untied_converged_lanes_to_1e_8(tie):
    """99.5% of the lanes both converged with no tie shown are within 1e-8,
    whatever their one-ulp sensitivity; a lane the tie runs move is held to
    its tie sensitivity instead and counted apart."""
    n = 10
    kernel = [0.0] * (n - 1) + [1e-7]  # one lane in ten beyond 1e-8
    ulp = [1e-13] * (n - 1) + [1e-8]  # within 100 times its own sensitivity
    tie_run = [0.0] * (n - 1) + [1e-7 if tie else 0.0]
    info, passed = _agreement(kernel, [True] * n, tie_run, ulp)
    assert passed is tie, info
    assert info["converged_tied"] == info["tied_beyond_rtol"] == int(tie)
    assert info["within_frac_converged"] == (1.0 if tie else 0.9)
    assert info["lanes_over_ulp_bound"] == 0


@pytest.mark.parametrize(
    "err, converged, passes",
    [(1e-6, True, True), (1e-4, True, False), (1e-6, False, True), (1e-4, False, False)],
    ids=["tied-within", "tied-beyond", "unconverged", "unconverged-beyond"],
)
def test_torch_f64_agreement_holds_tied_lanes_to_their_tie_sensitivity(err, converged, passes):
    """A lane whose plain answer moves by 1e-7 when its near-ties go the
    other way may differ by up to 100 times that, converged or not (a dt
    clipped within rounding of its bound ties anywhere in a solve); only a
    converged one is counted as tied."""
    info, passed = _agreement([0.0, err], [True, converged], [0.0, 1e-7], [1e-13, 1e-13])
    assert passed is passes, info
    assert info["lanes_over_ulp_bound"] == int(not passes)
    assert info["converged_tied"] == int(converged)


@pytest.mark.parametrize(
    "growths, tie, passes",
    [(1, True, True), (2, True, False), (1, False, False)],
    ids=["tied-one-growth", "tied-two-growths", "untied-one-growth"],
)
def test_torch_f64_agreement_lets_rho_of_a_tied_lane_differ_by_one_growth(growths, tie, passes):
    """ρ of a lane with a tie shown may differ by one growth factor (the
    growth test compared violations at the rounding of converged defects);
    by two, or on a lane with no tie shown, it may not."""
    info, passed = _agreement(
        [0.0, 0.0], [True, True], [0.0, 1e-9 if tie else 0.0], [1e-13, 1e-13],
        rho=[1.0, 5.0**growths],
    )
    assert passed is passes, info
    assert info["tied_rho_differs"] == int(tie)


def test_torch_tie_break_takes_near_ties_the_other_way():
    """``TieBreak`` picks the first or the last candidate within 1e-12
    (relative) of the least merit, never a non-finite one, and takes a
    growth test within 1e-13 of its bound as growth or as none."""
    inf = float("inf")
    merits = torch.tensor([
        [1.0, 5.0, inf],
        [1.0 + 1e-13, 4.0, inf],
        [2.0, 4.0 + 1e-11, inf],
        [3.0, 4.0 + 1e-12, 1e308],  # α = 0 last, its merit clamped finite
    ], dtype=torch.float64)
    first, last = agreement.tie_breaks()
    assert al_sqp.Decisions().pick(merits).tolist() == [0, 1, 3]
    assert first.pick(merits).tolist() == [0, 1, 3]
    assert last.pick(merits).tolist() == [1, 3, 3]
    viol = torch.tensor([1e-15, 1e-3, 5e-14, 2e-15], dtype=torch.float64)
    bound = torch.tensor([2e-15, 1e-4, inf, 1e-15], dtype=torch.float64)
    assert al_sqp.Decisions().stalled(viol, bound).tolist() == [False, True, False, True]
    assert first.stalled(viol, bound).tolist() == [True, True, False, True]
    assert last.stalled(viol, bound).tolist() == [False, True, False, False]
