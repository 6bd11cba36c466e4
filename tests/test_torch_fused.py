"""Kernel K2a's plain version (``ops/fused_al_sqp_cuda.py``) on the CPU.

- Its closed-form derivatives against the port's AD path (``torch.func``),
  in float64 at 1e-10 absolute: the forward-difference linearization against
  ``jacfwd`` of ``stage_defect``, and the whole set of Riccati inputs against
  ``al_sqp._kkt_system`` (``_make_stage_fns`` / ``_make_terminal_fns``) at
  random iterates and at an iterate with exact ties: a rate row, a box row
  and a dt-box row exactly active (t == 0 weighs ρ/4) and an obstacle row
  with μ + ρg exactly 0 (the crisp Gauss-Newton weight: 0).
- ``fused_solve_plain`` against JAX ``vmap(solve_single)``, K2's own
  reference in the JAX package, from identical inputs (the JAX
  ``random_ensemble`` through numpy, goals pulled in to 30% of their
  distance), at the warm settings
  of ``tests/test_fused_solver.py`` (2×3, 8 candidates, 1e-3 tolerances):
  in float32 with that file's tolerances (xs and us 5e-5, dt 5e-6, duals
  5e-3 absolute or 1e-3 relative, eq_norm and cost 1e-5, identical conv
  flags) on the lanes both converged, as ``tests/test_torch_al_sqp.py`` does
  (on the others f32 noise grows without bound, which is why the bench gate
  compares converged lanes only); in float64 on every lane at 1e-9. Both
  start from one warm state: the JAX result of a first 2×3 solve from the
  straight-line seed.
- Marked ``slow`` (not in the fast tier): ``fused_solve_plain`` against the
  Pallas kernel itself in interpret mode, at the same tolerances.
- The dispatch of ``make_solver``: CPU tensors, float64, budgets over 16
  iterations, ``fused="off"``, ``early_exit`` and out-of-scope specs take the
  un-fused path, bit for bit.
- The wrapper's checks, which run before any launch: it refuses CPU tensors,
  out-of-scope specs, wrong shapes, dtypes and non-contiguous inputs, and
  the fleet cycle's solves pass them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from mpc_local_planner_tpu.benchmarks import config3_carlike_min_time as j_config3
from mpc_local_planner_tpu.benchmarks import random_ensemble as j_random_ensemble
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.solvers import al_sqp as j_al

from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time as t_config3
from mpc_local_planner_tpu_torch.benchmarks import random_ensemble
from mpc_local_planner_tpu_torch.ocp.collocation import stage_defect
from mpc_local_planner_tpu_torch.ocp.grid import Primal, initial_primal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp
from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

B, N, M = 16, 8, 4
WARM = dict(
    n_al=2, n_sqp=3, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
    alphas=(1.0, 0.7, 0.5, 0.35, 0.22, 0.14, 0.08, 0.03),
)
KKT_NAMES = ("Fz", "Gz", "rz", "Hzz", "Hzu", "Huu", "hz", "hu", "PN", "pN")


def _np(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: _np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


# --------------------------------------------------------------------------- #
# closed forms against the AD path (float64)
# --------------------------------------------------------------------------- #
def _iterate(seed, ties=False, batch=6):
    """A float64 flagship iterate away from the seed, with obstacles placed on
    the trajectory (stage 3 and x_N) so that their rows are active."""
    spec = t_config3(N=N, obstacle_cap=M)
    st = al_sqp.SolverSettings(**WARM)
    scen = random_ensemble(
        spec, batch, torch.Generator().manual_seed(seed), dtype=torch.float64, device="cpu"
    )
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))  # noqa: E731
    init = initial_primal(spec, scen)
    xs = init.xs + T(0.05 * rng.normal(size=init.xs.shape))
    us = init.us + T(0.05 * rng.normal(size=init.us.shape))
    dt = init.dt * T(rng.uniform(0.8, 1.2, size=batch))
    obs = scen.obstacles
    circles = obs.circles.clone()
    circles[:, 0] = xs[:, 3, :2] + T(0.1 * rng.normal(size=(batch, 2)))
    circles[:, 1] = xs[:, N, :2] + T(0.1 * rng.normal(size=(batch, 2)))
    mask = obs.circle_mask.clone()
    mask[:, :2] = True
    scen = dataclasses.replace(
        scen, obstacles=dataclasses.replace(obs, circles=circles, circle_mask=mask)
    )
    duals = al_sqp.DualState(
        lam_def=T(rng.normal(size=(batch, N, 3))),
        lam_term=T(rng.normal(size=(batch, 3))),
        mu_obs=T(rng.uniform(0.0, 2.0, size=(batch, N, M))),
        mu_rate=T(rng.uniform(0.0, 1.0, size=(batch, N, 4))),
        mu_box=T(rng.uniform(0.0, 1.0, size=(batch, N, 4))),
        mu_dt=T(rng.uniform(0.0, 1.0, size=(batch, 2))),
        mu_ball=torch.zeros((batch, 1), dtype=torch.float64),
        rho=T(rng.uniform(50.0, 200.0, size=batch)),
    )
    if ties:
        # dt alternates 0.25 and dt_max (the terminal dt row exactly active)
        dt = torch.where(torch.arange(batch) % 2 == 0, 0.25, spec.dt_max).double()
        us[:, 2, 0] = 0.0
        us[:, 3, 0] = 0.5 * dt  # rate row 0 at stage 3: du − acc_lim·dt == 0
        us[:, 2, 1] = 1.0  # box row 1 at stage 2: u − max_steering == 0
        mu_rate, mu_box, mu_dt = duals.mu_rate.clone(), duals.mu_box.clone(), duals.mu_dt.clone()
        mu_rate[:, 3, 0] = 0.0
        mu_box[:, 2, 1] = 0.0
        mu_dt[:, 0] = 0.0
        # obstacle slot 0 at stage 4 (multiplier row 3): μ + ρg == 0 exactly
        g, _ = k2a.obstacle_rows(spec, xs[:, 4], scen.obstacles)
        mu_obs = duals.mu_obs.clone()
        mu_obs[:, 3, 0] = -(duals.rho * g[:, 0])
        duals = dataclasses.replace(
            duals, mu_rate=mu_rate, mu_box=mu_box, mu_dt=mu_dt, mu_obs=mu_obs
        )
    return spec, st, scen, Primal(xs=xs, us=us, dt=dt), duals


def test_torch_k2a_defect_linearization_matches_jacfwd():
    spec, _, _, primal, _ = _iterate(1)
    xk, uk, xk1 = primal.xs[:, :-1], primal.us, primal.xs[:, 1:]
    dt = primal.dt[:, None].expand(xk.shape[:2])
    c, F, G, m, r = k2a.defect_linearization(spec, xk, uk, xk1, dt)
    np.testing.assert_array_equal(r.numpy(), c.numpy())  # E = −I: r = c

    def defect(a, b, c1, d):
        return stage_defect(spec.model, spec.collocation, a, b, c1, d)

    flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
    jac = torch.vmap(jacfwd(defect, argnums=(0, 1, 2, 3)))(flat(xk), flat(uk), flat(xk1), flat(dt))
    A, Bm, E, h = (j.reshape(xk.shape[:2] + j.shape[1:]) for j in jac)
    np.testing.assert_array_equal(E.numpy(), -np.broadcast_to(np.eye(3), E.shape))
    torch.testing.assert_close(c, defect(xk, uk, xk1, dt), atol=1e-10, rtol=0)
    torch.testing.assert_close(F, A, atol=1e-10, rtol=0)
    torch.testing.assert_close(G, Bm, atol=1e-10, rtol=0)
    torch.testing.assert_close(m, h, atol=1e-10, rtol=0)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_torch_k2a_closed_forms_match_the_ad_path(ties):
    spec, _, scen, primal, duals = _iterate(2, ties=ties)
    obs_k = al_sqp._stage_obstacles(spec, scen, primal.dt, N + 1)
    ad = al_sqp._kkt_system(
        spec, al_sqp._make_stage_fns(spec), al_sqp._make_terminal_fns(spec),
        primal, scen, duals, obs_k,
    )
    cf = k2a.fused_kkt_system(spec, primal, scen, duals, obs_k)
    for name, a, b in zip(KKT_NAMES, cf, ad):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64, name
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0, msg=name)
    rho = duals.rho
    hzz, huu, pN_hess = cf[3], cf[5], cf[8]
    if ties:
        # exactly active rows weigh ρ/4: the rate row at stage 3 on du_prev
        # (Hzz[3, 3] collects it alone: the other comp-0 rate row is slack)
        # and the box row at stage 2 on u_1 (the rate rows of u_1 are
        # unbounded), the dt box on the terminal dt
        g_r = k2a.rate_g(spec, primal.us[:, 3], primal.us[:, 2], primal.dt)
        assert bool((g_r[:, 0] == 0).all())
        torch.testing.assert_close(hzz[:, 3, 3, 3], rho / 4, atol=1e-10, rtol=0)
        torch.testing.assert_close(huu[:, 2, 1, 1], rho / 4, atol=1e-10, rtol=0)
        at_max = primal.dt == spec.dt_max
        torch.testing.assert_close(pN_hess[at_max, 5, 5], rho[at_max] / 4, atol=1e-10, rtol=0)
        # μ + ρg == 0 on the obstacle row: Gauss-Newton weight 0, not ρ/4;
        # the other active rows at stage 4 are those of the random slots
        g, _ = k2a.obstacle_rows(spec, primal.xs[:, 4], scen.obstacles)
        assert bool((duals.mu_obs[:, 3, 0] + rho * g[:, 0] == 0).all())
    else:
        # the fixture exercises active obstacle blocks at a stage and at x_N
        assert bool((hzz[:, 3, 0, 0] > 0).any()) and bool((pN_hess[:, 0, 0] > rho).any())


def test_torch_k2a_hinge_weight_is_crisp_only_for_obstacles():
    t = torch.tensor([-1.0, 0.0, 2.0], dtype=torch.float64)
    np.testing.assert_array_equal(k2a.hinge_w(t, 8.0).numpy(), [0.0, 2.0, 8.0])


# --------------------------------------------------------------------------- #
# fused_solve_plain against JAX vmap(solve_single)
# --------------------------------------------------------------------------- #
def _jax_inputs(jdtype):
    """A warm state: the JAX solve's result after one 2×3 solve from the
    straight-line seed (which converges no lane at this budget)."""
    jspec = j_config3(N=N, obstacle_cap=M)
    scen = j_random_ensemble(jspec, B, jax.random.PRNGKey(3), dtype=jdtype)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.3 * (scen.xf - scen.x0))
    init = j_initial_primal(jspec, scen)
    jst = j_al.SolverSettings(**WARM)
    duals = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), j_al.init_duals(jspec, jst, jdtype)
    )
    solve = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, jst, s, i, d)))
    first = solve(scen, init, duals)
    return solve, scen, first.primal, first.duals


def _to_torch(scen, init, duals):
    return (
        convert.from_numpy(Scenario, _np(scen), "cpu"),
        convert.from_numpy(Primal, _np(init), "cpu"),
        convert.from_numpy(al_sqp.DualState, _np(duals), "cpu"),
    )


@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.float64], ids=["f32", "f64"])
def test_torch_k2a_plain_matches_jax_solve_single(jdtype):
    solve, scen, init, duals = _jax_inputs(jdtype)
    j = _np(solve(scen, init, duals))
    before = riccati_cuda.lqr_solve_cuda.launches
    out = k2a.fused_solve_plain(
        t_config3(N=N, obstacle_cap=M), al_sqp.SolverSettings(**WARM), *_to_torch(scen, init, duals)
    )
    assert riccati_cuda.lqr_solve_cuda.launches == before  # the plain lqr_solve
    t = convert.to_numpy(out)
    assert t["primal"]["xs"].dtype == np.dtype(jdtype)
    np.testing.assert_array_equal(t["converged"], j["converged"])
    assert 0 < j["converged"].sum() < B  # both outcomes are exercised
    if jdtype == jnp.float64:  # every lane
        lanes = np.ones(B, dtype=bool)
        tol = dict(xs=1e-9, us=1e-9, dt=1e-9, duals=1e-9, rel=0.0, norms=1e-9)
    else:  # the lanes both converged: elsewhere f32 noise grows unbounded
        lanes = t["converged"] & j["converged"]
        tol = dict(xs=5e-5, us=5e-5, dt=5e-6, duals=5e-3, rel=1e-3, norms=1e-5)
    for k in ("xs", "us", "dt"):
        np.testing.assert_allclose(
            t["primal"][k][lanes], j["primal"][k][lanes], atol=tol[k], rtol=0, err_msg=k
        )
    for k in ("cost", "eq_norm"):
        np.testing.assert_allclose(t[k][lanes], j[k][lanes], atol=tol["norms"], rtol=0, err_msg=k)
    for k in j["duals"]:
        a, b = t["duals"][k][lanes], j["duals"][k][lanes]
        assert np.all(np.abs(a - b) <= np.maximum(tol["duals"], tol["rel"] * np.abs(b))), k


# --------------------------------------------------------------------------- #
# dispatch and the wrapper's checks
# --------------------------------------------------------------------------- #
def _small(batch=4, dtype=torch.float32):
    spec = t_config3(N=N, obstacle_cap=M)
    st = al_sqp.SolverSettings(**WARM)
    scen = random_ensemble(spec, batch, torch.Generator().manual_seed(0), dtype=dtype, device="cpu")
    init, duals = al_sqp.default_init(spec, st, scen, dtype=dtype)
    return spec, st, scen, init, duals


@pytest.mark.parametrize(
    "case, admitted",
    [
        ("warm-cuda", True),
        ("rescue-cuda", True),
        ("cpu", False),
        ("float64", False),
        ("cold-budget", False),
        ("fused-off", False),
        ("early-exit", False),
        ("terminal-ball", True),
        ("17-candidates", True),
        ("17-obstacle-slots", True),
        ("line-slots", True),
        ("17-polygon-vertices", False),
    ],
)
def test_torch_fused_dispatch_ok(case, admitted):
    spec, st, scen, _, _ = _small()
    dtype, device = torch.float32, "cuda"
    if case == "rescue-cuda":
        st = dataclasses.replace(st, n_al=4, n_sqp=4)
    elif case == "cpu":
        device = "cpu"
    elif case == "float64":
        dtype = torch.float64
    elif case == "cold-budget":
        st = al_sqp.SolverSettings.for_spec(spec)
    elif case == "fused-off":
        st = dataclasses.replace(st, fused="off")
    elif case == "early-exit":
        st = dataclasses.replace(st, early_exit=True)
    elif case == "terminal-ball":
        spec = dataclasses.replace(spec, ball_radius=0.5)
    elif case == "17-candidates":
        st = dataclasses.replace(st, alphas=tuple(0.9**i for i in range(17)))
    elif case == "17-obstacle-slots":
        spec = dataclasses.replace(spec, obstacle_cap=17)
    elif case == "line-slots":
        lines = torch.zeros(scen.x0.shape[:1] + (1, 2, 2))
        scen = dataclasses.replace(
            scen, obstacles=dataclasses.replace(scen.obstacles, lines=lines)
        )
    elif case == "17-polygon-vertices":
        polygons = torch.zeros(scen.x0.shape[:1] + (1, 17, 2))
        scen = dataclasses.replace(
            scen, obstacles=dataclasses.replace(scen.obstacles, polygons=polygons)
        )
    assert al_sqp.fused_dispatch_ok(spec, st, scen, dtype, device) is admitted


@pytest.mark.parametrize(
    "family, dtype, want",
    [
        ("flagship", torch.float32, (False, 1, 0, False, 0)),
        ("flagship", torch.float64, (True, 1, 0, False, 0)),
        ("via_points", torch.float32, (False, 1, 2, False, 0)),
        ("nonuniform", torch.float64, (True, 1, 0, True, 0)),
        ("config2", torch.float32, (False, 0, 1, False, 0)),
    ],
)
def test_torch_k2a_library_group_of_a_spec(family, dtype, want):
    """A launch's library holds the five instantiations of its working type,
    model, objective family, grid and collocation family (forward
    differences here); the 96 groups have 96 names, and each group's
    macros give the number its library reports (``k2a_group``)."""
    from mpc_local_planner_tpu_torch.benchmarks import config2_diffdrive_obstacles, family_spec

    spec = config2_diffdrive_obstacles(N=8) if family == "config2" else family_spec(family, N=8)
    g = k2a.group(spec, dtype)
    assert g == k2a.Group(*want) and g in k2a.GROUPS
    assert len(set(k2a.GROUPS)) == 96 and len({k2a.library_path(h) for h in k2a.GROUPS}) == 96
    macros = {k: int(v) for k, v in (d.split("=") for d in g.defines())}
    assert (((macros["K2A_DOUBLE"] * 10 + macros["K2A_MODEL"]) * 10 + macros["K2A_OBJ"]) * 10
            + macros["K2A_NONU"]) * 10 + macros["K2A_COLLOC"] == g.code()
    code = "(((K2A_DOUBLE * 10 + K2A_MODEL) * 10 + K2A_OBJ) * 10 + K2A_NONU) * 10 + K2A_COLLOC"
    assert code in k2a.SOURCE.read_text()
    no_via = dataclasses.replace(spec, via_cap=0)
    assert k2a.group(no_via, dtype).obj == (1 if family == "config2" else 0)


def test_torch_make_solver_on_cpu_is_the_unfused_solve_bit_for_bit():
    spec, st, scen, init, duals = _small()
    before = k2a.fused_solve_cuda.launches
    by_rule = dict(k2a.fused_solve_cuda.launches_by_rule)
    auto = al_sqp.make_solver(spec, st, device="cpu")(scen, init, duals)
    off = al_sqp.solve(spec, dataclasses.replace(st, fused="off"), scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before
    assert k2a.fused_solve_cuda.launches_by_rule == by_rule
    for a, b in zip(_leaves(auto), _leaves(off)):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]


def test_torch_k2a_wrapper_refuses_what_the_kernel_does_not_take():
    spec, st, scen, init, duals = _small()
    with pytest.raises(ValueError, match="CUDA"):
        k2a.fused_solve_cuda(spec, st, scen, init, duals)
    wide = dataclasses.replace(spec, via_cap=9)
    with pytest.raises(NotImplementedError, match="via_cap=9"):
        k2a.fused_solve_cuda(wide, st, scen, init, duals)
    with pytest.raises(NotImplementedError, match="via_cap=9"):
        k2a.fused_solve_plain(wide, st, scen, init, duals)
    strided = dataclasses.replace(init, xs=init.xs.mT.contiguous().mT)
    with pytest.raises(ValueError, match="xs is not contiguous"):
        k2a.kernel_io(spec, scen, strided, duals)
    short = dataclasses.replace(duals, mu_obs=duals.mu_obs[:, :, :2])
    with pytest.raises(ValueError, match="mu_obs has shape"):
        k2a.kernel_io(spec, scen, init, short)
    mixed = dataclasses.replace(duals, rho=duals.rho.double())
    with pytest.raises(TypeError, match="rho is torch.float64"):
        k2a.kernel_io(spec, scen, init, mixed)
    with pytest.raises(TypeError, match="float32 or float64"):
        k2a.kernel_io(spec, scen, dataclasses.replace(init, xs=init.xs.half()), duals)
    ins, outs = k2a.kernel_io(spec, scen, init, duals)
    assert len(ins) == 26 and len(outs) == 15 and outs[-1].dtype == torch.bool


def test_torch_fleet_cycle_solves_pass_the_kernel_checks(monkeypatch):
    """Every batched solve of a fleet cycle with rescue hands the kernel
    inputs it takes (contiguous, expected shapes), so the CUDA path cannot
    refuse them on the card."""
    spec, st, scen, init, duals = _small(batch=6)
    seen = []
    unfused = al_sqp.solve

    def checked(spec_, settings, scenario, i, d, kkt_system=None):
        k2a.kernel_io(spec_, scenario, i, d)
        seen.append(i.xs.shape[0])
        return unfused(spec_, settings, scenario, i, d, kkt_system)

    monkeypatch.setattr(al_sqp, "solve", checked)
    rescue = make_rescue(spec, st, 3, device="cpu")
    cycle = make_fleet_cycle(spec, st, duals, rescue=rescue, device="cpu")
    r = al_sqp.make_solver(spec, st, device="cpu")(scen, init, duals)
    for _ in range(2):
        scen, r = cycle(scen, r)
    assert seen == [6, 6, 3, 6, 3]


def test_torch_k2a_flops_count_the_schedule():
    from mpc_local_planner_tpu_torch.benchmarks import config2_diffdrive_obstacles

    flagship = t_config3(N=30, obstacle_cap=8)
    one = k2a.k2a_flops(flagship, 1, 1, 3)
    assert k2a.k2a_flops(flagship, 3, 4, 3) > 11 * one
    assert k2a.k2a_flops(flagship, 3, 4, 3) == 788_378  # the count PERF.md's bound uses
    assert k2a.k2a_flops(flagship, 4, 4, 8) > k2a.k2a_flops(flagship, 4, 4, 3)
    # the structured step against the dense 6x6 algebra the kernel runs
    # (1895 operations per stage for the step, 134 for the rollout's products)
    riccati, rollout = k2a.step_flops(k2a.step_structure(flagship))
    assert riccati < 1895 // 3 and rollout < 134 // 2
    # config #2: the fixed dt drops the step's dt column and the dt rows; the
    # quadratic form, Qf and the ball add their terms
    c2 = config2_diffdrive_obstacles(N=30, obstacle_cap=10)
    riccati2, rollout2 = k2a.step_flops(k2a.step_structure(c2))
    assert riccati2 < riccati and rollout2 < rollout
    no_extras = dataclasses.replace(c2, qf_diag=None, ball_radius=0.0)
    assert k2a.k2a_flops(c2, 3, 4, 3) > k2a.k2a_flops(no_extras, 3, 4, 3)
    assert k2a.k2a_flops(dataclasses.replace(c2, integral_form=True), 3, 4, 3) > k2a.k2a_flops(
        c2, 3, 4, 3)
    assert 5.0e5 < k2a.k2a_flops(c2, 3, 4, 3) < 1.0e6


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_torch_k2a_step_structure_matches_the_plain_tensors(ties):
    """The constants of ``step_structure``, which ``k2a_flops`` leaves out
    of the bound, are those of the plain version's step inputs."""
    spec, _, scen, primal, duals = _iterate(4, ties=ties)
    obs_k = al_sqp._stage_obstacles(spec, scen, primal.dt, N + 1)
    kkt = k2a.fused_kkt_system(spec, primal, scen, duals, obs_k)
    structure = k2a.step_structure(spec)
    for name, a in zip(KKT_NAMES, kkt):
        if name not in structure:
            continue
        want = k2a.structure_rows(structure[name])
        a = a.reshape(a.shape[:2] + (len(want), len(want[0])))
        for i, row in enumerate(want):
            for j, c in enumerate(row):
                if c is not None:
                    assert bool((a[:, :, i, j] == c).all()), (name, i, j)


@functools.lru_cache(maxsize=1)
def _plain_f64_results():
    """The plain version in float64 from the straight-line seed (no lane
    converges at this budget), from its states moved by one ulp, with one
    ulp on its KKT inputs and with its near-ties taken the other way."""
    spec, st, scen, init, duals = _small(batch=8, dtype=torch.float64)
    plain = functools.partial(k2a.fused_solve_plain, spec, st, scen, duals=duals)
    out_p = plain(init)
    outs_q, outs_r, outs_t = agreement.plain_runs(lambda i, **kw: plain(init=i, **kw), init)
    return out_p, outs_q, outs_r, outs_t, st.rho_growth


def _corrupt(r, case):
    """A copy of ``r`` with one lane changed as a faulty kernel would."""
    r = al_sqp.tree_map(torch.clone, r)
    if case == "wrong-dual":
        r.duals.mu_rate[2] *= 1.0 + 1e-6
    elif case == "wrong-snapshot":
        r.primal.xs[5, 3:] = r.primal.xs[5, 2]
    elif case == "flipped-conv":
        r.converged[1] = ~r.converged[1]
    return r


@pytest.mark.parametrize("case", ["same", "wrong-dual", "wrong-snapshot", "flipped-conv"])
def test_torch_f64_agreement_holds_every_lane_to_rounding(case):
    """``agreement.f64_agreement`` passes two versions that differ by
    rounding and catches a fault confined to one unconverged lane."""
    out_p, outs_q, outs_r, outs_t, growth = _plain_f64_results()
    assert not bool(out_p.converged.any())
    _, _, _, sens = agreement.f64_agreement(out_p, out_p, outs_q, outs_t, growth, 0.0,
                                            outs_r=outs_r)
    assert float(sens.max()) < 1e-9  # the check is tight on every lane
    info, passed, _, _ = agreement.f64_agreement(
        _corrupt(outs_q[0], case), out_p, outs_q, outs_t, growth, 0.0, every_lane=True,
        outs_r=outs_r,
    )
    assert passed is (case == "same"), info
    if case in ("wrong-dual", "wrong-snapshot"):
        assert info["lanes_over_ulp_bound"] == 1


def _moved(r, lane, rel):
    """A copy of ``r`` with one state of ``lane`` moved by ``rel`` relative."""
    r = al_sqp.tree_map(torch.clone, r)
    r.primal.xs[lane, 4, 0] += rel * max(abs(float(r.primal.xs[lane, 4, 0])), 1.0)
    return r


def test_torch_tie_breaks_clip_a_dt_near_its_bound_either_way():
    """A candidate's dt within rounding of a bound it is not on goes onto the
    bound (``first``) or one ulp inside it (``last``); a dt on its bound or
    clearly inside or beyond is clipped as the solver clips it, and a fixed
    dt (lo == hi) has no tie."""
    lo, hi = 1e-3, 0.5
    up = lambda v, n: float(np.nextafter(np.float64(v), np.inf) if n == 1 else  # noqa: E731
                            v + n * np.spacing(np.float64(v)))
    dt = torch.tensor([up(lo, 4), lo - 3 * np.spacing(lo), lo, lo + 1e-6, 0.2,
                       hi - 2 * np.spacing(hi), hi + 1e-3], dtype=torch.float64)
    first, last = agreement.tie_breaks()
    exact = al_sqp.Decisions().clip_dt(dt, lo, hi)
    assert torch.equal(exact, torch.clamp(dt, lo, hi))
    want_first = torch.tensor([lo, lo, lo, lo + 1e-6, 0.2, hi, hi], dtype=torch.float64)
    want_last = torch.tensor([up(lo, 4), up(lo, 1), lo, lo + 1e-6, 0.2,
                              hi - 2 * np.spacing(hi), hi], dtype=torch.float64)
    assert torch.equal(first.clip_dt(dt, lo, hi), want_first)
    assert torch.equal(last.clip_dt(dt, lo, hi), want_last)
    for rule in (first, last):
        assert torch.equal(rule.clip_dt(dt, 0.3, 0.3), torch.full_like(dt, 0.3))


@pytest.mark.parametrize("rel, tie, held", [(5e-2, 1e-3, True), (0.5, 1e-3, False),
                                            (5e-2, 0.0, False)])
def test_torch_f64_agreement_holds_an_unconverged_lane_to_its_tie(rel, tie, held):
    """A lane that the tie runs move has a tie shown whether or not it
    converged: it is held to 100 times the larger of its one-ulp and tie
    sensitivities; without the tie the same error fails it."""
    out_p, outs_q, outs_r, outs_t, growth = _plain_f64_results()
    assert not bool(out_p.converged.any())
    if tie:
        outs_t = [_moved(outs_t[0], 3, tie)] + list(outs_t[1:])
    info, passed, _, _ = agreement.f64_agreement(
        _moved(out_p, 3, rel), out_p, outs_q, outs_t, growth, 0.0, outs_r=outs_r)
    assert passed is held, info
    assert info["converged_tied"] == 0


@pytest.mark.parametrize("every_lane", [True, False])
def test_torch_f64_agreement_holds_an_ill_conditioned_lane_at_the_first_prefix(every_lane):
    """A lane whose one-ulp sensitivity passes CHAOTIC (here 1e-5, from a
    KKT-rounding run) is left out of the check at a long prefix, and at the
    first one (``every_lane``) held to 100 times that sensitivity but no
    more than EVERY_LANE_CAP (1e-4)."""
    out_p, outs_q, outs_r, outs_t, growth = _plain_f64_results()
    outs_r = [_moved(outs_r[0], 3, 1e-5)] + list(outs_r[1:])
    assert agreement.EVERY_LANE_CAP == 1e-4
    for rel, held in ((5e-5, True), (5e-4, not every_lane), (1e-2, not every_lane)):
        info, passed, _, _ = agreement.f64_agreement(
            _moved(out_p, 3, rel), out_p, outs_q, outs_t, growth, 0.0, every_lane=every_lane,
            outs_r=outs_r,
        )
        assert info["lanes_chaotic"] == 1
        assert passed is held, info


@pytest.mark.parametrize("every_lane", [True, False])
def test_torch_f64_agreement_holds_a_chaotic_lane_to_its_measured_spread(every_lane):
    """A lane that one ulp moves by 2e-2 (path C's lane 58 after one SQP
    iteration, an ill-conditioned Riccati step times ρ in ``lam_def``) is
    held at the first prefix to SPREAD_FACTOR (2) times its largest move
    under the KKT-rounding patterns, ``spread_runs`` included (here 5e-2),
    not to EVERY_LANE_CAP, and left out at a long prefix; without the
    spread runs, to twice its one-ulp sensitivity."""
    out_p, outs_q, outs_r, outs_t, growth = _plain_f64_results()
    outs_r = [_moved(outs_r[0], 3, 2e-2)] + list(outs_r[1:])
    outs_s = [_moved(outs_r[1], 3, 5e-2)]
    assert (agreement.SPREAD_FACTOR, agreement.SPREAD_PATTERNS) == (2.0, 32)
    for rel, spread, held in ((1.9e-2, outs_s, True), (9e-2, outs_s, True),
                              (1.2e-1, outs_s, not every_lane), (3.5e-2, (), True),
                              (5e-2, (), not every_lane)):
        info, passed, _, _ = agreement.f64_agreement(
            _moved(out_p, 3, rel), out_p, outs_q, outs_t, growth, 0.0, every_lane=every_lane,
            outs_r=outs_r, outs_spread=spread,
        )
        assert info["lanes_chaotic"] == 1
        assert passed is held, info


@pytest.mark.slow
def test_torch_k2a_plain_matches_the_pallas_kernel_in_interpret_mode():
    """``fused_solve_plain`` against the TPU kernel itself (JAX ``fused_solve``
    in Pallas interpret mode) on the inputs of ``tests/test_fused_solver.py``:
    a 2×3 solve from the straight-line seed, float32, that file's
    tolerances on every lane."""
    from mpc_local_planner_tpu.ops.fused_al_sqp_pallas import fused_solve

    jspec = j_config3(N=N, obstacle_cap=M)
    scen = j_random_ensemble(jspec, B, jax.random.PRNGKey(0), dtype=jnp.float32)
    init = j_initial_primal(jspec, scen)
    jst = j_al.SolverSettings(**WARM)
    duals = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), j_al.init_duals(jspec, jst, jnp.float32)
    )
    j = _np(fused_solve(jspec, jst, scen, init, duals, interpret=True))
    t = convert.to_numpy(k2a.fused_solve_plain(
        t_config3(N=N, obstacle_cap=M), al_sqp.SolverSettings(**WARM), *_to_torch(scen, init, duals)
    ))
    np.testing.assert_array_equal(t["converged"], j["converged"])
    for k, atol in (("xs", 5e-5), ("us", 5e-5), ("dt", 5e-6)):
        np.testing.assert_allclose(t["primal"][k], j["primal"][k], atol=atol, rtol=0, err_msg=k)
    for k in ("cost", "eq_norm"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-5, rtol=0, err_msg=k)
    for k in ("lam_def", "lam_term", "mu_obs", "mu_rate", "mu_box", "mu_dt", "rho"):
        np.testing.assert_allclose(t["duals"][k], j["duals"][k], atol=5e-3, rtol=1e-3, err_msg=k)
