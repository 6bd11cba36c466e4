"""The midpoint and Crank–Nicolson rules and the shooting grids (ROADMAP
M9c, M9d; the fused kernel's K2b and K2e branches) on the CPU, piece by
piece against the JAX package, from identical float64 inputs made with
numpy:

- ``stage_defect`` and ``collocation_defects`` for every rule and a spread
  of shooting names, on a shared dt and on a per-stage dt, with θ near ±π
  (the wrap inside the midpoint and the defect's own), at 1e-12;
- the kernel's SE(2) midpoint against ``se2_interpolate`` (the same
  function, rounded the kernel's way) where the inner wrap switches;
- the kernel's closed forms: ``defect_linearization``'s (c, F, G, m, r)
  against the AD path's (c, −E⁻¹A, −E⁻¹B, −E⁻¹h, −E⁻¹c) for every model and
  rule, and the whole ``fused_kkt_system`` against ``al_sqp._kkt_system``
  on the flagship, config #2 and the non-uniform grid, at 1e-10;
- ``step_structure`` against the plain version's tensors, the operation
  count per stage, the scope at its edges (JAX ``fused_supported``), the
  spec's admission (JAX ``OcpSpec``), the kernel's parameters and library
  group per rule, and float32 kept by the AD path;
- the f64 rule's second measurement of a lane over its bound
  (``agreement.lane_spread``), which the Crank–Nicolson flagship's check
  on the card needed.

``tests/test_torch_collocation_solves.py`` runs whole solves and the
Crank–Nicolson flagship's fleet cycle.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp import collocation as j_col
from mpc_local_planner_tpu.ops.fused_al_sqp_pallas import fused_supported as j_fused_supported
from mpc_local_planner_tpu.systems import models as jm

from test_torch_quadratic import KKT_NAMES
from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch.core.so2 import se2_interpolate
from mpc_local_planner_tpu_torch.ocp import collocation as t_col
from mpc_local_planner_tpu_torch.ocp.grid import Primal, initial_primal
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.ops.smallmat import inv3
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp
from mpc_local_planner_tpu_torch.systems import models as tm

B, N, M = 5, 8, 4
RULES = ("forward_differences", "midpoint_differences", "crank_nicolson_differences")
SHOOTING = ("shooting_explicit_euler", "shooting_rk2_midpoint", "shooting_rk2_heun_3",
            "shooting_rk3_2", "shooting_rk4", "shooting_rk5_4", "shooting_rk6",
            "shooting_rk7_2")
MODEL_PAIRS = {
    "unicycle": (jm.UnicycleModel(), tm.UnicycleModel()),
    "simple_car": (jm.SimpleCarModel(wheelbase=0.5), tm.SimpleCarModel(wheelbase=0.5)),
    "front_wheel": (jm.SimpleCarFrontWheelDrivingModel(wheelbase=0.7),
                    tm.SimpleCarFrontWheelDrivingModel(wheelbase=0.7)),
    "bicycle": (jm.KinematicBicycleModelVelocityInput(lf=0.3, lr=0.2),
                tm.KinematicBicycleModelVelocityInput(lf=0.3, lr=0.2)),
}


def _trajectory(seed=0, per_stage=False):
    """Float64 states, controls and dt (numpy) with θ near ±π: every other
    lane's θ_k sits just below π and θ_{k+1} just above −π, so the
    difference, the midpoint's inner wrap and the defect all wrap."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, N + 1, 3))
    xs[::2, :, 2] = np.where(np.arange(N + 1) % 2 == 0, np.pi - 0.01, -np.pi + 0.02)
    us = rng.uniform(-0.4, 0.4, size=(B, N, 2))
    dt = rng.uniform(0.1, 0.45, size=(B, N) if per_stage else (B,))
    return xs, us, dt


# --------------------------------------------------------------------------- #
# the defects against JAX
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("per_stage", [False, True], ids=["shared-dt", "per-stage-dt"])
@pytest.mark.parametrize("rule", RULES + SHOOTING)
def test_torch_collocation_defects_match_jax(rule, per_stage):
    jmodel, tmodel = MODEL_PAIRS["simple_car"]
    xs, us, dt = _trajectory(per_stage=per_stage)
    want = np.asarray(j_col.collocation_defects(jmodel, rule, jnp.asarray(xs), jnp.asarray(us),
                                                jnp.asarray(dt)))
    T = torch.from_numpy
    got = t_col.collocation_defects(tmodel, rule, T(xs), T(us), T(dt))
    assert got.shape == (B, N, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    # one stage at a time, dt of the stage's batch shape
    dtk = dt if per_stage else np.broadcast_to(dt[:, None], (B, N))
    for k in (0, N - 1):
        a = (xs[:, k], us[:, k], xs[:, k + 1], dtk[:, k])
        want_k = np.asarray(j_col.stage_defect(jmodel, rule, *(jnp.asarray(v) for v in a)))
        got_k = t_col.stage_defect(tmodel, rule, *(T(np.array(v)) for v in a))
        np.testing.assert_allclose(got_k.numpy(), want_k, atol=1e-12, rtol=0)
        np.testing.assert_allclose(got_k.numpy(), want[:, k], atol=1e-12, rtol=0)


def test_torch_collocation_refuses_unknown_names_as_jax_does():
    jmodel, tmodel = MODEL_PAIRS["unicycle"]
    xs, us, dt = _trajectory()
    T = torch.from_numpy
    with pytest.raises(KeyError):
        j_col.collocation_defects(jmodel, "backward_differences", xs, us, dt)
    with pytest.raises(KeyError):
        t_col.collocation_defects(tmodel, "backward_differences", T(xs), T(us), T(dt))
    with pytest.raises(ValueError, match="unknown integrator 'rk9'"):
        t_col.collocation_defects(tmodel, "shooting_rk9", T(xs), T(us), T(dt))
    assert t_col._parse_shooting("shooting_rk2_heun_3") == ("rk2_heun", 3)
    assert t_col._parse_shooting("shooting_rk2_heun") == j_col._parse_shooting("shooting_rk2_heun")


def test_torch_kernel_midpoint_is_se2_interpolate_near_pi():
    """The kernel's midpoint ((x_k + x_{k+1})/2, wrap(θ_k + ½ wrap(θ_{k+1}
    − θ_k))) is ``se2_interpolate`` at ½ to rounding, across the inner
    wrap's switch (θ_{k+1} − θ_k at ±π) and the outer one."""
    th = np.array([np.pi - 1e-3, -np.pi + 1e-3, 3.0, -3.0, 1.0, np.pi - 1e-9])
    th1 = np.array([-np.pi + 1e-3, np.pi - 1e-3, -3.0, 3.0, 1.0 + np.pi - 1e-9, -np.pi + 1e-9])
    rng = np.random.default_rng(4)
    xk = np.column_stack([rng.normal(size=6), rng.normal(size=6), th])
    xk1 = np.column_stack([rng.normal(size=6), rng.normal(size=6), th1])
    a = k2a.kernel_midpoint(torch.from_numpy(xk), torch.from_numpy(xk1))
    b = se2_interpolate(torch.from_numpy(xk), torch.from_numpy(xk1), 0.5)
    d = (a - b).numpy()
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi  # the same angle either side of ±π
    np.testing.assert_allclose(d, 0.0, atol=1e-15)
    # the midpoints lie across ±π but where the difference sits at the switch
    assert np.all(np.abs(a[[0, 1, 2, 3, 5], 2].numpy()) > 3.0)


# --------------------------------------------------------------------------- #
# the kernel's closed forms against the AD path
# --------------------------------------------------------------------------- #
def _ad_linearization(spec, xk, uk, xk1, dt):
    """The AD path's (c, −E⁻¹A, −E⁻¹B, −E⁻¹h, −E⁻¹c) of ``stage_defect``."""
    def defect(a, b, c, d):
        return t_col.stage_defect(spec.model, spec.collocation, a, b, c, d)

    flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
    jac = torch.vmap(jacfwd(defect, argnums=(0, 1, 2, 3)))(flat(xk), flat(uk), flat(xk1),
                                                          flat(dt))
    A, Bm, E, h = (j.reshape(xk.shape[:2] + j.shape[1:]) for j in jac)
    c = defect(xk, uk, xk1, dt)
    Ei = inv3(E)
    mv = lambda Mx, v: torch.einsum("...ij,...j->...i", Mx, v)  # noqa: E731
    return c, -Ei @ A, -Ei @ Bm, -mv(Ei, h), -mv(Ei, c)


@pytest.mark.parametrize("rule", RULES + SHOOTING)
@pytest.mark.parametrize("model", sorted(MODEL_PAIRS))
def test_torch_defect_linearization_matches_the_ad_path(model, rule):
    spec = dataclasses.replace(tb.config3_carlike_min_time(N=N, obstacle_cap=M),
                               model=MODEL_PAIRS[model][1], collocation=rule)
    xs, us, dt = (torch.from_numpy(a) for a in _trajectory(seed=7, per_stage=True))
    xk, xk1 = xs[:, :-1], xs[:, 1:]
    got = k2a.defect_linearization(spec, xk, us, xk1, dt)
    want = _ad_linearization(spec, xk, us, xk1, dt)
    for name, a, b in zip(("c", "F", "G", "m", "r"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float64, name
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0, msg=name)
    # the merit's and the dual update's defect is the linearization's c
    torch.testing.assert_close(k2a.defect_value(spec, xk, us, xk1, dt), got[0], atol=0, rtol=0)
    if rule == "forward_differences" or rule.startswith("shooting_"):
        assert torch.equal(got[4], got[0])  # E = −I: r = c
    else:
        assert not torch.equal(got[4], got[0])  # the fold: r = −E⁻¹c


def _spec(case, rule):
    if case == "flagship":
        spec = tb.config3_carlike_min_time(N=N, obstacle_cap=M)
    elif case == "config2":
        spec = tb.config2_diffdrive_obstacles(N=N, obstacle_cap=M)
    else:
        spec = dataclasses.replace(tb.family_spec("nonuniform", N=N), obstacle_cap=M)
    return dataclasses.replace(spec, collocation=rule)


def iterate(spec, seed):
    """A float64 iterate of ``spec`` away from the seed (x_N off the goal),
    obstacles on the trajectory (stage 3 and x_N), random duals."""
    scen = tb.random_ensemble(spec, B, torch.Generator().manual_seed(seed), dtype=torch.float64,
                              device="cpu")
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))  # noqa: E731
    init = initial_primal(spec, scen)
    xs = init.xs + T(0.05 * rng.normal(size=init.xs.shape))
    us = init.us + T(0.05 * rng.normal(size=init.us.shape))
    dt = init.dt * T(rng.uniform(0.7, 1.3, size=init.dt.shape))
    xs[:, N, :2] += T(0.3 * rng.normal(size=(B, 2)))
    obs = scen.obstacles
    circles, mask = obs.circles.clone(), obs.circle_mask.clone()
    circles[:, 0] = xs[:, 3, :2] + T(0.1 * rng.normal(size=(B, 2)))
    circles[:, 1] = xs[:, N, :2] + T(0.1 * rng.normal(size=(B, 2)))
    mask[:, :2] = True
    scen = dataclasses.replace(scen, obstacles=dataclasses.replace(obs, circles=circles,
                                                                   circle_mask=mask))
    md = 2 * N if spec.nonuniform_dt else 2
    duals = al_sqp.DualState(
        lam_def=T(rng.normal(size=(B, N, 3))), lam_term=T(rng.normal(size=(B, 3))),
        mu_obs=T(rng.uniform(0.0, 2.0, size=(B, N, M))),
        mu_rate=T(rng.uniform(0.0, 1.0, size=(B, N, 4))),
        mu_box=T(rng.uniform(0.0, 1.0, size=(B, N, 4))),
        mu_dt=T(rng.uniform(0.0, 1.0, size=(B, md))),
        mu_ball=T(rng.uniform(0.0, 3.0, size=(B, 1))),
        rho=T(rng.uniform(50.0, 200.0, size=B)),
    )
    return scen, Primal(xs=xs, us=us, dt=dt), duals


def ad_and_closed_forms(spec, scen, primal, duals):
    obs_k = al_sqp._stage_obstacles(spec, scen, primal.dt, N + 1)
    ad = al_sqp._kkt_system(spec, al_sqp._make_stage_fns(spec), al_sqp._make_terminal_fns(spec),
                            primal, scen, duals, obs_k, 0.7)
    return ad, k2a.fused_kkt_system(spec, primal, scen, duals, obs_k, 0.7)


KKT_RULES = ("midpoint_differences", "crank_nicolson_differences", "shooting_rk4",
             "shooting_rk2_heun_3")


@pytest.mark.parametrize("rule", KKT_RULES)
@pytest.mark.parametrize("case", ["flagship", "config2", "nonuniform"])
def test_torch_collocation_closed_forms_match_the_ad_path(case, rule):
    """The whole KKT of one SQP iteration: the transition folded (r =
    −E⁻¹c in rz), the rest as under forward differences; and the constants
    of ``step_structure`` are those of these tensors."""
    spec = _spec(case, rule)
    scen, primal, duals = iterate(spec, 2)
    ad, cf = ad_and_closed_forms(spec, scen, primal, duals)
    for name, a, b in zip(KKT_NAMES, cf, ad):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64, name
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0, msg=name)
    structure = k2a.step_structure(spec)
    for name, a in zip(KKT_NAMES, cf):
        if name not in structure:
            continue
        want = k2a.structure_rows(structure[name])
        a = a.reshape(a.shape[:2] + (len(want), len(want[0])))
        for i, row in enumerate(want):
            for jj, c in enumerate(row):
                if c is not None:
                    assert bool((a[:, :, i, jj] == c).all()), (name, i, jj)
    # G's rows 0-1 are live in both control columns (the unicycle's and the
    # simple car's dt Ju has zeros in column 1)
    assert bool((cf[1][..., 0:2, 1] != 0).any())


@pytest.mark.parametrize("model", ["unicycle", "simple_car"])
def test_torch_step_structure_of_a_one_evaluation_shooting_grid(model):
    """Explicit Euler (one stage, one substep) keeps dt Ju's zeros in G."""
    spec = dataclasses.replace(_spec("flagship", "shooting_explicit_euler"),
                               model=MODEL_PAIRS[model][1])
    assert k2a.step_structure(spec)["Gz"][:2] == ("v 0", "v 0")
    scen, primal, duals = iterate(spec, 3)
    _, cf = ad_and_closed_forms(spec, scen, primal, duals)
    assert bool((cf[1][..., 0:2, 1] == 0).all())
    two = dataclasses.replace(spec, collocation="shooting_explicit_euler_2")
    assert k2a.step_structure(two)["Gz"][:2] == ("v v", "v v")


@pytest.mark.parametrize("rule", ["midpoint_differences", "crank_nicolson_differences",
                                  "shooting_rk4", "shooting_rk7_2"])
def test_torch_collocation_kkt_keeps_float32(rule):
    """The AD path's derivatives stay float32 under every rule (the shooting
    grid takes a one-element dt: a 0-d tensor times a Python float gets a
    float64 tangent under torch.func)."""
    spec = _spec("flagship", rule)
    scen, primal, duals = iterate(spec, 5)
    f32 = lambda t: al_sqp.tree_map(  # noqa: E731
        lambda a: a.float() if a.is_floating_point() else a, t)
    ad, cf = ad_and_closed_forms(spec, f32(scen), f32(primal), f32(duals))
    for name, a, b in zip(KKT_NAMES, ad, cf):
        assert a.dtype == b.dtype == torch.float32, name


# --------------------------------------------------------------------------- #
# the count, the scope and the kernel's parameters
# --------------------------------------------------------------------------- #
def test_torch_collocation_flops_per_stage():
    """Per stage of the grid, the simple car: (the defect's value, its
    linearization). Forward differences f + 13 and dyn + 13 + F 2 + G 4;
    Crank–Nicolson twice f and dyn, the averages and the fold; rk4 4 stages
    of f or dyn (3 of them with the tangent) and 7 tableau entries; rk7 at
    2 substeps 22 stages and 94 entries. The forward counts stay."""
    flag = tb.config3_carlike_min_time(N=30, obstacle_cap=8)
    rule = lambda r: dataclasses.replace(flag, collocation=r)  # noqa: E731
    assert k2a._defect_flops(flag) == (20, 31)
    assert k2a._defect_flops(rule("midpoint_differences")) == (35, 65)
    assert k2a._defect_flops(rule("crank_nicolson_differences")) == (33, 76)
    assert k2a._defect_flops(rule("shooting_rk4")) == (84, 310)
    assert k2a._defect_flops(rule("shooting_rk7_2")) == (820, 3542)
    assert k2a.k2a_flops(flag, 3, 4, 3) == 788_378  # the count PERF.md's bound uses
    assert k2a.k2a_flops(rule("crank_nicolson_differences"), 3, 4, 3) == 855_068
    assert k2a.k2a_flops(rule("midpoint_differences"), 3, 4, 3) == 850_208
    assert k2a.k2a_flops(rule("shooting_rk4"), 3, 4, 3) == 1_101_578
    assert k2a.k2a_flops(rule("shooting_rk7_2"), 3, 4, 3) == 4_554_698
    uni = dataclasses.replace(rule("crank_nicolson_differences"), model=tm.UnicycleModel())
    assert k2a._defect_flops(uni) < k2a._defect_flops(rule("crank_nicolson_differences"))


SCOPE = {
    "forward_differences": True, "midpoint_differences": True,
    "crank_nicolson_differences": True, "shooting_rk4": True, "shooting_rk6": True,
    "shooting_rk6_4": True, "shooting_rk7_2": True, "shooting_rk5_4": True,
    "shooting_explicit_euler_4": True, "shooting_rk7_3": False, "shooting_rk4_8": False,
    "shooting_rk6_5": False, "shooting_explicit_euler_20": False,
    "shooting_rk2_heun_8": False, "shooting_rk9": False,
}


@pytest.mark.parametrize("rule", sorted(SCOPE))
def test_torch_collocation_scope_at_its_edges(rule):
    """The kernel takes what JAX ``fused_supported`` takes: every tableau at
    most 4 substeps and 28 stages × substeps (rk7 at 2, not 3)."""
    jspec = dataclasses.replace(jb.config3_carlike_min_time(N=N, obstacle_cap=M), collocation=rule)
    tspec = dataclasses.replace(tb.config3_carlike_min_time(N=N, obstacle_cap=M), collocation=rule)
    assert j_fused_supported(jspec) is SCOPE[rule]
    assert k2a.fused_supported(tspec) is SCOPE[rule]
    scen = tb.random_ensemble(tspec, 2, torch.Generator().manual_seed(0), device="cpu")
    st = al_sqp.SolverSettings(n_al=3, n_sqp=4)
    assert al_sqp.fused_dispatch_ok(tspec, st, scen, torch.float32, "cuda") is SCOPE[rule]
    if not SCOPE[rule]:
        init, duals = al_sqp.default_init(tspec, st, scen)
        with pytest.raises(NotImplementedError, match="JAX fused_supported"):
            k2a.fused_solve_plain(tspec, st, scen, init, duals)


@pytest.mark.parametrize("rule", ["backward_differences", "forward", "Shooting_rk4"])
def test_torch_spec_refuses_a_rule_jax_refuses(rule):
    with pytest.raises(ValueError, match="unknown collocation"):
        dataclasses.replace(jb.config3_carlike_min_time(N=N, obstacle_cap=M), collocation=rule)
    with pytest.raises(ValueError, match="unknown collocation"):
        dataclasses.replace(tb.config3_carlike_min_time(N=N, obstacle_cap=M), collocation=rule)


def test_torch_kernel_parameters_and_group_carry_the_rule():
    flag = tb.config3_carlike_min_time(N=N, obstacle_cap=M)
    scen = tb.random_ensemble(flag, 2, torch.Generator().manual_seed(0), device="cpu")
    st = al_sqp.SolverSettings(n_al=3, n_sqp=4)
    want = {"forward_differences": (0, 0), "midpoint_differences": (1, 1),
            "crank_nicolson_differences": (2, 1), "shooting_rk7_2": (3, 1)}
    groups = set()
    for rule, (colloc, family) in want.items():
        spec = dataclasses.replace(flag, collocation=rule)
        p = k2a._params(spec, st, scen.obstacles)
        assert p.colloc == colloc
        g = k2a.group(spec, torch.float32)
        assert g.colloc == family and f"K2A_COLLOC={family}" in g.defines()
        groups.add(k2a.library_path(g))
    assert len(groups) == 2  # midpoint, Crank–Nicolson and shooting share a library
    assert k2a.library_path(k2a.group(flag, torch.float32)).name.startswith(
        "libfused_al_sqp_f32_m1_o0_")  # forward differences keep their name
    p = k2a._params(dataclasses.replace(flag, collocation="shooting_rk4_2"), st, scen.obstacles)
    assert (p.rk_stages, p.rk_substeps) == (4, 2)
    a = np.array(p.rk_a).reshape(k2a.MAX_RK, k2a.MAX_RK)
    np.testing.assert_array_equal(a[1:4, :3], [[0.5, 0, 0], [0, 0.5, 0], [0, 0, 1.0]])
    np.testing.assert_array_equal(np.array(p.rk_b)[:4], [1 / 6, 2 / 6, 2 / 6, 1 / 6])
    assert len(k2a.GROUPS) == 96 and len(set(g.code() for g in k2a.GROUPS)) == 96


# --------------------------------------------------------------------------- #
# the f64 rule: a lane over its bound measured again (lane_spread)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "err, move, passes",
    [(3.3e3, 3.29e3, True), (3.3e3, 1e-7, False), (1e4, 3.29e3, False), (1e-12, 0.0, True)],
    ids=["chaotic-within", "not-chaotic", "beyond-the-spread", "within-its-bound"],
)
def test_torch_f64_agreement_measures_a_lane_over_its_bound_again(err, move, passes):
    """The Crank–Nicolson flagship's lane 332 at 3×4 (the card): two
    rounding runs move the plain version 6.8e-7, so the kernel's 3.3e3
    breaks 100 times that; under the 32 KKT-rounding patterns on that lane
    alone the plain version moves up to 3.29e3 (its chaos missed), so the
    lane is chaotic and held to twice that move. A lane the patterns do
    not move, or that the kernel leaves beyond twice its spread, still
    fails; a lane within its bound is not measured again."""
    from test_torch_quadratic import _result

    conv = [False, False]
    plain = _result([0.0, 0.0], conv)
    outs_q = [_result([1e-13, 6.8e-7], conv), _result([-1e-13, -6.8e-7], conv)]
    outs_t = [_result([0.0, 0.0], conv)] * 2
    asked = []

    def respread(lanes):
        asked.append(lanes.tolist())
        return [_result([move] * len(lanes), [False] * len(lanes))]

    info, passed, _, _ = agreement.f64_agreement(
        _result([0.0, err], conv), plain, outs_q, outs_t, 5.0, 0.0, respread=respread)
    assert passed is passes, info
    assert asked == ([] if err < 1e-6 else [[1]])
    assert info["lanes_chaotic_by_respread"] == int(move > agreement.CHAOTIC and err > 1e-6)


@pytest.mark.parametrize("extra", [0, 1], ids=["at-the-limit", "over-the-limit"])
def test_torch_f64_agreement_limits_the_lanes_shown_chaotic_again(extra):
    """At most RESPREAD_MAX_LANES lanes of one check may be shown chaotic by
    the second measurement: one more fails the check, each lane within its
    spread, so that a fault spread over chaotic lanes cannot pass."""
    from test_torch_quadratic import _result

    n = agreement.RESPREAD_MAX_LANES + extra
    conv = [False] * (n + 1)
    plain = _result([0.0] * (n + 1), conv)
    outs_q = [_result([1e-13] + [6.8e-7] * n, conv), _result([-1e-13] + [-6.8e-7] * n, conv)]
    outs_t = [_result([0.0] * (n + 1), conv)] * 2

    def respread(lanes):
        return [_result([3.29e3] * len(lanes), [False] * len(lanes))]

    info, passed, _, _ = agreement.f64_agreement(
        _result([0.0] + [3.3e3] * n, conv), plain, outs_q, outs_t, 5.0, 0.0, respread=respread)
    assert info["lanes_chaotic_by_respread"] == n and info["lanes_over_ulp_bound"] == 0
    assert passed is (extra == 0), info
