"""The non-uniform per-stage dt grid (``spec.nonuniform_dt``) on the CPU,
piece by piece against the JAX package, from identical inputs made with
numpy (float64):

- the grid: the seed, ``warm_start_shift`` and ``warm_start_resample`` on a
  dt that varies by stage (gathered at the controls' rounded stages, then
  scaled), at 1e-12;
- the costs (Σ dt_k, the quadratic form's integral left-sum and trapezoidal
  rules on the grid, the hybrid weight), the constraints (the rate rows at
  each stage's dt, the 2N interval dt boxes, dynamic obstacles at the
  cumulative times Σ_{j<k} dt_j), the defects, the augmented transition
  with δdt_k as control column nu, and the stage obstacle sets, at 1e-12;
- the per-stage trust cap, with one interval at dt_min (floored at dt_ref
  it does not stall the step);
- the duals (2N dt-box multipliers, shifted with the grid);
- the fused kernel's closed forms (``fused_kkt_system``) against the port's
  AD path at 1e-10, with the trapezoidal dt_{k-1} coupling, an exactly
  active rate row and an exactly active dt box;
- the kernel's scope, inputs, parameters, step structure and operation
  count on the grid.

``tests/test_torch_nonuniform_solves.py`` runs whole solves and path E's
fleet cycle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp import constraints as j_C
from mpc_local_planner_tpu.ocp import grid as j_grid
from mpc_local_planner_tpu.ocp.collocation import collocation_defects as j_defects
from mpc_local_planner_tpu.ocp.costs import total_cost as j_total_cost
from mpc_local_planner_tpu.ocp.spec import Scenario as JScenario
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.solvers.riccati import (
    build_augmented_transition_nonuniform as j_transition,
)

from test_torch_cycle import _np, _to_jax
from test_torch_quadratic import KKT_NAMES
from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.geometry.footprints import TwoCirclesFootprint
from mpc_local_planner_tpu_torch.ocp import constraints as t_C
from mpc_local_planner_tpu_torch.ocp import grid as t_grid
from mpc_local_planner_tpu_torch.ocp.collocation import collocation_defects as t_defects
from mpc_local_planner_tpu_torch.ocp.costs import total_cost as t_total_cost
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.solvers import al_sqp
from mpc_local_planner_tpu_torch.solvers.riccati import (
    build_augmented_transition_nonuniform as t_transition,
)

B, N, M = 5, 8, 4
TRAPEZOIDAL = dict(integral_form=True, cost_integration="trapezoidal", hybrid_time_weight=0.4,
                   variable_dt=True, nonuniform_dt=True, dt_min=1e-3, dt_max=0.5)
# case: (JAX spec, port spec) makers; all on the non-uniform grid
CASES = {
    "min_time": lambda m: m.config3_carlike_min_time(N=N, obstacle_cap=M),
    "trapezoidal": lambda m: dataclasses.replace(
        m.config2_diffdrive_obstacles(N=N, obstacle_cap=M), **TRAPEZOIDAL),
    "left_sum": lambda m: dataclasses.replace(
        m.config2_diffdrive_obstacles(N=N, obstacle_cap=M),
        **dict(TRAPEZOIDAL, cost_integration="left_sum")),
    "plain_quadratic": lambda m: dataclasses.replace(
        m.config2_diffdrive_obstacles(N=N, obstacle_cap=M),
        **dict(TRAPEZOIDAL, integral_form=False)),
}


def spec_pair(case, **over):
    j, t = CASES[case](jb), CASES[case](tb)
    over = dict(over, nonuniform_dt=True)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def _scenario(case, seed=0, dynamic=False):
    """A float64 scenario of ``case`` (numpy tree), the obstacles moving at up
    to 0.4 m/s with ``dynamic``."""
    jspec, _ = spec_pair(case)
    rng = np.random.default_rng(seed)
    scen = _np(jb.random_ensemble(jspec, B, jax.random.PRNGKey(seed), dtype=jnp.float64))
    if dynamic:
        obs = scen["obstacles"]
        obs["circle_vels"] = rng.uniform(-0.4, 0.4, size=obs["circle_vels"].shape)
        obs["circle_mask"] = np.ones_like(obs["circle_mask"])
    return scen


def _lane(tree, lane):
    """One lane of a numpy tree."""
    return {k: _lane(v, lane) if isinstance(v, dict) else v[lane] for k, v in tree.items()}


def _primal(seed=1, n_lead=()):
    """A float64 trajectory with a dt that varies by stage (numpy)."""
    rng = np.random.default_rng(seed)
    lead = tuple(n_lead) + (B,)
    return dict(
        xs=rng.normal(size=lead + (N + 1, 3)), us=0.3 * rng.normal(size=lead + (N, 2)),
        dt=rng.uniform(0.1, 0.45, size=lead + (N,)),
    )


# --------------------------------------------------------------------------- #
# the grid
# --------------------------------------------------------------------------- #
def test_torch_nonuniform_initial_primal_matches_jax():
    jspec, tspec = spec_pair("min_time")
    scen = _scenario("min_time")
    j = _np(j_grid.initial_primal(jspec, _to_jax(JScenario, scen)))
    t = convert.to_numpy(t_grid.initial_primal(tspec, convert.from_numpy(TScenario, scen, "cpu")))
    assert t["dt"].shape == (B, N)
    for k in ("xs", "us", "dt"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-12, rtol=0, err_msg=k)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("warm_start", ["warm_start_resample", "warm_start_shift"])
def test_torch_nonuniform_warm_starts_match_jax(warm_start, steps):
    """A dt that varies by stage: the resample gathers it at the controls'
    rounded stages (iu), scales it by (N − steps)/N and floors it at dt_min;
    the shift moves it with the controls and extrapolates the tail at the
    last interval's dt."""
    jspec, tspec = spec_pair("min_time")
    p = _primal()
    p["dt"][:, 2] = 1e-4  # an interval below the floor
    x0 = np.random.default_rng(2).normal(size=(B, 3))
    jp = j_grid.Primal(**{k: jnp.asarray(v) for k, v in p.items()})
    j = _np(getattr(j_grid, warm_start)(jp, jnp.asarray(x0), steps=steps, spec=jspec))
    tp = Primal(**{k: torch.from_numpy(v) for k, v in p.items()})
    t = convert.to_numpy(getattr(t_grid, warm_start)(tp, torch.from_numpy(x0), steps=steps,
                                                     spec=tspec))
    for k in ("xs", "us", "dt"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-12, rtol=0, err_msg=k)
    if warm_start == "warm_start_resample":
        iu = np.clip(np.round(steps + np.arange(N) * (N - steps) / N).astype(int), 0, N - 1)
        want = np.maximum(p["dt"][:, iu] * (N - steps) / N, max(tspec.dt_min, 1e-3))
        np.testing.assert_allclose(t["dt"], want, atol=1e-15, rtol=0)
        assert len(np.unique(t["dt"][0])) > 2  # still varies by stage


# --------------------------------------------------------------------------- #
# costs, constraints, defects, the transition
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_nonuniform_total_cost_matches_jax(case):
    """Σ dt_k, and the quadratic forms on the grid (Qf, the hybrid weight),
    with a candidate axis in front of the lane axis."""
    jspec, tspec = spec_pair(case, qf_diag=(3.0, 5.0, 7.0)) if case != "min_time" else \
        spec_pair(case)
    scen = _scenario(case)
    p = _primal(n_lead=(3,))
    want = j_total_cost(jspec, p["xs"], p["us"], p["dt"], _to_jax(JScenario, scen))
    T = torch.from_numpy
    got = t_total_cost(tspec, T(p["xs"]), T(p["us"]), T(p["dt"]),
                       convert.from_numpy(TScenario, scen, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)
    if case == "min_time":
        np.testing.assert_allclose(got.numpy(), p["dt"].sum(axis=-1), atol=1e-12, rtol=0)


def test_torch_nonuniform_constraints_match_jax():
    """The rate rows at each stage's dt, the 2N interval dt boxes ([hi, lo]
    per interval) and dynamic obstacles predicted to the cumulative times
    Σ_{j≤k} dt_j of x_{k+1}, with a candidate axis."""
    jspec, tspec = spec_pair("min_time", enable_dynamic_obstacles=True)
    scen = _scenario("min_time", dynamic=True)
    p = _primal(n_lead=(2,))
    js, ts = _to_jax(JScenario, scen), convert.from_numpy(TScenario, scen, "cpu")
    T = torch.from_numpy
    # the JAX constraints take one lane's scenario (its solver vmaps them)
    j_obs = np.stack([np.stack([
        np.asarray(j_C.obstacle_inequalities(jspec, p["xs"][c, lane], p["dt"][c, lane],
                                             _to_jax(JScenario, _lane(scen, lane))))
        for lane in range(B)]) for c in range(2)])
    pairs = (
        (j_obs, t_C.obstacle_inequalities(tspec, T(p["xs"]), T(p["dt"]), ts)),
        (j_C.control_rate_inequalities(jspec, p["us"], p["dt"], jnp.broadcast_to(js.u_prev, (2, B, 2))),
         t_C.control_rate_inequalities(tspec, T(p["us"]), T(p["dt"]), ts.u_prev)),
        (j_C.dt_inequalities(jspec, p["dt"], jnp.float64),
         t_C.dt_inequalities(tspec, T(p["dt"]), torch.float64)),
    )
    for want, got in pairs:
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)
    g_dt = pairs[2][1]
    assert tuple(g_dt.shape) == (2, B, 2 * N)
    np.testing.assert_allclose(g_dt[..., 0::2].numpy(), p["dt"] - tspec.dt_max, atol=0, rtol=0)
    # the cumulative times: a moving slot is met where it stands at Σ dt
    static = t_C.obstacle_inequalities(dataclasses.replace(tspec, enable_dynamic_obstacles=False),
                                       T(p["xs"]), T(p["dt"]), ts)
    assert not torch.allclose(pairs[0][1], static)


def test_torch_nonuniform_defects_and_transition_match_jax():
    jspec, tspec = spec_pair("min_time")
    p = _primal(n_lead=(2,))
    T = torch.from_numpy
    want = j_defects(jspec.model, jspec.collocation, p["xs"], p["us"], p["dt"])
    got = t_defects(tspec.model, tspec.collocation, T(p["xs"]), T(p["us"]), T(p["dt"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)
    rng = np.random.default_rng(4)
    F, G = rng.normal(size=(N, 3, 3)), rng.normal(size=(N, 3, 2))
    m, r = rng.normal(size=(N, 3)), rng.normal(size=(N, 3))
    jz = j_transition(F, G, m, r, nu=2)
    tz = t_transition(T(F), T(G), T(m), T(r), nu=2)
    for a, b in zip(tz, jz):
        assert tuple(a.shape) == np.shape(b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tuple(tz[1].shape) == (N, 6, 3)  # δdt_k: control column 2, na stays 6


def test_torch_nonuniform_stage_obstacles_match_jax():
    """Stage i of the derivatives' obstacle sets sits at Σ_{j<i} dt_j."""
    jspec, tspec = spec_pair("min_time", enable_dynamic_obstacles=True)
    scen = _scenario("min_time", dynamic=True)
    dt = _primal()["dt"]
    t = al_sqp._stage_obstacles(tspec, convert.from_numpy(TScenario, scen, "cpu"),
                                torch.from_numpy(dt), N + 1)
    for lane in range(B):
        js = _to_jax(JScenario, _lane(scen, lane))
        j = _np(j_al._stage_obstacles(jspec, js, jnp.asarray(dt[lane]), N + 1))
        np.testing.assert_allclose(t.circles[lane].numpy(), j["circles"], atol=1e-12, rtol=0)
    times = np.concatenate([np.zeros((B, 1)), np.cumsum(dt, axis=-1)], axis=-1)
    want = scen["obstacles"]["circles"][:, None] + scen["obstacles"]["circle_vels"][:, None] \
        * times[..., None, None]
    np.testing.assert_allclose(t.circles.numpy(), want, atol=1e-12, rtol=0)


# --------------------------------------------------------------------------- #
# the per-stage trust cap, the duals
# --------------------------------------------------------------------------- #
def test_torch_nonuniform_trust_cap_floors_each_stage_at_dt_ref():
    """The cap is the least over the stages of frac·max(dt_k, dt_ref)/|δdt_k|
    (JAX ``_sqp_iteration``): a lane whose one interval sits at dt_min is not
    capped at frac·dt_min/|δdt|."""
    _, tspec = spec_pair("min_time")
    st = al_sqp.SolverSettings()
    dt = torch.full((3, N), 0.3, dtype=torch.float64)
    dtau = torch.full((3, N), 0.02, dtype=torch.float64)
    dt[1, 4] = tspec.dt_min           # one interval on the floor
    dtau[1, 4] = 0.05                 # growing it back
    dtau[2] = 0.0                     # no dt step: no cap
    cap = al_sqp.dt_trust_cap(tspec, st, dt, dtau)
    frac, ref = st.dt_trust_frac, tspec.dt_ref
    want = np.array([1.0, min(1.0, frac * ref / 0.05), 1.0])
    np.testing.assert_allclose(cap.numpy(), want, atol=1e-15, rtol=0)
    unfloored = frac * tspec.dt_min / 0.05
    assert cap[1] > 100 * unfloored
    # the uniform grid keeps one cap per lane from the shared dt
    uni = dataclasses.replace(tspec, nonuniform_dt=False)
    np.testing.assert_allclose(
        al_sqp.dt_trust_cap(uni, st, dt[:, 4], dtau[:, 4]).numpy(),
        [1.0, frac * tspec.dt_min / 0.05, 1.0], atol=1e-15, rtol=0)


def test_torch_nonuniform_duals_match_jax():
    """init_duals: 2N dt-box multipliers; shift_duals: the [hi, lo] pairs
    roll with the grid."""
    jspec, tspec = spec_pair("min_time")
    st = al_sqp.SolverSettings()
    d = al_sqp.init_duals(tspec, st, torch.float64, "cpu", batch=(B,))
    assert tuple(d.mu_dt.shape) == (B, 2 * N)
    rng = np.random.default_rng(5)
    d = dataclasses.replace(d, **{f.name: torch.from_numpy(rng.uniform(size=getattr(d, f.name).shape))
                                  for f in dataclasses.fields(d)})
    j = _np(j_al.shift_duals(_to_jax(j_al.DualState, convert.to_numpy(d)),
                             j_al.SolverSettings(), steps=2))
    t = convert.to_numpy(al_sqp.shift_duals(d, st, steps=2))
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    np.testing.assert_array_equal(t["mu_dt"][:, :2], convert.to_numpy(d)["mu_dt"][:, 4:6])


# --------------------------------------------------------------------------- #
# the fused kernel's closed forms against the AD path
# --------------------------------------------------------------------------- #
def iterate(case, seed, ties=False, dynamic=False, two_discs=False):
    """A float64 iterate of ``case`` away from the seed, with a dt that varies
    by stage, obstacles on the trajectory and random duals. ``ties``: a rate
    row and the dt box's lower row of an interval exactly active with zero
    multipliers."""
    _, spec = spec_pair(case, enable_dynamic_obstacles=dynamic)
    if two_discs:
        spec = dataclasses.replace(spec, footprint=TwoCirclesFootprint(0.15, 0.2, -0.15, 0.2))
    scen = tb.random_ensemble(spec, B, torch.Generator().manual_seed(seed), dtype=torch.float64,
                              device="cpu")
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float64))  # noqa: E731
    init = t_grid.initial_primal(spec, scen)
    xs = init.xs + T(0.05 * rng.normal(size=init.xs.shape))
    us = init.us + T(0.05 * rng.normal(size=init.us.shape))
    dt = init.dt * T(rng.uniform(0.6, 1.4, size=init.dt.shape))
    obs = scen.obstacles
    circles, mask = obs.circles.clone(), obs.circle_mask.clone()
    circles[:, 0] = xs[:, 3, :2] + T(0.1 * rng.normal(size=(B, 2)))
    circles[:, 1] = xs[:, N, :2] + T(0.1 * rng.normal(size=(B, 2)))
    mask[:, :2] = True
    vels = T(rng.uniform(-0.4, 0.4, size=obs.circle_vels.shape)) if dynamic else obs.circle_vels
    scen = dataclasses.replace(scen, obstacles=dataclasses.replace(
        obs, circles=circles, circle_mask=mask, circle_vels=vels))
    duals = al_sqp.DualState(
        lam_def=T(rng.normal(size=(B, N, 3))), lam_term=T(rng.normal(size=(B, 3))),
        mu_obs=T(rng.uniform(0.0, 2.0, size=(B, N, M))),
        mu_rate=T(rng.uniform(0.0, 1.0, size=(B, N, 4))),
        mu_box=T(rng.uniform(0.0, 1.0, size=(B, N, 4))),
        mu_dt=T(rng.uniform(0.0, 1.0, size=(B, 2 * N))),
        mu_ball=T(rng.uniform(0.0, 3.0, size=(B, 1))),
        rho=T(rng.uniform(50.0, 200.0, size=B)),
    )
    if ties:
        hi_r = float(spec.control_rate_box()[1][0])
        dt[:, 3] = 0.25
        us[:, 2, 0] = 0.0
        us[:, 3, 0] = hi_r * 0.25          # rate row 0 at stage 3: du − acc·dt == 0
        dt[:, 5] = spec.dt_min             # the lower dt row of interval 5 == 0
        mu_rate, mu_dt = duals.mu_rate.clone(), duals.mu_dt.clone()
        mu_rate[:, 3, 0] = 0.0
        mu_dt[:, 2 * 5 + 1] = 0.0
        duals = dataclasses.replace(duals, mu_rate=mu_rate, mu_dt=mu_dt)
    return spec, scen, Primal(xs=xs, us=us, dt=dt), duals


def ad_and_closed_forms(spec, scen, primal, duals, dt_prox=0.7):
    obs_k = al_sqp._stage_obstacles(spec, scen, primal.dt, N + 1)
    ad = al_sqp._kkt_system(spec, al_sqp._make_stage_fns(spec), al_sqp._make_terminal_fns(spec),
                            primal, scen, duals, obs_k, dt_prox)
    return ad, k2a.fused_kkt_system(spec, primal, scen, duals, obs_k, dt_prox)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_nonuniform_closed_forms_match_the_ad_path(case, ties):
    spec, scen, primal, duals = iterate(case, 2, ties=ties)
    ad, cf = ad_and_closed_forms(spec, scen, primal, duals)
    for name, a, b in zip(KKT_NAMES, cf, ad):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64, name
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0, msg=name)
    Gz, Hzz, Huu = cf[1], cf[3], cf[5]
    assert tuple(Gz.shape) == (B, N, 6, 3) and tuple(Huu.shape) == (B, N, 3, 3)
    if case == "trapezoidal":  # the ½(dt_{k-1} + dt_k)·lx_k coupling of dt_{k-1}
        assert bool((Hzz[..., :3, 5] != 0).all())
    else:
        assert bool((Hzz[..., :, 5] == 0).all())
    if ties:
        g = t_C.dt_inequalities(spec, primal.dt, torch.float64)
        assert bool((g[:, 2 * 5 + 1] == 0).all())
        rho = duals.rho[:, None]
        # at the tie the box adds ρ/4 (the 0.5 tie subgradient squared) and
        # dt_prox to the δdt diagonal; the upper row is inactive
        off = dataclasses.replace(spec, dt_min=spec.dt_min - 1.0)
        _, cf_off = ad_and_closed_forms(off, scen, primal, duals)
        torch.testing.assert_close(Huu[:, 5, 2, 2] - cf_off[5][:, 5, 2, 2],
                                   (rho / 4)[:, 0], atol=1e-10, rtol=0)


def test_torch_nonuniform_closed_forms_with_two_moving_discs():
    """Two discs off the pose and moving slots predicted at Σ_{j<k} dt_j."""
    spec, scen, primal, duals = iterate("min_time", 6, dynamic=True, two_discs=True)
    ad, cf = ad_and_closed_forms(spec, scen, primal, duals)
    for name, a, b in zip(KKT_NAMES, cf, ad):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0, msg=name)


# --------------------------------------------------------------------------- #
# the kernel's scope, inputs, parameters, structure and count
# --------------------------------------------------------------------------- #
def test_torch_nonuniform_in_the_kernel_scope():
    spec = tb.family_spec("nonuniform", N=N)
    assert spec.nonuniform_dt and k2a.fused_supported(spec)
    scen = tb.random_ensemble(spec, B, torch.Generator().manual_seed(0), device="cpu")
    st = al_sqp.SolverSettings(n_al=3, n_sqp=4, dt_prox=0.5)
    assert al_sqp.fused_dispatch_ok(spec, st, scen, torch.float32, "cuda")
    init, duals = al_sqp.default_init(spec, st, scen)
    ins, outs = k2a.kernel_io(spec, scen, init, duals)
    assert tuple(ins[2].shape) == (B, N) and tuple(ins[21].shape) == (B, 2 * N)
    assert tuple(outs[2].shape) == (B, N) and tuple(outs[8].shape) == (B, 2 * N)
    params = k2a._params(spec, st, scen.obstacles)
    assert (params.nonu, params.dt_ref, params.dt_prox) == (1, spec.dt_ref, 0.5)
    assert k2a._params(tb.family_spec("flagship", N=N), st, scen.obstacles).nonu == 0
    g = k2a.group(spec, torch.float32)
    assert g.nonu and k2a.group(tb.family_spec("flagship", N=N), torch.float32) == g._replace(
        nonu=False)
    assert k2a.library_path(g) != k2a.library_path(g._replace(nonu=False))
    with pytest.raises(ValueError, match="CUDA"):
        k2a.fused_solve_cuda(spec, st, scen, init, duals)
    with pytest.raises(ValueError, match="requires variable_dt"):
        dataclasses.replace(spec, variable_dt=False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_nonuniform_step_structure_matches_the_plain_tensors(case):
    spec, scen, primal, duals = iterate(case, 4, ties=True)
    _, cf = ad_and_closed_forms(spec, scen, primal, duals)
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


def test_torch_nonuniform_flop_count():
    """The grid adds the 3-column step (the 3×3 adjugate), the stage dt rows,
    each stage's clip and cap, and the sum of the stage dt to the
    flagship's count; the uniform counts stay."""
    flag, nonu = tb.family_spec("flagship"), tb.family_spec("nonuniform")
    assert k2a.k2a_flops(flag, 3, 4, 3) == 788_378
    assert k2a.k2a_flops(nonu, 3, 4, 3) == 850_644
    assert k2a.k2a_flops(nonu, 4, 4, 8) == 1_851_462
    riccati_u, rollout_u = k2a.step_flops(k2a.step_structure(flag))
    riccati_n, rollout_n = k2a.step_flops(k2a.step_structure(nonu))
    assert riccati_n > riccati_u and rollout_n > rollout_u


def test_torch_nonuniform_kkt_is_refused_by_k1():
    """The grid's KKT inputs (three control columns) never reach kernel K1,
    which takes the uniform two-column shape and raises on this one."""
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    spec, scen, primal, duals = iterate("min_time", 3)
    kkt, _ = ad_and_closed_forms(spec, scen, primal, duals)
    reg = torch.ones(B, dtype=torch.float64)
    with pytest.raises(ValueError, match="nu=2"):
        riccati_cuda.lqr_solve_cuda(*kkt, reg, nx=3, free_tau=False)
