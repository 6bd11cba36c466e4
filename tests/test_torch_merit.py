"""Stage and terminal AL merits of the port vs the JAX package (f64, CPU).

The SQP's KKT data are AD derivatives of these functions: the exact merit
gradient and the Hessian of the Gauss-Newton surrogate. They are compared
at random points and at points where a PHR hinge is exactly active, which
pins JAX's tie convention: ``jnp.maximum`` splits the subgradient 0.5/0.5,
so the Hessian of an exactly active hinge is ρ/4 (``clamp``/``relu`` in the
port would give ρ or 0). Tolerance: atol 1e-10 (same formulas, f64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu.benchmarks import config3_carlike_min_time as j_config3
from mpc_local_planner_tpu.geometry.obstacles import ObstacleSet as JObstacleSet
from mpc_local_planner_tpu.solvers import al_sqp as j_al

from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time as t_config3
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet as TObstacleSet
from mpc_local_planner_tpu_torch.solvers import al_sqp as t_al

ATOL = 1e-10
N, M = 8, 4
RHO = 37.0


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _obs():
    jo = JObstacleSet.from_lists(
        circles=[(0.9, 0.1, 0.25), (2.0, -0.6, 0.3), (30.0, 30.0, 0.2)],
        capacities=(0, 4, 0, 0), dtype=jnp.float64,
    )
    arrays = {f: np.asarray(getattr(jo, f)) for f in jo.__dataclass_fields__}
    return jo, convert.from_numpy(TObstacleSet, arrays, "cpu")


def _stage_point(tie):
    rng = np.random.default_rng(11 if tie else 12)
    x = rng.normal(size=3) * 0.5
    up = rng.normal(size=2) * 0.2
    u = rng.normal(size=2) * 0.3
    dt = 0.25
    mu_obs = np.abs(rng.normal(size=M))
    mu_rate = np.abs(rng.normal(size=4))
    mu_box = np.abs(rng.normal(size=4))
    if tie:
        # u0 exactly on its upper box bound with a zero multiplier; every
        # other row inactive (rate rows negative, obstacles far, μ = 0)
        x = np.array([30.0, 28.0, 0.3])
        u = np.array([0.4, 0.1])
        up = np.array([0.4, 0.1])
        mu_obs[:] = 0.0
        mu_rate[:] = 0.0
        mu_box[:] = 0.0
    w = np.concatenate([x, up, u, [dt]])
    return w, mu_obs, mu_rate, mu_box


@pytest.mark.parametrize("tie", [False, True])
def test_torch_stage_merit_gradient_and_surrogate_hessian(tie):
    jspec, tspec = j_config3(N=N, obstacle_cap=M), t_config3(N=N, obstacle_cap=M)
    jo, to = _obs()
    w, mu_obs, mu_rate, mu_box = _stage_point(tie)
    jd = j_al.StageData(
        xref=jnp.zeros(3), iw=jnp.asarray(1.0), via_pts=jnp.zeros((0, 3)),
        via_w=jnp.zeros((0,)), mu_obs=jnp.asarray(mu_obs), obs_on=jnp.asarray(1.0),
        mu_rate=jnp.asarray(mu_rate), mu_box=jnp.asarray(mu_box),
        mu_dt=jnp.zeros((0,)), obs=jo,
    )
    td = t_al.StageData(
        mu_obs=_t(mu_obs), obs_on=_t(1.0), mu_rate=_t(mu_rate), mu_box=_t(mu_box), obs=to,
    )
    _, j_cons, j_merit, j_hess, j_gn = j_al._make_stage_fns(jspec)
    _, t_cons, t_merit, t_hess, t_gn = t_al._make_stage_fns(tspec)
    rho_j, rho_t = jnp.asarray(RHO), _t(RHO)

    np.testing.assert_allclose(t_cons(_t(w), td).numpy(), j_cons(w, jd), atol=ATOL, rtol=0)
    g_t = torch.func.grad(t_merit)(_t(w), td, rho_t)
    np.testing.assert_allclose(g_t.numpy(), jax.grad(j_merit)(w, jd, rho_j), atol=ATOL, rtol=0)

    g0_j = j_cons(w, jd)
    aw_j = j_gn(jd, g0_j, rho_j)
    g0_t = t_cons(_t(w), td)
    aw_t = t_gn(td, g0_t, rho_t)
    np.testing.assert_allclose(aw_t.numpy(), aw_j, atol=ATOL, rtol=0)
    H_t = torch.func.hessian(t_hess)(_t(w), td, rho_t, g0_t, aw_t)
    H_j = jax.hessian(j_hess)(w, jd, rho_j, g0_j, aw_j)
    np.testing.assert_allclose(H_t.numpy(), H_j, atol=ATOL, rtol=0)
    if tie:
        assert H_t[5, 5].item() == pytest.approx(RHO / 4.0, rel=1e-12)


@pytest.mark.parametrize("tie", [False, True])
def test_torch_terminal_merit_gradient_and_surrogate_hessian(tie):
    jspec, tspec = j_config3(N=N, obstacle_cap=M), t_config3(N=N, obstacle_cap=M)
    jo, to = _obs()
    rng = np.random.default_rng(21 if tie else 22)
    x = rng.normal(size=3)
    xref = x + rng.normal(size=3) * 0.1
    mu_obs = np.abs(rng.normal(size=M))
    lam_term = rng.normal(size=3)
    mu_dt = np.abs(rng.normal(size=2))
    dt = 0.3
    if tie:
        # dt exactly on dt_max with a zero multiplier, obstacles far
        x = np.array([30.0, 28.0, 0.3])
        xref = x + 0.05
        dt = jspec.dt_max
        mu_obs[:] = 0.0
        mu_dt[:] = 0.0
    w = np.concatenate([x, rng.normal(size=2) * 0.2, [dt]])
    jd = j_al.TermData(
        xref=jnp.asarray(xref), via_pts=jnp.zeros((0, 3)), via_w=jnp.zeros((0,)),
        mu_obs=jnp.asarray(mu_obs), lam_term=jnp.asarray(lam_term),
        mu_ball=jnp.zeros(1), mu_dt=jnp.asarray(mu_dt), obs=jo,
    )
    td = t_al.TermData(
        xref=_t(xref), mu_obs=_t(mu_obs), lam_term=_t(lam_term), mu_ball=_t(np.zeros(1)),
        mu_dt=_t(mu_dt), obs=to,
    )
    _, j_cons, _, j_merit, j_hess, j_gn = j_al._make_terminal_fns(jspec)
    t_cons, _, t_merit, t_hess, t_gn = t_al._make_terminal_fns(tspec)
    rho_j, rho_t = jnp.asarray(RHO), _t(RHO)

    g_t = torch.func.grad(t_merit)(_t(w), td, rho_t)
    np.testing.assert_allclose(g_t.numpy(), jax.grad(j_merit)(w, jd, rho_j), atol=ATOL, rtol=0)
    g0_j = j_cons(w, jd)
    aw_j = j_gn(jd, g0_j, rho_j)
    g0_t = t_cons(_t(w), td)
    aw_t = t_gn(td, g0_t, rho_t)
    np.testing.assert_allclose(g0_t.numpy(), g0_j, atol=ATOL, rtol=0)
    H_t = torch.func.hessian(t_hess)(_t(w), td, rho_t, g0_t, aw_t)
    H_j = jax.hessian(j_hess)(w, jd, rho_j, g0_j, aw_j)
    np.testing.assert_allclose(H_t.numpy(), H_j, atol=ATOL, rtol=0)
    if tie:
        # the xf-fixed equality adds ρ on the pose block only; dt is the tie
        assert H_t[5, 5].item() == pytest.approx(RHO / 4.0, rel=1e-12)


def test_torch_merit_derivatives_keep_float32():
    """torch.func forward mode promotes 0-d × Python-float tangents to f64;
    the stage and terminal functions must keep the working dtype."""
    tspec = t_config3(N=N, obstacle_cap=M)
    _, to = _obs()
    to32 = type(to)(**{
        k: (v.float() if v.is_floating_point() else v) for k, v in vars(to).items()
    })
    w, mu_obs, mu_rate, mu_box = _stage_point(False)
    f32 = lambda a: _t(a).float()  # noqa: E731
    td = t_al.StageData(f32(mu_obs), f32(1.0), f32(mu_rate), f32(mu_box), to32)
    _, t_cons, _, t_hess, t_gn = t_al._make_stage_fns(tspec)
    g0 = t_cons(f32(w), td)
    H = torch.func.hessian(t_hess)(f32(w), td, f32(RHO), g0, t_gn(td, g0, f32(RHO)))
    assert H.dtype == torch.float32
    tdT = t_al.TermData(f32(np.zeros(3)), f32(mu_obs), f32(np.zeros(3)),
                        f32(np.zeros(1)), f32(np.zeros(2)), to32)
    t_cons, _, _, t_hess, t_gn = t_al._make_terminal_fns(tspec)
    wT = f32(w[[0, 1, 2, 3, 4, 7]])
    g0 = t_cons(wT, tdT)
    PN = torch.func.vmap(torch.func.hessian(t_hess))(
        wT[None], torch.utils._pytree.tree_map(lambda a: a[None], tdT),
        f32(RHO)[None], g0[None], t_gn(tdT, g0, f32(RHO))[None],
    )
    assert PN.dtype == torch.float32
