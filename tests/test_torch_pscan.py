"""The horizon-parallel Riccati solve (``lqr_solve_pscan``) against JAX's and
against the port's sequential ``lqr_solve`` (CPU, float64), and whole solves
at ``kkt="pscan"`` / ``horizon_parallel=True`` against JAX
``vmap(solve_single)``.

Tolerances: 1e-9 absolute, the JAX package's own for its pscan against its
sweep (measured ≤ 1e-13 here); the whole solves 1e-9 on every lane.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.solvers.riccati_pscan import lqr_solve_pscan as j_pscan

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.solvers import al_sqp
from mpc_local_planner_tpu_torch.solvers.riccati import lqr_solve
from mpc_local_planner_tpu_torch.solvers.riccati_pscan import lqr_solve_pscan

NX, NU = 3, 2
NA = NX + NU + 1
TOL = 1e-9


def _psd_qp(seed, N, B=3):
    """A batch of convex KKT problems (PSD stage Hessians, regularized Huu),
    numpy float64."""
    rng = np.random.default_rng(seed)
    nw = NA + NU
    Fz = rng.normal(size=(B, N, NA, NA)) * 0.3 + np.eye(NA) * 0.8
    Gz = rng.normal(size=(B, N, NA, NU))
    rz = rng.normal(size=(B, N, NA)) * 0.1
    X = rng.normal(size=(B, N, nw, nw))
    H = np.einsum("bnij,bnkj->bnik", X, X) * 0.2 + np.eye(nw) * 0.5
    Y = rng.normal(size=(B, NA, NA))
    PN = np.einsum("bij,bkj->bik", Y, Y) * 0.2 + np.eye(NA)
    return (Fz, Gz, rz, H[..., :NA, :NA], H[..., :NA, NA:], H[..., NA:, NA:],
            rng.normal(size=(B, N, NA)), rng.normal(size=(B, N, NU)), PN,
            rng.normal(size=(B, NA)))


@pytest.mark.parametrize("free_tau", [True, False])
@pytest.mark.parametrize("N", [1, 2, 7, 30, 33])
def test_torch_pscan_matches_the_sequential_sweep(N, free_tau):
    qp = _psd_qp(N, N)
    tq = [torch.from_numpy(a) for a in qp] + [torch.full((3,), 1e-3, dtype=torch.float64)]
    got = lqr_solve_pscan(*tq, nx=NX, free_tau=free_tau)
    seq = lqr_solve(*tq, nx=NX, free_tau=free_tau)
    for name, g, s in zip(got._fields, got, seq):
        assert g.shape == s.shape, name
        np.testing.assert_allclose(g.numpy(), s.numpy(), atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("free_tau", [True, False])
def test_torch_pscan_matches_jax(free_tau):
    qp = _psd_qp(11, 7)
    reg = np.full((3,), 1e-3)
    got = lqr_solve_pscan(*[torch.from_numpy(a) for a in qp], torch.from_numpy(reg), nx=NX,
                          free_tau=free_tau)
    want = jax.jit(jax.vmap(lambda *a: j_pscan(*a, nx=NX, free_tau=free_tau)))(
        *[jnp.asarray(a) for a in qp], jnp.asarray(reg))
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0, err_msg=name)


def test_torch_pscan_keeps_float32_and_unbatched_shapes():
    qp = _psd_qp(5, 12, B=1)
    one = [torch.from_numpy(a[0]) for a in qp] + [torch.tensor(1e-3, dtype=torch.float64)]
    got = lqr_solve_pscan(*one, nx=NX, free_tau=True)
    seq = lqr_solve(*one, nx=NX, free_tau=True)
    assert got.dxs.shape == (13, NX) and got.dtau.shape == ()
    np.testing.assert_allclose(got.dus.numpy(), seq.dus.numpy(), atol=TOL, rtol=0)
    f32 = lqr_solve_pscan(*[a.float() for a in one], nx=NX, free_tau=True)
    assert f32.dxs.dtype == torch.float32
    # float32: rounding only, relative to the step's largest entry
    scale = seq.dxs.abs().max()
    assert float((f32.dxs.double() - seq.dxs).abs().max() / scale) < 1e-4


SETTINGS = dict(n_al=2, n_sqp=3, rho0=120.0, reg0=1.0, tol_eq=1e-2, tol_ineq=1e-2,
                alphas=(1.0, 0.5, 0.22))


@functools.lru_cache(maxsize=None)
def _jax_solve(case):
    jspec = {"flagship": jb.config3_carlike_min_time(N=8, obstacle_cap=4),
             "config2": jb.config2_diffdrive_obstacles(N=8, obstacle_cap=3)}[case]
    B = 6
    scen = jb.random_ensemble(jspec, B, jax.random.PRNGKey(3), dtype=jnp.float64)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.3 * (scen.xf - scen.x0))
    jst = j_al.SolverSettings(**SETTINGS, kkt="pscan")
    duals = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                   j_al.init_duals(jspec, jst, jnp.float64))
    init = j_initial_primal(jspec, scen)
    out = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, jst, s, i, d)))(
        scen, init, duals)
    tree = lambda t: {f.name: tree(getattr(t, f.name)) for f in dataclasses.fields(t)} \
        if dataclasses.is_dataclass(t) else np.asarray(t)  # noqa: E731
    return tree(scen), tree(init), tree(duals), tree(out)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("how", ["kkt", "horizon_parallel"])
@pytest.mark.parametrize("case", ["flagship", "config2"])
def test_torch_solve_with_the_pscan_kkt_matches_jax(case, how):
    scen, init, duals, j = _jax_solve(case)
    spec = {"flagship": tb.config3_carlike_min_time(N=8, obstacle_cap=4),
            "config2": tb.config2_diffdrive_obstacles(N=8, obstacle_cap=3)}[case]
    extra = {"kkt": "pscan"} if how == "kkt" else {"horizon_parallel": True}
    st = al_sqp.SolverSettings(**SETTINGS, **extra)
    before = riccati_cuda.lqr_solve_cuda.launches
    t = convert.to_numpy(al_sqp.make_solver(spec, st, device="cpu")(
        convert.from_numpy(Scenario, scen, "cpu"), convert.from_numpy(Primal, init, "cpu"),
        convert.from_numpy(al_sqp.DualState, duals, "cpu")))
    assert riccati_cuda.lqr_solve_cuda.launches == before
    np.testing.assert_array_equal(t["converged"], j["converged"])
    for (name, a), (_, b) in zip(_leaves(t), _leaves(j)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=name)


def test_torch_pscan_reads_only_the_symmetric_part_of_hzz_as_the_sweep_does():
    """An AD Hessian's Hzz is symmetric only to rounding (1e-5 in float32);
    the sweep reads it through its symmetrized value function, and so does
    the pscan: a 1e-5 antisymmetric part leaves both steps where they were."""
    qp = [torch.from_numpy(a) for a in _psd_qp(9, 30)]
    reg = torch.full((3,), 1e-3, dtype=torch.float64)
    skew = torch.from_numpy(np.random.default_rng(2).normal(size=qp[3].shape)) * 1e-5
    bent = list(qp)
    bent[3] = qp[3] + skew - skew.mT
    for args in (qp, bent):
        got = lqr_solve_pscan(*args, reg, nx=NX, free_tau=True)
        seq = lqr_solve(*qp, reg, nx=NX, free_tau=True)
        for name, g, s in zip(got._fields, got, seq):
            np.testing.assert_allclose(g.numpy(), s.numpy(), atol=TOL, rtol=0, err_msg=name)
