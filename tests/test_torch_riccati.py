"""Kernel K1's plain version (``solvers.riccati.lqr_solve``) and its dispatch
(``ops.riccati_cuda.lqr_solve_auto``) against JAX ``solvers.riccati.lqr_solve``
— the plain reference of the Pallas kernel, which has no interpret mode.

Data: random well-conditioned QPs (numpy seed) and the Riccati inputs of a
real flagship SQP iteration at N=8. Tolerances: f64 atol 1e-10 (same
recursion, rounding only); f32 max error ≤ 1e-4 of the step's largest
entry (the recursion amplifies f32 rounding, 6e-8, by the conditioning of
Quu over the stages; both sides are f32 on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu.benchmarks import config3_carlike_min_time as j_config3
from mpc_local_planner_tpu.benchmarks import random_ensemble as j_random_ensemble
from mpc_local_planner_tpu.ops import smallmat as j_sm
from mpc_local_planner_tpu.solvers import riccati as j_ric

from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time as t_config3
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.ops import nvcc_build, riccati_cuda
from mpc_local_planner_tpu_torch.ops import smallmat as t_sm
from mpc_local_planner_tpu_torch.solvers import al_sqp as t_al
from mpc_local_planner_tpu_torch.solvers import riccati as t_ric

NX, NU, N, B = 3, 2, 6, 3
NA = NX + NU + 1
F32_RTOL = 1e-4


def _random_qps(seed):
    """B well-conditioned QPs: SPD Hessians, F ≈ I."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(B, N, NX, NX)) * 0.4 + np.eye(NX)
    G = rng.normal(size=(B, N, NX, NU)) * 0.5
    m = rng.normal(size=(B, N, NX)) * 0.5
    r = rng.normal(size=(B, N, NX)) * 0.3
    Az = rng.normal(size=(B, N, NA, NA))
    Hzz = Az @ np.swapaxes(Az, -1, -2) + 0.5 * np.eye(NA)
    Hzu = rng.normal(size=(B, N, NA, NU)) * 0.1
    Au = rng.normal(size=(B, N, NU, NU))
    Huu = Au @ np.swapaxes(Au, -1, -2) + 0.5 * np.eye(NU)
    hz = rng.normal(size=(B, N, NA))
    hu = rng.normal(size=(B, N, NU))
    At = rng.normal(size=(B, NA, NA))
    PN = At @ np.swapaxes(At, -1, -2) + 0.5 * np.eye(NA)
    pN = rng.normal(size=(B, NA))
    reg = rng.uniform(1e-3, 1.0, size=(B,))
    Fz, Gz, rz = jax.vmap(lambda f, g, mm, rr: j_ric.build_augmented_transition(f, g, mm, rr, nu=NU))(
        F, G, m, r
    )
    return tuple(np.asarray(a) for a in (Fz, Gz, rz)) + (Hzz, Hzu, Huu, hz, hu, PN, pN, reg)


def _flagship_kkt(seed=0):
    """Riccati inputs of the first warm-settings SQP iteration of the flagship
    at N=8 from the straight-line seed (built by the port; the KKT assembly
    itself is covered end to end by the solve parity tests)."""
    jspec = j_config3(N=8, obstacle_cap=4)
    tspec = t_config3(N=8, obstacle_cap=4)
    js = j_random_ensemble(jspec, 4, jax.random.PRNGKey(seed), dtype=jnp.float64)
    arrays = {f: np.asarray(getattr(js, f)) for f in ("x0", "xf", "via_points", "via_mask", "u_prev")}
    arrays["obstacles"] = {k: np.asarray(v) for k, v in vars(js.obstacles).items()}
    ts = convert.from_numpy(TScenario, arrays, "cpu")
    st = t_al.SolverSettings(rho0=120.0, reg0=1.0)
    init, duals = t_al.default_init(tspec, st, ts, dtype=torch.float64)
    obs_k = t_al._stage_obstacles(tspec, ts, init.dt, tspec.N + 1)
    kkt = t_al._kkt_system(
        tspec, t_al._make_stage_fns(tspec), t_al._make_terminal_fns(tspec), init, ts, duals, obs_k
    )
    return tuple(a.numpy() for a in kkt) + (np.full((4,), 1.0),)


def _compare(data, dtype, free_tau):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j_out = jax.vmap(lambda *a: j_ric.lqr_solve(*a, nx=NX, free_tau=free_tau))(
        *(jnp.asarray(a, jdt) for a in data)
    )
    targs = tuple(torch.from_numpy(np.array(a)).to(dtype) for a in data)
    t_out = t_ric.lqr_solve(*targs, nx=NX, free_tau=free_tau)
    before = riccati_cuda.lqr_solve_cuda.launches
    t_auto = riccati_cuda.lqr_solve_auto(*targs, nx=NX, free_tau=free_tau)
    assert riccati_cuda.lqr_solve_cuda.launches == before  # CPU: the plain version
    for a, b, c in zip(t_out, t_auto, j_out):
        assert a.dtype == dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        ref = np.asarray(c, np.float64)
        if dtype == torch.float64:
            np.testing.assert_allclose(a.numpy(), ref, atol=1e-10, rtol=0)
        else:
            scale = max(np.max(np.abs(ref)), 1e-30)
            assert np.max(np.abs(a.numpy() - ref)) <= F32_RTOL * scale
    if not free_tau:
        assert np.all(t_out.dtau.numpy() == 0.0)


@pytest.mark.parametrize("free_tau", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_lqr_solve_random_qps(dtype, free_tau):
    _compare(_random_qps(7), dtype, free_tau)


@pytest.mark.parametrize("free_tau", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_lqr_solve_flagship_iteration(dtype, free_tau):
    _compare(_flagship_kkt(), dtype, free_tau)


def test_torch_build_augmented_transition():
    rng = np.random.default_rng(3)
    F, G = rng.normal(size=(B, N, NX, NX)), rng.normal(size=(B, N, NX, NU))
    m, r = rng.normal(size=(B, N, NX)), rng.normal(size=(B, N, NX))
    j = jax.vmap(lambda *a: j_ric.build_augmented_transition(*a, nu=NU))(F, G, m, r)
    t = t_ric.build_augmented_transition(
        *(torch.from_numpy(a) for a in (F, G, m, r)), nu=NU
    )
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_torch_smallmat_inverses_and_solves():
    rng = np.random.default_rng(4)
    A2 = rng.normal(size=(5, 2, 2)) + 3 * np.eye(2)
    A3 = rng.normal(size=(5, 3, 3)) + 3 * np.eye(3)
    S4 = rng.normal(size=(5, 4, 4))
    S4 = S4 @ np.swapaxes(S4, -1, -2) + np.eye(4)
    b2, b3, b4 = rng.normal(size=(5, 2, 3)), rng.normal(size=(5, 3)), rng.normal(size=(5, 4, 2))
    T = torch.from_numpy
    np.testing.assert_allclose(t_sm.inv2(T(A2)).numpy(), j_sm.inv2(A2), atol=1e-12, rtol=0)
    np.testing.assert_allclose(t_sm.inv3(T(A3)).numpy(), j_sm.inv3(A3), atol=1e-12, rtol=0)
    np.testing.assert_allclose(t_sm.solve_psd(T(A2), T(b2)).numpy(), j_sm.solve_psd(A2, b2), atol=1e-12, rtol=0)
    np.testing.assert_allclose(t_sm.solve_psd(T(A3), T(b3)).numpy(), j_sm.solve_psd(A3, b3), atol=1e-12, rtol=0)
    np.testing.assert_allclose(t_sm.solve_psd(T(S4), T(b4)).numpy(), j_sm.solve_psd(S4, b4), atol=1e-10, rtol=0)


def test_torch_k1_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    args = [torch.from_numpy(np.array(a)) for a in _random_qps(5)]
    with pytest.raises(ValueError, match="CUDA"):
        riccati_cuda.lqr_solve_cuda(*args, nx=NX, free_tau=True)
    wide = list(args)
    wide[1] = torch.zeros(B, N, NA, 3, dtype=torch.float64)  # nu = 3
    with pytest.raises(ValueError, match="nu=2"):
        riccati_cuda.lqr_solve_cuda(*wide, nx=NX, free_tau=True)
    with pytest.raises(ValueError, match="nx=3"):
        riccati_cuda.lqr_solve_cuda(*args, nx=2, free_tau=True)
    mixed = list(args)
    mixed[3] = torch.empty((B, N, NA, NA), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        riccati_cuda.lqr_solve_auto(*mixed, nx=NX, free_tau=True)
    # no toolkit: the build raises, nothing falls back
    monkeypatch.setattr(nvcc_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setattr(riccati_cuda, "library_path", lambda: nvcc_build.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        riccati_cuda.build()
