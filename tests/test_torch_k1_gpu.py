"""Kernel K1 (``csrc/riccati_sweep.cu``) against its plain PyTorch version,
on the card.

K1 has no CPU or interpret mode, so these tests skip without a CUDA card.
This file imports neither JAX nor the JAX package, so that it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_k1_gpu.py

Tolerance: max |kernel − plain| over each output ≤ rtol × its largest entry;
rtol 1e-9 in float64 (the same arithmetic in another order: a few ulps) and
1e-4 in float32 (the backward recursion amplifies f32 rounding by the
conditioning of Quu over the stages).
"""

import numpy as np
import pytest
import torch

from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time, random_ensemble
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.solvers import al_sqp
from mpc_local_planner_tpu_torch.solvers.riccati import build_augmented_transition, lqr_solve

NX, NU = 3, 2
NA = NX + NU + 1
RTOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K1 has no CPU or interpret mode")
    return torch.device("cuda", 0)


def _flagship_kkt(batch, N, dev):
    """The Riccati inputs of a warm-settings SQP iteration of the flagship
    from the straight-line seed."""
    spec = config3_carlike_min_time(N=N, obstacle_cap=8)
    st = al_sqp.SolverSettings(rho0=120.0, reg0=1.0)
    scen = random_ensemble(spec, batch, torch.Generator().manual_seed(1), device=dev)
    init, duals = al_sqp.default_init(spec, st, scen)
    obs_k = al_sqp._stage_obstacles(spec, scen, init.dt, spec.N + 1)
    kkt = al_sqp._kkt_system(
        spec, al_sqp._make_stage_fns(spec), al_sqp._make_terminal_fns(spec),
        init, scen, duals, obs_k,
    )
    return kkt + (torch.full_like(init.dt, st.reg0),)


def _random_qps(batch, N, dev, seed=7):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(batch, N, NX, NX)) * 0.1 + np.eye(NX)  # stable over 64 stages
    G = rng.normal(size=(batch, N, NX, NU)) * 0.5
    m = rng.normal(size=(batch, N, NX)) * 0.5
    r = rng.normal(size=(batch, N, NX)) * 0.3
    Az = rng.normal(size=(batch, N, NA, NA))
    Au = rng.normal(size=(batch, N, NU, NU))
    At = rng.normal(size=(batch, NA, NA))
    T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    Fz, Gz, rz = build_augmented_transition(T(F), T(G), T(m), T(r), nu=NU)
    return tuple(a.contiguous() for a in (Fz, Gz, rz)) + (
        T(Az @ np.swapaxes(Az, -1, -2) + 0.5 * np.eye(NA)),
        T(rng.normal(size=(batch, N, NA, NU)) * 0.1),
        T(Au @ np.swapaxes(Au, -1, -2) + 0.5 * np.eye(NU)),
        T(rng.normal(size=(batch, N, NA))),
        T(rng.normal(size=(batch, N, NU))),
        T(At @ np.swapaxes(At, -1, -2) + 0.5 * np.eye(NA)),
        T(rng.normal(size=(batch, NA))),
        T(rng.uniform(1e-3, 1.0, size=(batch,))),
    )


def _check(args, dtype, free_tau):
    args = tuple(a.to(dtype) for a in args)
    before = riccati_cuda.lqr_solve_cuda.launches
    k = riccati_cuda.lqr_solve_auto(*args, nx=NX, free_tau=free_tau)
    assert riccati_cuda.lqr_solve_cuda.launches == before + 1
    p = lqr_solve(*args, nx=NX, free_tau=free_tau)
    torch.cuda.synchronize()
    for name, a, b in zip(k._fields, k, p):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        scale = max(torch.max(torch.abs(b)).item(), 1e-30)
        assert torch.max(torch.abs(a - b)).item() <= RTOL[dtype] * scale, name
    if not free_tau:
        assert bool((k.dtau == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("free_tau", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_k1_kernel_matches_plain_on_flagship_kkt(dtype, free_tau):
    # 300 lanes: not a multiple of the 128-thread block, so the ragged
    # last block is exercised
    _check(_flagship_kkt(300, 30, _card()), dtype, free_tau)


@pytest.mark.gpu
@pytest.mark.parametrize("batch, N", [(1, 1), (3, 6), (129, 64)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_k1_kernel_matches_plain_on_random_qps(dtype, batch, N):
    _check(_random_qps(batch, N, _card()), dtype, True)


@pytest.mark.gpu
def test_torch_k1_kernel_refuses_what_it_does_not_take():
    args = list(_random_qps(3, 6, _card()))
    long = list(_random_qps(2, 65, args[0].device))
    with pytest.raises(ValueError, match="N <= 64"):
        riccati_cuda.lqr_solve_cuda(*long, nx=NX, free_tau=True)
    strided = list(args)
    strided[3] = args[3].mT.contiguous().mT  # same values, not contiguous
    with pytest.raises(ValueError, match="not contiguous"):
        riccati_cuda.lqr_solve_cuda(*strided, nx=NX, free_tau=True)
    mixed = list(args)
    mixed[0] = args[0].float()
    with pytest.raises(TypeError, match="Gz is torch.float64"):
        riccati_cuda.lqr_solve_cuda(*mixed, nx=NX, free_tau=True)
    on_cpu = list(args)
    on_cpu[5] = args[5].cpu()
    with pytest.raises(ValueError, match="several devices"):
        riccati_cuda.lqr_solve_auto(*on_cpu, nx=NX, free_tau=True)
