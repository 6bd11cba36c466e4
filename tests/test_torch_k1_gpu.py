"""Kernel K1 (``csrc/riccati_sweep.cu``) against its plain PyTorch version,
on the card.

K1 has no CPU or interpret mode, so these tests skip without a CUDA card.
This file imports neither JAX nor the JAX package, so that it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_k1_gpu.py

The horizon has no cap: the random QPs run up to N = 257, where the stage
data passes through the ring of chunks and the gain tape through the
workspace (``riccati_cuda.launch_geometry``, pinned on the CPU in
``tests/test_torch_k1_launch.py`` and held to the library's here). The
cases take batches that are not a multiple of a block's scenarios, odd N,
inputs that start 4 (float32) or 8 (float64) bytes past a 16-byte boundary,
and a lane whose inputs overflow among block-mates that do not.

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


def _check(args, dtype, free_tau, lanes=None):
    """The kernel against the plain version on ``args`` in ``dtype``; only
    on ``lanes`` where given (the plain version's finite lanes)."""
    args = tuple(a.to(dtype) for a in args)
    before = riccati_cuda.lqr_solve_cuda.launches
    k = riccati_cuda.lqr_solve_auto(*args, nx=NX, free_tau=free_tau)
    assert riccati_cuda.lqr_solve_cuda.launches == before + 1
    p = lqr_solve(*args, nx=NX, free_tau=free_tau)
    torch.cuda.synchronize()
    for name, a, b in zip(k._fields, k, p):
        assert a.dtype == dtype and a.shape == b.shape, name
        if lanes is not None:
            a, b = a[lanes], b[lanes]
        assert bool(torch.isfinite(a).all()), name
        scale = max(torch.max(torch.abs(b)).item(), 1e-30)
        assert torch.max(torch.abs(a - b)).item() <= RTOL[dtype] * scale, name
    if not free_tau:
        assert bool((k.dtau == 0).all())
    return k, p


def _shifted(t):
    """``t``'s values in a contiguous view that starts one element into a
    flat buffer: 4 (float32) or 8 (float64) bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("free_tau", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_k1_kernel_matches_plain_on_flagship_kkt(dtype, free_tau):
    # 301 lanes: not a multiple of a block's scenarios, so the ragged
    # last block is exercised
    _check(_flagship_kkt(301, 30, _card()), dtype, free_tau)


@pytest.mark.gpu
@pytest.mark.parametrize("batch, N", [(1, 1), (3, 6), (129, 64), (5, 65), (33, 120),
                                      (1, 30), (7, 3), (9, 31), (5, 257)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_k1_kernel_matches_plain_on_random_qps(dtype, batch, N):
    # batches of 1, 7, 9 and 33 leave the last block ragged; N = 257 runs
    # the ring and the workspace
    _check(_random_qps(batch, N, _card()), dtype, True)
    if N == 257:
        geo = riccati_cuda.launch_geometry(N, dtype)
        assert geo.chunk * geo.slots < N and geo.workspace > 0


@pytest.mark.gpu
@pytest.mark.parametrize("N", [3, 31])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_k1_kernel_matches_plain_without_the_free_dtau(dtype, N):
    _check(_random_qps(6, N, _card(), seed=9), dtype, False)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_k1_kernel_takes_inputs_at_any_element_offset(dtype):
    """Views t[1:] of a larger batch (offsets of a whole scenario) and views
    one element into a flat buffer (every input 4 or 8 bytes past a 16-byte
    boundary): the spans' heads and tails take the element-sized copies."""
    big = tuple(a.to(dtype) for a in _random_qps(10, 31, _card(), seed=3))
    views = tuple(a[1:] for a in big)
    assert all(v.is_contiguous() for v in views)
    _check(views, dtype, True)
    shifted = tuple(_shifted(a) for a in big)
    assert {v.data_ptr() % 16 for v in shifted} == {4 if dtype == torch.float32 else 8}
    _check(shifted, dtype, True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_k1_overflow_stays_on_its_lane(dtype):
    """A lane whose inputs overflow is non-finite exactly where the plain
    version is, and its block-mates (the lanes of the same block) agree
    with the plain version as if it were not there."""
    args = [a.to(dtype).clone() for a in _random_qps(9, 30, _card(), seed=5)]
    args[3][4, 10, 0, 0] = float("inf")  # Hzz of lane 4, stage 10
    args[0][6, 29, 1, 1] = float("nan")  # Fz of lane 6, the first stage swept
    k = riccati_cuda.lqr_solve_cuda(*args, nx=NX, free_tau=True)
    p = lqr_solve(*args, nx=NX, free_tau=True)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        finite = lambda t: torch.isfinite(t.reshape(t.shape[0], -1)).all(dim=1)  # noqa: E731
        assert torch.equal(finite(a), finite(b))
    bad = [b for b in range(9) if not bool(torch.isfinite(k.dxs[b]).all())]
    assert bad == [4, 6]
    _check(tuple(args), dtype, True, lanes=[b for b in range(9) if b not in bad])


@pytest.mark.gpu
def test_torch_k1_launch_geometry_matches_the_library():
    """``launch_geometry`` against the library's own
    ``riccati_sweep_launch_geometry``; the shared bytes within a block's
    227 KB, and every launch's blocks per SM at least one."""
    _card()
    lib = riccati_cuda._load()
    assert lib.design == riccati_cuda.DESIGN
    for N in (1, 3, 30, 31, 96, 120, 257, 1000):
        for dtype in (torch.float32, torch.float64):
            geo = riccati_cuda.library_geometry(lib, N, dtype)
            assert geo == riccati_cuda.launch_geometry(N, dtype), (N, dtype)
            assert geo.shared_bytes <= riccati_cuda.BLOCK_SMEM
            assert riccati_cuda.occupancy(lib, N, dtype) >= 1, (N, dtype)


@pytest.mark.gpu
def test_torch_k1_kernel_refuses_what_it_does_not_take():
    args = list(_random_qps(3, 6, _card()))
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
