"""Kernel K2a (``csrc/fused_al_sqp.cu``) against its plain PyTorch version
(``fused_solve_plain``), on the card.

K2a has no CPU or interpret mode, so these tests skip without a CUDA card.
This file imports neither JAX nor the JAX package, so that it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_k2a_gpu.py

Both versions start from one warm state, built as the fleet cycle builds
the next warm solve's inputs from a cold solve. Tolerances
(``solvers/agreement.py``):
- float64, at the whole budget and after one SQP iteration: conv flags
  identical on every lane; max relative |Δ| (over xs, us, dt and the duals,
  relative to max(|plain|, 1)) ≤ 1e-8 on at least 99.5% of the lanes both
  converged; on every lane at most 100 times the plain version's own change
  under a one-ulp change of its states, plus 1e-12, where that change is
  below 1e-6 (on every lane after one iteration).
- float32: the bench gate's semantics (bench.py): conv flags agree on
  99.5% of lanes, a quarter of the lanes converged on both, max |Δxs| on
  those ≤ 5e-2 at 12 iterations and 1e-1 at 16.
"""

import dataclasses

import pytest
import torch

from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time, random_ensemble
from mpc_local_planner_tpu_torch.geometry.footprints import PointFootprint
from mpc_local_planner_tpu_torch.ocp.grid import warm_start_resample
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp

WARM = dict(
    n_al=3, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3, alphas=(1.0, 0.5, 0.22)
)
RESCUE = dict(WARM, n_al=4, alphas=(1.0, 0.7, 0.5, 0.35, 0.22, 0.14, 0.08, 0.03))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K2a has no CPU or interpret mode")
    return torch.device("cuda", 0)


def _warm_state(dev, dtype, settings, batch=300, spec=None, seed=1):
    """300 lanes (not a multiple of the 32-thread block: the ragged last
    block is exercised) in the state of the fleet cycle's next warm solve:
    a cold solve (the plain version at the cold preset), then converged
    lanes advanced one stage, the primal resampled and the duals shifted."""
    spec = spec or config3_carlike_min_time(N=30, obstacle_cap=8)
    st = al_sqp.SolverSettings(**settings)
    cold = al_sqp.SolverSettings.for_spec(spec)
    gen = torch.Generator().manual_seed(seed)
    scen = random_ensemble(spec, batch, gen, dtype=dtype, device=dev)
    init, duals = al_sqp.default_init(spec, cold, scen, dtype=dtype)
    r = k2a.fused_solve_plain(spec, cold, scen, init, duals)
    x0n = torch.where(r.converged[:, None], r.primal.xs[:, 1, :], scen.x0)
    init = warm_start_resample(r.primal, x0n, steps=1, spec=spec)
    duals = al_sqp.shift_duals(r.duals, st, steps=1)
    return spec, st, dataclasses.replace(scen, x0=x0n), init, duals


def _check_f64(spec, st, scen, init, duals):
    """agreement.f64_agreement at the whole budget and after one SQP
    iteration, before rounding can grow on any lane."""
    perturbed = agreement.ulp_perturbed(init)
    for sp, short in ((st, False), (dataclasses.replace(st, n_al=1, n_sqp=1), True)):
        before = k2a.fused_solve_cuda.launches
        out_k = k2a.fused_solve_cuda(spec, sp, scen, init, duals)
        assert k2a.fused_solve_cuda.launches == before + 1
        out_p = k2a.fused_solve_plain(spec, sp, scen, init, duals)
        outs_q = [k2a.fused_solve_plain(spec, sp, scen, q, duals) for q in perturbed]
        torch.cuda.synchronize()
        assert out_k.primal.xs.dtype == torch.float64
        info, passed, _, _ = agreement.f64_agreement(
            out_k, out_p, outs_q, 0.0 if short else 0.25, every_lane=short
        )
        assert passed, info


def _check_f32(spec, st, scen, init, duals):
    out_k = k2a.fused_solve_cuda(spec, st, scen, init, duals)
    out_p = k2a.fused_solve_plain(spec, st, scen, init, duals)
    torch.cuda.synchronize()
    info, passed = agreement.gate(out_k, out_p, st.n_al * st.n_sqp)
    assert passed, info
    both = out_k.converged & out_p.converged
    assert bool(torch.isfinite(out_k.primal.xs[both]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("settings", [WARM, RESCUE], ids=["warm3x4", "rescue4x4"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_k2a_kernel_matches_plain_on_the_flagship(dtype, settings):
    args = _warm_state(_card(), dtype, settings)
    (_check_f64 if dtype == torch.float64 else _check_f32)(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [0, 3])
def test_torch_k2a_kernel_matches_plain_on_a_point_footprint_with_a_free_heading(M):
    spec = dataclasses.replace(
        config3_carlike_min_time(N=12, obstacle_cap=M), footprint=PointFootprint(),
        xf_fixed=(True, True, False),
    )
    _check_f64(*_warm_state(_card(), torch.float64, dict(WARM, n_al=2, n_sqp=3), spec=spec))


@pytest.mark.gpu
def test_torch_make_solver_launches_k2a_for_the_warm_solve():
    dev = _card()
    spec, st, scen, init, duals = _warm_state(dev, torch.float32, WARM, batch=64)
    before = k2a.fused_solve_cuda.launches
    al_sqp.make_solver(spec, st, dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1
    al_sqp.make_solver(spec, dataclasses.replace(st, fused="off"), dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1


@pytest.mark.gpu
def test_torch_k2a_kernel_refuses_what_it_does_not_take():
    dev = _card()
    spec, st, scen, init, duals = _warm_state(dev, torch.float32, WARM, batch=8)
    cpu = lambda t: al_sqp.tree_map(lambda a: a.cpu(), t)  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        k2a.fused_solve_cuda(spec, st, cpu(scen), cpu(init), cpu(duals))
    short = dataclasses.replace(duals, mu_obs=duals.mu_obs[:, :, :2])
    with pytest.raises(ValueError, match="mu_obs has shape"):
        k2a.fused_solve_cuda(spec, st, scen, init, short)
    with pytest.raises(NotImplementedError, match="terminal ball"):
        k2a.fused_solve_cuda(dataclasses.replace(spec, ball_radius=0.5), st, scen, init, duals)
    strided = dataclasses.replace(init, us=init.us.mT.contiguous().mT)
    with pytest.raises(ValueError, match="us is not contiguous"):
        k2a.fused_solve_cuda(spec, st, scen, strided, duals)
