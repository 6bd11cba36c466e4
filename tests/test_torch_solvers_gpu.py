"""The solver tier beyond the fused kernel on the card: the horizon-parallel
Riccati solve, ``early_exit`` and the float64 straggler tier, each on CUDA
tensors against the same function on the CPU.

These run the hand-written kernel K1 (the un-fused solves' KKT solve on the
card), so they skip without a CUDA card. This file imports neither JAX nor
the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_solvers_gpu.py

Tolerances: the pscan against ``lqr_solve`` on the card 1e-9 relative to the
step's largest entry in float64 and 1e-4 in float32 (K1's); the float64
solves on the card against the CPU's: bench.py's gate (the conv flags equal
on at least 99.5% of the lanes, a quarter converged on both, max |Δxs| on
those within the bound of the budget). Under ``early_exit`` a lane stops at
the first AL phase that leaves it within the tolerance, so a lane whose
violation lands within rounding of it on one device stops a phase apart
from the other (measured on the H100: 9.2e-6 on the float64 tier's lanes).
"""

import dataclasses

import pytest
import torch

from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time, random_ensemble
from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp
from mpc_local_planner_tpu_torch.solvers.f64_fallback import make_f64_fallback
from mpc_local_planner_tpu_torch.solvers.riccati import lqr_solve
from mpc_local_planner_tpu_torch.solvers.riccati_pscan import lqr_solve_pscan

pytestmark = pytest.mark.gpu
RTOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the solves' KKT kernel K1 has no CPU mode")
    return torch.device("cuda", 0)


def _kkt(batch, N, dev, dtype):
    spec = config3_carlike_min_time(N=N, obstacle_cap=8)
    st = al_sqp.SolverSettings(rho0=120.0, reg0=1.0)
    scen = random_ensemble(spec, batch, torch.Generator().manual_seed(1), dtype=dtype,
                           device=dev)
    init, duals = al_sqp.default_init(spec, st, scen, dtype=dtype)
    obs_k = al_sqp._stage_obstacles(spec, scen, init.dt, spec.N + 1)
    kkt = al_sqp._kkt_system(spec, al_sqp._make_stage_fns(spec), al_sqp._make_terminal_fns(spec),
                             init, scen, duals, obs_k)
    return kkt + (torch.full_like(init.dt, st.reg0),)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("batch, N", [(4096, 30), (300, 7), (17, 65)])
def test_torch_pscan_on_the_card_matches_lqr_solve(batch, N, dtype):
    dev = _card()
    args = _kkt(batch, N, dev, dtype)
    got = lqr_solve_pscan(*args, nx=3, free_tau=True)
    want = lqr_solve(*args, nx=3, free_tau=True)
    for name, g, w in zip(got._fields, got, want):
        assert g.device.type == "cuda" and g.dtype == dtype
        err = (g.double() - w.double()).abs().max() / w.double().abs().max().clamp(min=1e-30)
        assert float(err) <= RTOL[dtype], (name, float(err))


def _problem(dev, batch=300, dtype=torch.float64):
    spec = config3_carlike_min_time(N=12, obstacle_cap=4)
    scen = random_ensemble(spec, batch, torch.Generator().manual_seed(3), dtype=dtype,
                           device=dev)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.4 * (scen.xf - scen.x0))
    return spec, scen


def _agree(a, b, iters):
    a, b = tree_map(lambda t: t.cpu(), a), tree_map(lambda t: t.cpu(), b)
    info, passed = agreement.gate(a, b, iters)
    assert passed, info


def test_torch_early_exit_on_the_card_matches_the_cpu():
    dev = _card()
    spec, scen = _problem(dev)
    st = al_sqp.SolverSettings(n_al=6, n_sqp=5, rho0=120.0, reg0=1.0, tol_eq=1e-3,
                               tol_ineq=1e-3, alphas=(1.0, 0.5, 0.22), early_exit=True)
    init, duals = al_sqp.default_init(spec, st, scen, dtype=torch.float64)
    before = riccati_cuda.lqr_solve_cuda.launches
    card = al_sqp.make_solver(spec, st, dev)(scen, init, duals)
    assert riccati_cuda.lqr_solve_cuda.launches > before  # K1 carried the KKT solves
    on_cpu = tree_map(lambda t: t.cpu(), (scen, init, duals))
    _agree(card, al_sqp.make_solver(spec, st, "cpu")(*on_cpu), st.n_al * st.n_sqp)


def test_torch_f64_tier_on_the_card_matches_the_cpu():
    dev = _card()
    spec, scen = _problem(dev, dtype=torch.float32)
    warm = al_sqp.SolverSettings(n_al=2, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3,
                                 tol_ineq=1e-3, alphas=(1.0, 0.5, 0.22), fused="off")
    init, duals = al_sqp.default_init(spec, warm, scen)
    r = al_sqp.make_solver(spec, warm, dev)(scen, init, duals)
    tier = al_sqp.SolverSettings.for_spec(spec, n_al=6, n_sqp=8, tol_eq=1e-3, tol_ineq=1e-3,
                                          early_exit=True)
    card = make_f64_fallback(spec, tier, slots=256, device=dev)(scen, r)
    assert card.primal.xs.device.type == "cuda" and card.primal.xs.dtype == torch.float32
    assert not bool((r.converged & ~card.converged).any())
    assert int(card.converged.sum()) > int(r.converged.sum())
    kept = ~card.converged | r.converged
    assert torch.equal(card.primal.xs[kept], r.primal.xs[kept])
    on_cpu = tree_map(lambda t: t.cpu(), (scen, r))
    cpu = make_f64_fallback(spec, tier, slots=256, device="cpu")(*on_cpu)
    _agree(card, cpu, tier.n_al * tier.n_sqp)
