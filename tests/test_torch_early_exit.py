"""``SolverSettings.early_exit`` on the port against JAX ``vmap(solve_single)``
(CPU, float64).

JAX's ``while_loop`` under ``vmap`` runs until every lane's condition is
false and keeps a finished lane's state unchanged; the port runs its AL
phases while any lane is active and freezes each finished lane. The batch
below converges its lanes at different phases. Tolerance: 1e-9 absolute on
every lane and every leaf (the two differ by rounding only), the conv flags
equal.
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

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.solvers import al_sqp

B, N = 8, 8
SETTINGS = dict(n_al=6, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
                alphas=(1.0, 0.5, 0.22))
TOL = 1e-9


def np_tree(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: np_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _case():
    """Inputs whose lanes converge at different AL phases: goals pulled in
    to between 15% and 60% of their distance."""
    jspec = jb.config3_carlike_min_time(N=N, obstacle_cap=3)
    scen = jb.random_ensemble(jspec, B, jax.random.PRNGKey(4), dtype=jnp.float64)
    pull = jnp.linspace(0.15, 0.6, B)[:, None]
    scen = dataclasses.replace(scen, xf=scen.x0 + pull * (scen.xf - scen.x0))
    init = j_initial_primal(jspec, scen)
    out = {}
    for ee in (False, True):
        jst = j_al.SolverSettings(**SETTINGS, early_exit=ee)
        duals = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                       j_al.init_duals(jspec, jst, jnp.float64))
        out[ee] = np_tree(jax.jit(jax.vmap(
            lambda s, i, d, jst=jst: j_al.solve_single(jspec, jst, s, i, d)))(scen, init, duals))
    return np_tree(scen), np_tree(init), np_tree(duals), out


def _port(early_exit, kkt="auto", n_al=SETTINGS["n_al"]):
    scen, init, duals, _ = _case()
    st = al_sqp.SolverSettings(**dict(SETTINGS, n_al=n_al), early_exit=early_exit, kkt=kkt)
    solve = al_sqp.make_solver(tb.config3_carlike_min_time(N=N, obstacle_cap=3), st,
                               device="cpu")
    return solve(convert.from_numpy(Scenario, scen, "cpu"),
                 convert.from_numpy(Primal, init, "cpu"),
                 convert.from_numpy(al_sqp.DualState, duals, "cpu"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _assert_close(t, j):
    np.testing.assert_array_equal(t["converged"], j["converged"])
    for (name, a), (_, b) in zip(_leaves(t), _leaves(j)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("early_exit", [False, True])
def test_torch_early_exit_matches_jax(early_exit):
    *_, j = _case()
    t = convert.to_numpy(_port(early_exit))
    _assert_close(t, j[early_exit])
    conv = t["converged"]
    assert 0 < conv.sum() < B  # a mix
    if early_exit:
        assert (t["eq_norm"][conv] < 1e-3).all() and (t["ineq_viol"][conv] < 1e-3).all()


def test_torch_early_exit_freezes_each_lane_at_its_phase():
    """A lane converged at the end of phase k returns the phase-k state: the
    early-exit result equals the fixed schedule cut at that lane's phase,
    and the lanes finish at different phases."""
    ee = convert.to_numpy(_port(True))
    cut = [convert.to_numpy(_port(False, n_al=k)) for k in range(1, SETTINGS["n_al"] + 1)]
    phase = np.full(B, SETTINGS["n_al"])
    for k in reversed(range(SETTINGS["n_al"])):
        phase[cut[k]["converged"]] = k + 1
    assert len(set(phase[ee["converged"]])) >= 2, phase
    for b in range(B):
        want = cut[phase[b] - 1]
        for (name, a), (_, w) in zip(_leaves(ee), _leaves(want)):
            np.testing.assert_array_equal(a[b], w[b], err_msg=f"lane {b} {name}")


def test_torch_early_exit_with_every_lane_converged_stops_at_once():
    scen, init, duals, _ = _case()
    spec = tb.config3_carlike_min_time(N=N, obstacle_cap=3)
    st = al_sqp.SolverSettings(**SETTINGS, early_exit=True)
    args = (convert.from_numpy(Scenario, scen, "cpu"), convert.from_numpy(Primal, init, "cpu"),
            convert.from_numpy(al_sqp.DualState, duals, "cpu"))
    r = al_sqp.make_solver(spec, st, device="cpu")(*args)
    ok = r.converged
    sub = tree_map(lambda a: a[ok], args)
    again = al_sqp.make_solver(spec, st, device="cpu")(sub[0], tree_map(
        lambda a: a[ok], r.primal), tree_map(lambda a: a[ok], r.duals))
    assert bool(again.converged.all())


def test_torch_early_exit_never_dispatches_fused():
    spec = tb.config3_carlike_min_time(N=N, obstacle_cap=4)
    scen = tb.random_ensemble(spec, 4, torch.Generator().manual_seed(0), device="cpu")
    base = al_sqp.SolverSettings(n_al=3, n_sqp=4)
    # every other gate passes on a CUDA device (the decision is a predicate)
    assert al_sqp.fused_dispatch_ok(spec, base, scen, torch.float32, "cuda")
    ee = dataclasses.replace(base, early_exit=True)
    assert not al_sqp.fused_dispatch_ok(spec, ee, scen, torch.float32, "cuda")
