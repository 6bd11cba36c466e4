"""A negative hybrid time weight: admitted and solved as a weight of 0.

The JAX spec admits any ``hybrid_time_weight`` and every use gates on a
weight above 0, so a YAML's negative ``hybrid_cost_minimum_time`` solves as
0 there. The port does the same: on config #2 (N=8, 2 obstacle slots) at
weight −0.2 its solve equals its solve at weight 0 bit for bit, on the
un-fused path and on the fused kernel's plain version, and matches JAX
``vmap(solve_single)`` at the f64 parity tolerance (1e-9 on every lane; the
two differ by rounding only).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.solvers import al_sqp as j_al

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.solvers import al_sqp

B = 6
WARM = dict(n_al=4, n_sqp=6, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
            alphas=(1.0, 0.5, 0.22))
TOL = 1e-9


def _np(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: _np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _jax_case():
    jspec = dataclasses.replace(jb.config2_diffdrive_obstacles(N=8, obstacle_cap=2),
                                hybrid_time_weight=-0.2)
    scen = jb.random_ensemble(jspec, B, jax.random.PRNGKey(5), dtype=jnp.float64)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.4 * (scen.xf - scen.x0))
    jst = j_al.SolverSettings(**WARM)
    init = j_initial_primal(jspec, scen)
    duals = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape), j_al.init_duals(jspec, jst, jnp.float64))
    out = jax.vmap(lambda s, i, d: j_al.solve_single(jspec, jst, s, i, d))(scen, init, duals)
    return _np(scen), _np(init), _np(duals), _np(out)


def _solve(weight, path):
    scen, init, duals, _ = _jax_case()
    spec = dataclasses.replace(tb.config2_diffdrive_obstacles(N=8, obstacle_cap=2),
                               hybrid_time_weight=weight)
    st = al_sqp.SolverSettings(**WARM)
    args = (convert.from_numpy(Scenario, scen, "cpu"), convert.from_numpy(Primal, init, "cpu"),
            convert.from_numpy(al_sqp.DualState, duals, "cpu"))
    if path == "unfused":
        return al_sqp.make_solver(spec, st, device="cpu")(*args)
    return k2a.fused_solve_plain(spec, st, *args)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("path", ["unfused", "fused_plain"])
def test_torch_negative_hybrid_weight_solves_as_weight_zero_bit_for_bit(path):
    neg = convert.to_numpy(_solve(-0.2, path))
    zero = convert.to_numpy(_solve(0.0, path))
    for (name, a), (_, b) in zip(_leaves(neg), _leaves(zero)):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_torch_negative_hybrid_weight_matches_jax():
    *_, j = _jax_case()
    t = convert.to_numpy(_solve(-0.2, "unfused"))
    np.testing.assert_array_equal(t["converged"], j["converged"])
    assert t["converged"].any()
    for (name, a), (_, b) in zip(_leaves(t), _leaves(j)):
        if a.dtype == np.bool_:
            continue
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=name)
