"""The Levenberg–Marquardt solver (``solver.type: lsq_lm``) on the port
against JAX ``vmap(solve_single_lm)`` (CPU, float64), and its least-squares
forms against ``total_cost``.

Tolerance: 1e-8 absolute on every lane's primal, cost and norms, the conv
flags equal (the two do the same arithmetic in another order; measured
≤ 2e-14). The objective residuals satisfy ½‖r‖² = total_cost to 1e-12 on
every form the JAX solver casts: the quadratic form (plain, integral
left-sum and trapezoidal on the uniform and the non-uniform grid, hybrid
time weight, Qf), minimum time and via points with an orientation weight.
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
from mpc_local_planner_tpu.solvers.lsq_lm import solve_single_lm as j_lm

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ocp.costs import total_cost
from mpc_local_planner_tpu_torch.ocp.grid import Primal, initial_primal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.solvers import al_sqp
from mpc_local_planner_tpu_torch.solvers.lsq_lm import _objective_residuals, solve_single_lm

B, N = 4, 8
LM = dict(n_al=3, n_sqp=6, rho0=10.0, tol_eq=1e-3, tol_ineq=1e-3)
TOL = 1e-8
QUAD = dict(integral_form=True, cost_integration="trapezoidal", hybrid_time_weight=0.5,
            variable_dt=True, dt_min=1e-3, dt_max=0.5)


def np_tree(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: np_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def spec_pair(case):
    if case == "flagship":
        return jb.config3_carlike_min_time(N=N, obstacle_cap=2), \
            tb.config3_carlike_min_time(N=N, obstacle_cap=2)
    if case == "quadratic":
        return (dataclasses.replace(jb.config2_diffdrive_obstacles(N=N, obstacle_cap=2), **QUAD),
                dataclasses.replace(tb.config2_diffdrive_obstacles(N=N, obstacle_cap=2), **QUAD))
    return jb.family_spec("via_points", N=N), tb.family_spec("via_points", N=N)


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    jspec, _ = spec_pair(case)
    key = jax.random.PRNGKey(3)
    if case == "via":
        scen = jb.family_ensemble("via_points", jspec, B, key, dtype=jnp.float64)
    else:
        scen = jb.random_ensemble(jspec, B, key, dtype=jnp.float64, goal_radius=1.1)
    jst = j_al.SolverSettings(**LM)
    init = j_initial_primal(jspec, scen)
    duals = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                   j_al.init_duals(jspec, jst, jnp.float64))
    out = jax.jit(jax.vmap(lambda s, i, d: j_lm(jspec, jst, s, i, d)))(scen, init, duals)
    return np_tree(scen), np_tree(init), np_tree(duals), np_tree(out)


@pytest.mark.parametrize("case", ["flagship", "quadratic", "via"])
def test_torch_lsq_lm_matches_jax(case):
    scen, init, duals, j = _jax_case(case)
    _, tspec = spec_pair(case)
    t = convert.to_numpy(solve_single_lm(
        tspec, al_sqp.SolverSettings(**LM), convert.from_numpy(Scenario, scen, "cpu"),
        convert.from_numpy(Primal, init, "cpu"), convert.from_numpy(al_sqp.DualState, duals,
                                                                    "cpu")))
    np.testing.assert_array_equal(t["converged"], j["converged"])
    for k in ("xs", "us", "dt"):
        np.testing.assert_allclose(t["primal"][k], j["primal"][k], atol=TOL, rtol=0, err_msg=k)
    for k in ("cost", "eq_norm", "ineq_viol"):
        np.testing.assert_allclose(t[k], j[k], atol=TOL, rtol=0, err_msg=k)
    # the duals pass through untouched
    for k, v in t["duals"].items():
        np.testing.assert_array_equal(v, duals[k])


FORMS = {
    "plain-qf": dict(),
    "left-sum": dict(integral_form=True),
    "trapezoidal-hybrid": QUAD,
    "nonuniform-trapezoidal": dict(QUAD, nonuniform_dt=True),
    "nonuniform-left-sum": dict(integral_form=True, variable_dt=True, nonuniform_dt=True),
}


@pytest.mark.parametrize("form", list(FORMS) + ["min-time", "min-time-nonuniform", "via"])
def test_torch_lsq_objective_residuals_square_to_the_cost(form):
    if form in FORMS:
        spec = dataclasses.replace(tb.config2_diffdrive_obstacles(N=N, obstacle_cap=2),
                                   **FORMS[form])
    elif form == "via":
        spec = dataclasses.replace(tb.family_spec("via_points", N=N),
                                   via_orientation_weight=0.7)
    else:
        spec = tb.family_spec("nonuniform" if form.endswith("nonuniform") else "flagship", N=N)
    gen = torch.Generator().manual_seed(1)
    scen = (tb.family_ensemble("via_points", spec, 5, gen, dtype=torch.float64, device="cpu")
            if form == "via" else
            tb.random_ensemble(spec, 5, gen, dtype=torch.float64, device="cpu"))
    p = initial_primal(spec, scen)
    rng = np.random.default_rng(0)
    p = Primal(xs=p.xs + torch.from_numpy(0.2 * rng.normal(size=p.xs.shape)),
               us=p.us + torch.from_numpy(0.2 * rng.normal(size=p.us.shape)),
               dt=p.dt * torch.from_numpy(rng.uniform(0.5, 1.5, size=p.dt.shape)))
    r = _objective_residuals(spec, p, scen)
    np.testing.assert_allclose((0.5 * torch.sum(r * r, dim=-1)).numpy(),
                               total_cost(spec, p.xs, p.us, p.dt, scen).numpy(),
                               atol=1e-12, rtol=1e-12)
