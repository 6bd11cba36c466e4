"""The float64 golden solver (scipy SLSQP) and the feasibility classifier
against the JAX package's (CPU).

``solve_golden``: the same problem from the same init; where both report
success the solutions agree within 1e-6 (two SLSQP runs whose Jacobians
differ by rounding only). ``classify_feasibility``: the same labels as JAX
on the ensemble of the JAX package's own oracle test
(``tests/test_ensemble.py``: N=8, 2 obstacle slots, goals within 1.1 m, 4
instances, maxiter 300), and on the same instances with the goal buried in
an obstacle.
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
from mpc_local_planner_tpu.solvers.golden import solve_golden as j_golden

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.solvers.golden import solve_golden as t_golden

TOL = 1e-6


def np_tree(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: np_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _oracle_case():
    jspec = jb.config3_carlike_min_time(N=8, obstacle_cap=2)
    scen = jb.random_ensemble(jspec, 4, jax.random.PRNGKey(3), goal_radius=1.1)
    return jspec, tb.config3_carlike_min_time(N=8, obstacle_cap=2), scen


def _buried(scen):
    obs = scen.obstacles
    return dataclasses.replace(scen, obstacles=dataclasses.replace(
        obs,
        circles=jnp.broadcast_to(scen.xf[:, None, :2], obs.circles.shape),
        circle_radii=jnp.full_like(obs.circle_radii, 0.6),
        circle_mask=jnp.ones_like(obs.circle_mask),
    ))


@pytest.mark.parametrize("case", ["flagship", "config1"])
def test_torch_solve_golden_matches_jax_from_the_same_init(case):
    if case == "flagship":
        jspec, tspec, scen = _oracle_case()
    else:
        jspec, tspec = jb.config1_unicycle_quadratic(N=8), tb.config1_unicycle_quadratic(N=8)
        scen = jb.random_ensemble(jspec, 2, jax.random.PRNGKey(1), goal_radius=1.5)
    tscen = convert.from_numpy(Scenario, np_tree(scen), "cpu")
    init = j_initial_primal(jspec, scen)
    tinit = convert.from_numpy(Primal, np_tree(init), "cpu")
    both = 0
    for b in range(2):
        sj, rj = j_golden(jspec, jax.tree_util.tree_map(lambda a: a[b], scen),
                          init=jax.tree_util.tree_map(lambda a: a[b], init), maxiter=300)
        st, rt = t_golden(tspec, tree_map(lambda a: a[b], tscen),
                          init=tree_map(lambda a: a[b], tinit), maxiter=300)
        assert st.xs.dtype == torch.float64 and st.xs.shape == (9, 3)
        assert rt.success == rj.success
        if rt.success:
            both += 1
            for k in ("xs", "us", "dt"):
                np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(getattr(sj, k)),
                                           atol=TOL, rtol=0, err_msg=k)
    assert both >= 1


def test_torch_classify_feasibility_labels_match_jax():
    jspec, tspec, scen = _oracle_case()
    want, winfo = jb.classify_feasibility(jspec, scen, max_instances=4, maxiter=300)
    tscen = convert.from_numpy(Scenario, np_tree(scen), "cpu")
    assert tscen.x0.dtype == torch.float32  # the classifier casts to float64 itself
    got, info = tb.classify_feasibility(tspec, tscen, max_instances=4, maxiter=300,
                                        device="cpu")
    assert got == want and info["n"] == winfo["n"] == 4
    assert got.count("feasible") >= 3 and info["max_viol_on_feasible"] <= 1e-5
    for p, q in zip(info["per_instance"], winfo["per_instance"]):
        assert p["certified_by"] == q["certified_by"]
        # the float64 AL solves of both packages from the same inputs
        assert abs(p["al_viol"] - q["al_viol"]) <= 1e-9 + 1e-6 * q["al_viol"]
    # the goal buried inside an obstacle: no feasible point
    bad = _buried(scen)
    want_bad, _ = jb.classify_feasibility(jspec, bad, max_instances=2, maxiter=300)
    got_bad, _ = tb.classify_feasibility(
        tspec, convert.from_numpy(Scenario, np_tree(bad), "cpu"), max_instances=2,
        maxiter=300, device="cpu")
    assert got_bad == want_bad and got_bad.count("unknown") >= 1
