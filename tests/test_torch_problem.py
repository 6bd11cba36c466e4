"""The port's ``OcpFunctions`` (eq, ineq, the sizes, flatten, unflatten), the
plan seed ``primal_from_plan`` and ``lines_detour_plan`` against the JAX
package's (CPU).

The same inputs (JAX ensembles at N=8, random trajectories from a numpy
seed, handed over through numpy) go through both packages. The JAX
constraint evaluators take one lane, so they run under ``vmap``.

Tolerances: 1e-12 absolute in float64 (the two do the same arithmetic,
measured to 0 or a few ulps); 1e-6 in float32 (the plan seed's
interpolation rounds in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp import grid as j_grid
from mpc_local_planner_tpu.ocp.problem import make_ocp_functions as j_funcs

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ocp import grid as t_grid
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.problem import make_ocp_functions as t_funcs
from mpc_local_planner_tpu_torch.ocp.spec import Scenario

B, N = 5, 8
TOL64, TOL32 = 1e-12, 1e-6


def np_tree(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: np_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def spec_pair(case):
    """(JAX spec, port spec, family ensemble name or None)."""
    if case == "flagship":
        return jb.config3_carlike_min_time(N=N, obstacle_cap=4), tb.config3_carlike_min_time(
            N=N, obstacle_cap=4), None
    if case == "config2":
        return jb.config2_diffdrive_obstacles(N=N, obstacle_cap=3), \
            tb.config2_diffdrive_obstacles(N=N, obstacle_cap=3), None
    fam = {"nonuniform": "nonuniform", "via": "via_points", "lines": "converter_lines"}[case]
    return jb.family_spec(fam, N=N), tb.family_spec(fam, N=N), fam


def case_inputs(case, jdtype=jnp.float64, seed=0):
    """(JAX spec, port spec, JAX scenarios, JAX primal, port scenarios,
    port primal): a random trajectory about the straight-line seed."""
    jspec, tspec, fam = spec_pair(case)
    key = jax.random.PRNGKey(seed)
    if fam is None:
        scen = jb.random_ensemble(jspec, B, key, dtype=jdtype)
    else:
        scen = jb.family_ensemble(fam, jspec, B, key, dtype=jdtype)
    init = j_grid.initial_primal(jspec, scen)
    rng = np.random.default_rng(seed)
    xs = np.asarray(init.xs) + 0.3 * rng.normal(size=init.xs.shape)
    us = np.asarray(init.us) + 0.2 * rng.normal(size=init.us.shape)
    dt = np.asarray(init.dt) * rng.uniform(0.5, 1.5, size=init.dt.shape)
    if not jspec.variable_dt:  # a fixed dt is dt_ref
        dt = np.asarray(init.dt)
    xs[:, 0] = np.asarray(scen.x0)
    npd = np.dtype(jdtype)
    jprimal = j_grid.Primal(xs=jnp.asarray(xs, jdtype), us=jnp.asarray(us, jdtype),
                            dt=jnp.asarray(dt, jdtype))
    tprimal = Primal(xs=torch.from_numpy(xs.astype(npd)), us=torch.from_numpy(us.astype(npd)),
                     dt=torch.from_numpy(dt.astype(npd)))
    return jspec, tspec, scen, jprimal, convert.from_numpy(Scenario, np_tree(scen), "cpu"), tprimal


CASES = ("flagship", "config2", "nonuniform", "via")


@pytest.mark.parametrize("case", CASES)
def test_torch_ocp_functions_eq_and_ineq_match_jax(case):
    jspec, tspec, jscen, jp, tscen, tp = case_inputs(case)
    jf, tf = j_funcs(jspec), t_funcs(tspec)
    for name in ("eq", "ineq", "cost"):
        want = np.asarray(jax.vmap(getattr(jf, name))(jp, jscen))
        got = getattr(tf, name)(tp, tscen).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=TOL64, rtol=0, err_msg=name)
    assert tf.eq(tp, tscen).shape[-1] == tf.n_eq == jf.n_eq
    assert tf.ineq(tp, tscen).shape[-1] == tf.n_ineq == jf.n_ineq
    assert (tf.n_dt, tf.n_free) == (jf.n_dt, jf.n_free)


@pytest.mark.parametrize("case", CASES)
def test_torch_ocp_functions_flatten_unflatten_match_jax(case):
    jspec, tspec, jscen, jp, tscen, tp = case_inputs(case, seed=1)
    jf, tf = j_funcs(jspec), t_funcs(tspec)
    z = tf.flatten(tp)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jf.flatten(jp)))
    assert z.shape[-1] == tf.n_free
    # unflatten(flatten(p)) == p, bit for bit (x_0 from the scenario)
    back = tf.unflatten(z, tscen.x0)
    for k in ("xs", "us", "dt"):
        np.testing.assert_array_equal(getattr(back, k).numpy(), getattr(tp, k).numpy())
        np.testing.assert_array_equal(
            getattr(back, k).numpy(), np.asarray(getattr(jf.unflatten(jnp.asarray(z.numpy()),
                                                                      jscen.x0), k)))
    # a single lane, and a fixed dt given explicitly
    one = tf.unflatten(z[0], tscen.x0[0], dt_fixed=0.25)
    assert one.xs.shape == (N + 1, 3) and one.us.shape == (N, tspec.nu)
    if not tspec.variable_dt:
        assert float(one.dt) == 0.25


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("case", ["flagship", "nonuniform"])
def test_torch_primal_from_plan_matches_jax(case, dtype):
    jdtype = {"f64": jnp.float64, "f32": jnp.float32}[dtype]
    jspec, tspec, jscen, *_ = case_inputs(case, jdtype)
    tol = TOL64 if dtype == "f64" else TOL32
    rng = np.random.default_rng(3)
    for P in (2, 5, 16, 40):
        plan = rng.normal(size=(B, P, 3)) * np.array([2.0, 2.0, 3.0])
        plan = plan.astype(np.dtype(jdtype))
        x0 = np.array(jscen.x0)
        want = j_grid.primal_from_plan(jspec, jnp.asarray(plan), jnp.asarray(x0))
        got = t_grid.primal_from_plan(tspec, torch.from_numpy(plan), torch.from_numpy(x0))
        for k in ("xs", "us", "dt"):
            g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
            assert g.shape == w.shape and g.dtype == w.dtype, k
            np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=f"{k} P={P}")
        np.testing.assert_array_equal(got.xs[:, 0].numpy(), x0)
    # an explicit dt and one plan shared by one lane
    got = t_grid.primal_from_plan(tspec, torch.from_numpy(plan[0]), torch.from_numpy(x0[0]),
                                  dt=0.2)
    assert got.xs.shape == (N + 1, 3) and torch.all(got.dt == torch.tensor(0.2, dtype=got.dt.dtype))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_torch_lines_detour_plan_matches_jax(dtype):
    jdtype = {"f64": jnp.float64, "f32": jnp.float32}[dtype]
    jspec, tspec, jscen, _, tscen, _ = case_inputs("lines", jdtype, seed=4)
    want = np.asarray(jb.lines_detour_plan(jscen))
    got = tb.lines_detour_plan(tscen).numpy()
    assert got.shape == want.shape == (B, 3, 3) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=TOL64 if dtype == "f64" else TOL32, rtol=0)
    seed = t_grid.primal_from_plan(tspec, tb.lines_detour_plan(tscen), tscen.x0)
    jseed = j_grid.primal_from_plan(jspec, jb.lines_detour_plan(jscen), jscen.x0)
    np.testing.assert_allclose(seed.xs.numpy(), np.asarray(jseed.xs),
                               atol=TOL64 if dtype == "f64" else 1e-5, rtol=0)
