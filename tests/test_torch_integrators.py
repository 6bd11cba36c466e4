"""The explicit integrators (``numerics/integrators.py``) on the CPU against
the JAX package's, from identical float64 inputs made with numpy: every
integrator at 1, 2 and 4 substeps through ``integrate``, ``rollout`` and
``jacfwd`` of ``integrate`` (over the state, the control and dt), at 1e-12;
the tableaus are the JAX ones, and an unknown name is refused as JAX
refuses it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from mpc_local_planner_tpu.numerics import integrators as j_int
from mpc_local_planner_tpu.systems import models as jm

from mpc_local_planner_tpu_torch.numerics import integrators as t_int
from mpc_local_planner_tpu_torch.systems import models as tm

ATOL = 1e-12
B, N = 5, 6
MODELS = (jm.SimpleCarModel(wheelbase=0.5), tm.SimpleCarModel(wheelbase=0.5))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 3)) * np.array([1.0, 1.0, 3.0])
    u = rng.uniform(-0.4, 0.4, size=(B, 2))
    dt = rng.uniform(0.1, 0.5, size=(B,))
    return x, u, dt


@pytest.mark.parametrize("substeps", [1, 2, 4])
@pytest.mark.parametrize("method", sorted(j_int.INTEGRATORS))
def test_torch_integrate_and_its_jacobian_match_jax(method, substeps):
    jmodel, tmodel = MODELS
    x, u, dt = _inputs()
    want = np.asarray(j_int.integrate(jmodel.f, jnp.asarray(x), jnp.asarray(u),
                                      jnp.asarray(dt)[:, None], method, substeps))
    T = torch.from_numpy
    got = t_int.integrate(tmodel.f, T(x), T(u), T(dt)[:, None], method, substeps)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)

    def j_one(xx, uu, d):
        return j_int.integrate(jmodel.f, xx, uu, d, method, substeps)

    def t_one(xx, uu, d):
        return t_int.integrate(tmodel.f, xx, uu, d, method, substeps)

    jac_j = jax.vmap(jax.jacfwd(j_one, argnums=(0, 1, 2)))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(dt)[:, None])
    jac_t = torch.vmap(jacfwd(t_one, argnums=(0, 1, 2)))(T(x), T(u), T(dt)[:, None])
    for a, b in zip(jac_t, jac_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)


@pytest.mark.parametrize("substeps", [1, 2, 4])
@pytest.mark.parametrize("method", sorted(j_int.INTEGRATORS))
def test_torch_rollout_matches_jax(method, substeps):
    jmodel, tmodel = MODELS
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(B, 3))
    us = rng.uniform(-0.4, 0.4, size=(B, N, 2))
    want = np.asarray(j_int.rollout(jmodel.f, jnp.asarray(x0), jnp.asarray(us), 0.3, method,
                                    substeps))
    got = t_int.rollout(tmodel.f, torch.from_numpy(x0), torch.from_numpy(us), 0.3, method,
                        substeps)
    assert got.shape == (B, N + 1, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_torch_tableaus_are_the_jax_ones_and_consistent():
    assert t_int.RK_TABLEAUS == j_int.RK_TABLEAUS
    assert sorted(t_int.INTEGRATORS) == sorted(j_int.INTEGRATORS)
    for name, (a_rows, b) in t_int.RK_TABLEAUS.items():
        assert len(a_rows) == len(b) - 1, name
        assert abs(sum(b) - 1.0) < 1e-12, name


def test_torch_make_integrator_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown integrator 'rk9'"):
        j_int.make_integrator("rk9")
    with pytest.raises(ValueError, match="unknown integrator 'rk9'"):
        t_int.make_integrator("rk9")
    assert t_int.make_integrator("rk4") is t_int.INTEGRATORS["rk4"]


def test_torch_integrate_keeps_float32_under_forward_mode():
    """A one-element dt keeps the tangents float32 under ``torch.func``
    (a 0-d tensor times a Python float gets a float64 tangent)."""
    tmodel = MODELS[1]
    x, u, dt = (torch.from_numpy(a).float() for a in _inputs())
    jac = torch.vmap(jacfwd(lambda xx, uu, d: t_int.integrate(tmodel.f, xx, uu, d, "rk4", 2),
                            argnums=(0, 1, 2)))(x, u, dt[:, None])
    assert all(j.dtype == torch.float32 for j in jac)
