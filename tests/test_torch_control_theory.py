"""The port's control-theory solvers and finite differences on the CPU
(``numerics/control_theory.py``, ``numerics/finite_differences.py``).

Every solver is held against the JAX package's on the same float64 inputs
(made with numpy) at 1e-9 relative to the answer's largest entry, and
against scipy at the JAX package's own test tolerances
(``tests/test_numerics.py``), on the systems of those tests. The batched
cases run the port on a leading batch axis against JAX under ``vmap``: the
port's Kronecker solves pass their right-hand side as an explicit column,
where ``torch.linalg.solve`` would read a (batch, n²) right-hand side as
vectors and NumPy's rule (JAX's since 0.5) as one matrix. Both Jacobians
are held to JAX's at 1e-9 and to ``torch.func`` at JAX's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from mpc_local_planner_tpu.numerics import control_theory as J
from mpc_local_planner_tpu.numerics import finite_differences as JF

from mpc_local_planner_tpu_torch import numerics as T


def _rand_system(seed, n=4, m=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, n)) * 0.5, rng.normal(size=(n, m)), np.eye(n) * 2.0, np.eye(m) * 1.5


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _rel(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    return float(np.max(np.abs(port - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_riccati_solves_and_gains_match_jax_and_scipy(seed):
    A, B, Q, R = _rand_system(seed)
    X = T.are_discrete(*_t(A, B, Q, R))
    assert _rel(X, J.are_discrete(A, B, Q, R)) <= 1e-9
    np.testing.assert_allclose(X.numpy(), sla.solve_discrete_are(A, B, Q, R), atol=1e-8)
    Xc = T.are_continuous(*_t(A, B, Q, R))
    assert _rel(Xc, J.are_continuous(A, B, Q, R)) <= 1e-9
    np.testing.assert_allclose(Xc.numpy(), sla.solve_continuous_are(A, B, Q, R), atol=1e-7)
    Kd = T.lqr_gain_discrete(*_t(A, B, Q, R))
    Kc = T.lqr_gain_continuous(*_t(A, B, Q, R))
    assert _rel(Kd, J.lqr_gain_discrete(A, B, Q, R)) <= 1e-9
    assert _rel(Kc, J.lqr_gain_continuous(A, B, Q, R)) <= 1e-9
    # the gains stabilize (JAX's test_lqr_gains_stabilize)
    assert np.max(np.abs(np.linalg.eigvals(A - B @ Kd.numpy()))) < 1.0
    assert np.max(np.linalg.eigvals(A - B @ Kc.numpy()).real) < 0.0


def test_torch_lyapunov_and_sylvester_match_jax_and_scipy():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 4)) * 0.4
    Q = np.eye(4)
    X = T.lyapunov_discrete(*_t(A, Q))
    assert _rel(X, J.lyapunov_discrete(A, Q)) <= 1e-9
    np.testing.assert_allclose(X.numpy(), sla.solve_discrete_lyapunov(A, Q), atol=1e-9)

    A = np.random.default_rng(6).normal(size=(4, 4)) - 3 * np.eye(4)
    X = T.lyapunov_continuous(*_t(A, Q))
    assert _rel(X, J.lyapunov_continuous(A, Q)) <= 1e-9
    np.testing.assert_allclose(A @ X.numpy() + X.numpy() @ A.T + Q, 0.0, atol=1e-9)
    np.testing.assert_allclose(X.numpy(), sla.solve_continuous_lyapunov(A, -Q), atol=1e-9)

    rng = np.random.default_rng(7)
    A = rng.normal(size=(3, 3)) - 2 * np.eye(3)
    B = rng.normal(size=(4, 4)) - 2 * np.eye(4)
    C = rng.normal(size=(3, 4))
    X = T.sylvester_continuous(*_t(A, B, C))
    assert X.shape == (3, 4)
    assert _rel(X, J.sylvester_continuous(A, B, C)) <= 1e-9
    np.testing.assert_allclose(A @ X.numpy() + X.numpy() @ B + C, 0.0, atol=1e-9)
    np.testing.assert_allclose(X.numpy(), sla.solve_sylvester(A, B, -C), atol=1e-9)


def test_torch_batched_solvers_match_jax_vmap_and_scipy():
    """JAX's test_batched_dare systems, and batches of every other solver:
    the port on a leading axis against JAX under vmap, each lane against
    scipy."""
    systems = [_rand_system(s) for s in (8, 9)]
    A, B, Q, R = (np.stack([s[i] for s in systems]) for i in range(4))
    X = T.are_discrete(*_t(A, B, Q, R))
    assert _rel(X, jax.vmap(J.are_discrete)(A, B, Q, R)) <= 1e-9
    for b, s in enumerate(systems):
        np.testing.assert_allclose(X[b].numpy(), sla.solve_discrete_are(*s), atol=1e-8)
    assert _rel(T.are_continuous(*_t(A, B, Q, R)), jax.vmap(J.are_continuous)(A, B, Q, R)) <= 1e-9
    assert _rel(T.lqr_gain_discrete(*_t(A, B, Q, R)),
                jax.vmap(J.lqr_gain_discrete)(A, B, Q, R)) <= 1e-9
    assert _rel(T.lqr_gain_continuous(*_t(A, B, Q, R)),
                jax.vmap(J.lqr_gain_continuous)(A, B, Q, R)) <= 1e-9

    rng = np.random.default_rng(10)
    Ah = np.stack([rng.normal(size=(4, 4)) - 3 * np.eye(4) for _ in range(3)])
    Qs = np.stack([np.eye(4) * (k + 1) for k in range(3)])
    Xl = T.lyapunov_continuous(*_t(Ah, Qs))
    assert Xl.shape == (3, 4, 4)
    assert _rel(Xl, jax.vmap(J.lyapunov_continuous)(Ah, Qs)) <= 1e-9
    As = np.stack([rng.normal(size=(4, 4)) * 0.4 for _ in range(3)])
    Xd = T.lyapunov_discrete(*_t(As, Qs))
    assert _rel(Xd, jax.vmap(J.lyapunov_discrete)(As, Qs)) <= 1e-9
    Bs = np.stack([rng.normal(size=(2, 2)) - 2 * np.eye(2) for _ in range(3)])
    Cs = rng.normal(size=(3, 4, 2))
    Xs = T.sylvester_continuous(*_t(Ah, Bs, Cs))
    assert _rel(Xs, jax.vmap(J.sylvester_continuous)(Ah, Bs, Cs)) <= 1e-9
    for b in range(3):
        np.testing.assert_allclose(Xl[b].numpy(), sla.solve_continuous_lyapunov(Ah[b], -Qs[b]),
                                   atol=1e-9)
        np.testing.assert_allclose(Xd[b].numpy(), sla.solve_discrete_lyapunov(As[b], Qs[b]),
                                   atol=1e-9)
        np.testing.assert_allclose(Xs[b].numpy(), sla.solve_sylvester(Ah[b], Bs[b], -Cs[b]),
                                   atol=1e-9)


def test_torch_controllability_and_observability_match_jax():
    A = np.array([[0.0, 1.0], [0.0, 0.0]])
    B = np.array([[0.0], [1.0]])
    C = np.array([[1.0, 0.0]])
    np.testing.assert_array_equal(T.controllability_matrix(*_t(A, B)).numpy(),
                                  np.asarray(J.controllability_matrix(A, B)))
    np.testing.assert_array_equal(T.observability_matrix(*_t(A, C)).numpy(),
                                  np.asarray(J.observability_matrix(A, C)))
    assert bool(T.is_controllable(*_t(A, B))) and bool(T.is_observable(*_t(A, C)))
    zero = np.zeros((2, 1))
    assert not bool(T.is_controllable(*_t(A.T, zero))) and not bool(J.is_controllable(A.T, zero))
    # a batch: one controllable pair, one not
    Ab, Bb = np.stack([A, A]), np.stack([B, np.array([[1.0], [0.0]])])
    got = T.is_controllable(*_t(Ab, Bb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(J.is_controllable)(Ab, Bb)))
    np.testing.assert_array_equal(got, [True, False])
    A3 = np.random.default_rng(3).normal(size=(3, 3))
    C3 = np.random.default_rng(4).normal(size=(2, 3))
    assert _rel(T.observability_matrix(*_t(A3, C3)), J.observability_matrix(A3, C3)) <= 1e-12


def _f_torch(x):
    return torch.stack([torch.sin(x[..., 0]) * x[..., 1], x[..., 0] ** 2 + torch.cos(x[..., 1])],
                       dim=-1)


def _f_jax(x):
    return jnp.stack([jnp.sin(x[..., 0]) * x[..., 1], x[..., 0] ** 2 + jnp.cos(x[..., 1])],
                     axis=-1)


def test_torch_finite_difference_jacobians_match_jax_and_ad():
    x = np.array([0.7, -0.3])
    (xt,) = _t(x)
    J_ad = torch.func.jacfwd(_f_torch)(xt).numpy()
    fwd = T.forward_jacobian(_f_torch, xt)
    cen = T.central_jacobian(_f_torch, xt)
    assert _rel(fwd, JF.forward_jacobian(_f_jax, x)) <= 1e-9
    assert _rel(cen, JF.central_jacobian(_f_jax, x)) <= 1e-9
    np.testing.assert_allclose(fwd.numpy(), J_ad, atol=1e-5)
    np.testing.assert_allclose(cen.numpy(), J_ad, atol=1e-8)
    # a batch of points: one Jacobian per point
    xb = np.array([[0.7, -0.3], [0.1, 0.4], [-1.2, 2.0]])
    cb = T.central_jacobian(_f_torch, *_t(xb))
    assert cb.shape == (3, 2, 2)
    assert _rel(cb, jax.vmap(lambda p: JF.central_jacobian(_f_jax, p))(xb)) <= 1e-9

    def g_t(x):
        return torch.sin(x[0]) * x[1] ** 2 + x[0] * x[1]

    def g_j(x):
        return jnp.sin(x[0]) * x[1] ** 2 + x[0] * x[1]

    y = np.array([0.4, 1.2])
    H = T.central_hessian(g_t, *_t(y))
    np.testing.assert_allclose(H.numpy(), torch.func.hessian(g_t)(*_t(y)).numpy(), atol=1e-4)
    # nested differences of step 1e-4 divide rounding by 1e-8
    np.testing.assert_allclose(H.numpy(), np.asarray(JF.central_hessian(g_j, y)), atol=1e-7)
