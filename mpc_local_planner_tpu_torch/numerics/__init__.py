"""Numerics: integrators, finite differences, control-theory solvers (port of
``mpc_local_planner_tpu.numerics``).

Parity: cbr:numerics (corbo-numerics) — explicit_integrators.h,
finite_differences.h, algebraic_riccati_{discrete,continuous}.h,
lyapunov_{discrete,continuous}.h, sylvester.h, controllability.h,
observability.h. Every solver runs a fixed number of iterations (doubling,
sign-function and Kronecker methods), as the JAX package's do.
"""

from mpc_local_planner_tpu_torch.numerics.integrators import (
    INTEGRATORS,
    integrate,
    make_integrator,
)
from mpc_local_planner_tpu_torch.numerics.finite_differences import (
    central_jacobian,
    forward_jacobian,
    central_hessian,
)
from mpc_local_planner_tpu_torch.numerics.control_theory import (
    are_discrete,
    are_continuous,
    lyapunov_discrete,
    lyapunov_continuous,
    sylvester_continuous,
    controllability_matrix,
    is_controllable,
    observability_matrix,
    is_observable,
    lqr_gain_discrete,
    lqr_gain_continuous,
)

__all__ = [
    "INTEGRATORS",
    "integrate",
    "make_integrator",
    "central_jacobian",
    "forward_jacobian",
    "central_hessian",
    "are_discrete",
    "are_continuous",
    "lyapunov_discrete",
    "lyapunov_continuous",
    "sylvester_continuous",
    "controllability_matrix",
    "is_controllable",
    "observability_matrix",
    "is_observable",
    "lqr_gain_discrete",
    "lqr_gain_continuous",
]
