"""Float64 golden-reference solver (port of
``mpc_local_planner_tpu.solvers.golden``).

Solves the same transcription (the same ``OcpFunctions`` residuals) with an
independent algorithm, scipy SLSQP in float64 on the host CPU, with exact
Jacobians from ``torch.func``, so that the AL-SQP solver can be held against
it to tight tolerances. Slow by design; never on the device path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import grad, jacfwd, jacrev

from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.ocp.grid import Primal, initial_primal
from mpc_local_planner_tpu_torch.ocp.problem import make_ocp_functions


def _host64(tree):
    return tree_map(
        lambda a: a.detach().cpu().double() if a.is_floating_point() else a.detach().cpu(),
        tree,
    )


def solve_golden(spec, scenario, init: Optional[Primal] = None, tol: float = 1e-10,
                 maxiter: int = 1000):
    """Solve one (unbatched) OCP with scipy SLSQP in float64 on the host.

    Returns (Primal solution on the CPU in float64, scipy OptimizeResult).
    """
    from scipy.optimize import NonlinearConstraint, minimize

    funcs = make_ocp_functions(spec)
    scenario = _host64(scenario)
    x0 = scenario.x0
    if init is None:
        # the straight-line seed's nonzero forward velocity: at u = 0 the dt
        # column of the collocation Jacobian vanishes (f ∝ v) and SLSQP's LSQ
        # subproblem is singular on minimum-time problems
        init = initial_primal(spec, scenario)
    z0 = funcs.flatten(_host64(init)).numpy().astype(np.float64)

    def unpack(z):
        return funcs.unflatten(z, x0)

    def T(z):
        return torch.from_numpy(np.asarray(z, dtype=np.float64))

    def cost_t(z):
        return funcs.cost(unpack(z), scenario)

    # SLSQP needs non-degenerate rows: drop identically-zero equality rows
    # (unfixed xf components) and constant padded inequality rows (inactive
    # slots report −BIG_DISTANCE with zero gradient)
    eq_keep = torch.from_numpy(np.concatenate(
        [np.ones(spec.N * spec.nx, dtype=bool), np.asarray(spec.xf_fixed, dtype=bool)]))
    ineq_keep = funcs.ineq(unpack(T(z0)), scenario) > -1.0e5

    def eq_t(z):
        return funcs.eq(unpack(z), scenario)[eq_keep]

    def ineq_t(z):  # scipy's convention: fun(z) >= 0
        return -funcs.ineq(unpack(z), scenario)[ineq_keep]

    # forward mode for the N·nx + 3 equality rows, reverse mode for the
    # (more) inequality rows
    grad_t, eq_jac_t, ineq_jac_t = grad(cost_t), jacfwd(eq_t), jacrev(ineq_t)

    def np_of(fn):
        return lambda z: fn(T(z)).detach().numpy()

    cons = [NonlinearConstraint(np_of(eq_t), 0.0, 0.0, jac=np_of(eq_jac_t))]
    if bool(ineq_keep.any()):
        cons.append(NonlinearConstraint(np_of(ineq_t), 0.0, np.inf, jac=np_of(ineq_jac_t)))

    # the evaluations are hundreds of tiny tensor operations: one thread runs
    # them 2-3× faster than a pool of them (measured on an 8-core host)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = minimize(
            lambda z: float(cost_t(T(z))),
            z0,
            jac=np_of(grad_t),
            constraints=cons,
            method="SLSQP",
            options={"maxiter": maxiter, "ftol": tol},
        )
    finally:
        torch.set_num_threads(threads)
    return unpack(T(res.x)), res
