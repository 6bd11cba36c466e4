"""Finite-difference collocation on SE(2) and multiple shooting (port of
``mpc_local_planner_tpu.ocp.collocation``).

Defect form per stage: c_k = (x_k ⊞ dt·φ(x_k, u_k, x_{k+1})) ⊖ x_{k+1} for
the forward, midpoint and Crank–Nicolson rules, and c_k = Φ(x_k, u_k, dt) ⊖
x_{k+1} for a shooting grid "shooting_<integrator>[_<substeps>]" (Φ an
explicit integrator step, ``numerics.integrators``). Only θ is wrapped.
"""

from __future__ import annotations

from mpc_local_planner_tpu_torch.core.so2 import _wrap_theta as _wrap
from mpc_local_planner_tpu_torch.core.so2 import se2_interpolate


def _phi_forward(model, xk, uk, xk1):
    return model.f(xk, uk)


def _phi_midpoint(model, xk, uk, xk1):
    # SE(2)-aware midpoint: θ interpolated along the shortest arc
    xm = se2_interpolate(xk, xk1, 0.5)
    return model.f(xm, uk)


def _phi_crank_nicolson(model, xk, uk, xk1):
    return 0.5 * (model.f(xk, uk) + model.f(xk1, uk))


COLLOCATION_METHODS = {
    "forward_differences": _phi_forward,
    "midpoint_differences": _phi_midpoint,
    "crank_nicolson_differences": _phi_crank_nicolson,
}

SHOOTING_PREFIX = "shooting_"


def _parse_shooting(method: str):
    """(integrator, substeps) of "shooting_<integrator>[_<substeps>]"."""
    rest = method[len(SHOOTING_PREFIX) :]
    parts = rest.rsplit("_", 1)
    if len(parts) == 2 and parts[1].isdigit():
        return parts[0], int(parts[1])
    return rest, 1


def _shooting_pred(model, method: str, xk, uk, dt):
    from mpc_local_planner_tpu_torch.numerics.integrators import integrate

    integ, substeps = _parse_shooting(method)
    return integrate(model.f, xk, uk, dt, method=integ, substeps=substeps)


def stage_defect(model, method: str, xk, uk, xk1, dt):
    """Single-stage transcription defect c_k (shape (..., 3)); dt has the
    stage's batch shape (0-d for one stage)."""
    if method.startswith(SHOOTING_PREFIX):
        # a 1-element dt for one stage: under torch.func forward mode a 0-d
        # tensor combined with a Python float gets a float64 tangent
        pred = _shooting_pred(model, method, xk, uk, dt[..., None])
    else:
        f = COLLOCATION_METHODS[method](model, xk, uk, xk1)
        pred = xk + (dt[..., None] * f if dt.dim() else dt * f)
    return _wrap(pred - xk1)


def collocation_defects(model, method: str, xs, us, dt):
    """All N stage defects for a trajectory.

    xs: (..., N+1, 3); us: (..., N, nu); dt: (...,) scalar per trajectory
    or (..., N) per stage. Returns (..., N, 3).
    """
    xk = xs[..., :-1, :]
    xk1 = xs[..., 1:, :]
    dtb = dt[..., None] if dt.dim() == xs.dim() - 1 else dt[..., None, None]
    if method.startswith(SHOOTING_PREFIX):
        pred = _shooting_pred(model, method, xk, us, dtb)
    else:
        pred = xk + dtb * COLLOCATION_METHODS[method](model, xk, us, xk1)
    return _wrap(pred - xk1)
