"""Finite-difference collocation on SE(2) (port of
``mpc_local_planner_tpu.ocp.collocation``, forward differences).

Defect form per stage: c_k = (x_k ⊞ dt·φ(x_k, u_k, x_{k+1})) ⊖ x_{k+1}.
Midpoint, Crank–Nicolson and shooting come with ROADMAP item M9.
"""

from __future__ import annotations

from mpc_local_planner_tpu_torch.core.so2 import _wrap_theta as _wrap


def _phi_forward(model, xk, uk, xk1):
    return model.f(xk, uk)


COLLOCATION_METHODS = {"forward_differences": _phi_forward}


def _phi(method: str):
    try:
        return COLLOCATION_METHODS[method]
    except KeyError:
        raise NotImplementedError(
            f"collocation {method!r} is not ported yet (ROADMAP M9)"
        ) from None


def stage_defect(model, method: str, xk, uk, xk1, dt):
    """Single-stage transcription defect c_k (shape (..., 3)); dt has the
    stage's batch shape (0-d for one stage)."""
    f = _phi(method)(model, xk, uk, xk1)
    pred = xk + (dt[..., None] * f if dt.dim() else dt * f)
    return _wrap(pred - xk1)


def collocation_defects(model, method: str, xs, us, dt):
    """All N stage defects for a trajectory.

    xs: (..., N+1, 3); us: (..., N, nu); dt: (...,) scalar per trajectory.
    Returns (..., N, 3).
    """
    xk = xs[..., :-1, :]
    xk1 = xs[..., 1:, :]
    pred = xk + dt[..., None, None] * _phi(method)(model, xk, us, xk1)
    return _wrap(pred - xk1)
