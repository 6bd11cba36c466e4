"""Explicit ODE integrators (port of
``mpc_local_planner_tpu.numerics.integrators``).

Fixed-step steppers ``step(f, x, u, dt)`` with ``f(x, u) -> xdot`` over any
leading batch dims; the control is held (ZOH) across the step. Each stepper
keeps the JAX module's arithmetic order (``_rk4`` sums
x + dt/6·(k1 + 2k2 + 2k3 + k4); it does not walk its tableau), so that its
value and ``torch.func`` derivatives match the JAX ones to rounding.
``RK_TABLEAUS`` is the fused kernel's source of the shooting integrators
(the kernel walks the tableau instead).
"""

from __future__ import annotations

import torch


def _euler(f, x, u, dt):
    return x + dt * f(x, u)


def _rk2_midpoint(f, x, u, dt):
    k1 = f(x, u)
    return x + dt * f(x + 0.5 * dt * k1, u)


def _rk2_heun(f, x, u, dt):
    k1 = f(x, u)
    k2 = f(x + dt * k1, u)
    return x + 0.5 * dt * (k1 + k2)


def _rk3(f, x, u, dt):
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x - dt * k1 + 2.0 * dt * k2, u)
    return x + dt / 6.0 * (k1 + 4.0 * k2 + k3)


def _rk4(f, x, u, dt):
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _rk5_fehlberg(f, x, u, dt):
    """5th-order stage of the RKF45 tableau (fixed step)."""
    k1 = f(x, u)
    k2 = f(x + dt * (1 / 4) * k1, u)
    k3 = f(x + dt * ((3 / 32) * k1 + (9 / 32) * k2), u)
    k4 = f(x + dt * ((1932 / 2197) * k1 - (7200 / 2197) * k2 + (7296 / 2197) * k3), u)
    k5 = f(x + dt * ((439 / 216) * k1 - 8 * k2 + (3680 / 513) * k3 - (845 / 4104) * k4), u)
    k6 = f(
        x
        + dt
        * (
            -(8 / 27) * k1
            + 2 * k2
            - (3544 / 2565) * k3
            + (1859 / 4104) * k4
            - (11 / 40) * k5
        ),
        u,
    )
    return x + dt * (
        (16 / 135) * k1
        + (6656 / 12825) * k3
        + (28561 / 56430) * k4
        - (9 / 50) * k5
        + (2 / 55) * k6
    )


# Butcher tableaus (a-matrix rows for stages 2..S, b weights), the JAX
# module's: euler..rk5 are the tableaus of the closed-form steppers above,
# rk6 (Butcher's 7-stage 6th-order method) and rk7 (Fehlberg RK7(8)
# truncated to the 11 stages its 7th-order solution uses) are walked from
# the tableau only.
RK_TABLEAUS = {
    "explicit_euler": ((), (1.0,)),
    "rk2_midpoint": (((0.5,),), (0.0, 1.0)),
    "rk2_heun": (((1.0,),), (0.5, 0.5)),
    "rk3": (((0.5,), (-1.0, 2.0)), (1.0 / 6.0, 4.0 / 6.0, 1.0 / 6.0)),
    "rk4": (
        ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
        (1.0 / 6.0, 2.0 / 6.0, 2.0 / 6.0, 1.0 / 6.0),
    ),
    "rk5": (
        (
            (1.0 / 4.0,),
            (3.0 / 32.0, 9.0 / 32.0),
            (1932.0 / 2197.0, -7200.0 / 2197.0, 7296.0 / 2197.0),
            (439.0 / 216.0, -8.0, 3680.0 / 513.0, -845.0 / 4104.0),
            (-8.0 / 27.0, 2.0, -3544.0 / 2565.0, 1859.0 / 4104.0, -11.0 / 40.0),
        ),
        (
            16.0 / 135.0, 0.0, 6656.0 / 12825.0, 28561.0 / 56430.0,
            -9.0 / 50.0, 2.0 / 55.0,
        ),
    ),
    "rk6": (
        (
            (1.0 / 3.0,),
            (0.0, 2.0 / 3.0),
            (1.0 / 12.0, 1.0 / 3.0, -1.0 / 12.0),
            (-1.0 / 16.0, 9.0 / 8.0, -3.0 / 16.0, -3.0 / 8.0),
            (0.0, 9.0 / 8.0, -3.0 / 8.0, -3.0 / 4.0, 1.0 / 2.0),
            (9.0 / 44.0, -9.0 / 11.0, 63.0 / 44.0, 18.0 / 11.0, 0.0,
             -16.0 / 11.0),
        ),
        (
            11.0 / 120.0, 0.0, 27.0 / 40.0, 27.0 / 40.0, -4.0 / 15.0,
            -4.0 / 15.0, 11.0 / 120.0,
        ),
    ),
    "rk7": (
        (
            (2.0 / 27.0,),
            (1.0 / 36.0, 1.0 / 12.0),
            (1.0 / 24.0, 0.0, 1.0 / 8.0),
            (5.0 / 12.0, 0.0, -25.0 / 16.0, 25.0 / 16.0),
            (1.0 / 20.0, 0.0, 0.0, 1.0 / 4.0, 1.0 / 5.0),
            (-25.0 / 108.0, 0.0, 0.0, 125.0 / 108.0, -65.0 / 27.0,
             125.0 / 54.0),
            (31.0 / 300.0, 0.0, 0.0, 0.0, 61.0 / 225.0, -2.0 / 9.0,
             13.0 / 900.0),
            (2.0, 0.0, 0.0, -53.0 / 6.0, 704.0 / 45.0, -107.0 / 9.0,
             67.0 / 90.0, 3.0),
            (-91.0 / 108.0, 0.0, 0.0, 23.0 / 108.0, -976.0 / 135.0,
             311.0 / 54.0, -19.0 / 60.0, 17.0 / 6.0, -1.0 / 12.0),
            (2383.0 / 4100.0, 0.0, 0.0, -341.0 / 164.0, 4496.0 / 1025.0,
             -301.0 / 82.0, 2133.0 / 4100.0, 45.0 / 82.0, 45.0 / 164.0,
             18.0 / 41.0),
        ),
        (
            41.0 / 840.0, 0.0, 0.0, 0.0, 0.0, 34.0 / 105.0, 9.0 / 35.0,
            9.0 / 35.0, 9.0 / 280.0, 9.0 / 280.0, 41.0 / 840.0,
        ),
    ),
}


def _from_tableau(name):
    """Generic explicit-RK stepper from a Butcher tableau (unrolled)."""
    a_rows, b = RK_TABLEAUS[name]

    def step(f, x, u, dt):
        ks = [f(x, u)]
        for row in a_rows:
            xs = x
            for aij, kj in zip(row, ks):
                if aij != 0.0:
                    xs = xs + dt * aij * kj
            ks.append(f(xs, u))
        out = x
        for bi, ki in zip(b, ks):
            if bi != 0.0:
                out = out + dt * bi * ki
        return out

    return step


INTEGRATORS = {
    "explicit_euler": _euler,
    "rk2_midpoint": _rk2_midpoint,
    "rk2_heun": _rk2_heun,
    "rk3": _rk3,
    "rk4": _rk4,
    "rk5": _rk5_fehlberg,
    "rk6": _from_tableau("rk6"),
    "rk7": _from_tableau("rk7"),
}


def make_integrator(name: str):
    """The stepper of ``name``; raises ``ValueError`` for an unknown one."""
    try:
        return INTEGRATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown integrator {name!r}; options: {sorted(INTEGRATORS)}"
        ) from None


def integrate(f, x, u, dt, method: str = "rk4", substeps: int = 1):
    """Propagate x over dt with ZOH control, in ``substeps`` equal steps
    (a Python loop where the JAX module scans)."""
    step = make_integrator(method)
    h = dt / substeps
    for _ in range(substeps):
        x = step(f, x, u, h)
    return x


def rollout(f, x0, us, dt, method: str = "rk4", substeps: int = 1):
    """Integrate a control sequence: x0 (..., nx), us (..., N, nu) →
    (..., N+1, nx); ``dt`` a float or a tensor that broadcasts against x0."""
    step = make_integrator(method)
    h = torch.as_tensor(dt, dtype=x0.dtype, device=x0.device) / substeps
    xs = [x0]
    x = x0
    for k in range(us.shape[-2]):
        u = us[..., k, :]
        for _ in range(substeps):
            x = step(f, x, u, h)
        xs.append(x)
    return torch.stack(xs, dim=-2)
