"""Objective terms (port of ``mpc_local_planner_tpu.ocp.costs``, minimum time).

Quadratic forms, the terminal quadratic cost and via points come with
ROADMAP item M9; ``OcpSpec`` refuses them.
"""

from __future__ import annotations


def minimum_time_cost(spec, dt):
    """Σ_k dt_k = N·dt on a uniform grid (parity: corbo MinimumTime)."""
    return spec.N * dt


def total_cost(spec, xs, us, dt, scenario):
    """Full objective for a trajectory (scalar per batch element)."""
    return minimum_time_cost(spec, dt)
