"""Batched 2D distance primitives (port of
``mpc_local_planner_tpu.geometry.distances``, point and circle slots).

Segment and polygon distances come with the line and polygon slots of
ROADMAP item M9.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _safe_norm(d):
    """‖d‖ with a bounded gradient at 0 (plain norm AD yields NaN there —
    and trajectory inits routinely pass exactly through obstacle centers)."""
    return torch.sqrt(torch.sum(d * d, dim=-1) + _EPS)


def point_to_point(p, q):
    """|p - q| with batch broadcasting; last dim = 2."""
    return _safe_norm(p - q)
