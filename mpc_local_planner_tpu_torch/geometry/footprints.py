"""Robot footprint models (port of
``mpc_local_planner_tpu.geometry.footprints``: point and disc footprints).

``distances(pose, obs)`` returns the per-obstacle distance vector for a whole
padded ObstacleSet at once; inactive slots report BIG_DISTANCE. The line,
two-circles and polygon footprints, and line and polygon obstacle slots, come
with ROADMAP item M9.
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_local_planner_tpu_torch.geometry.distances import point_to_point
from mpc_local_planner_tpu_torch.geometry.obstacles import BIG_DISTANCE, ObstacleSet


def _mask(d, mask):
    return torch.where(mask, d, BIG_DISTANCE)


def _point_distances(p, obs: ObstacleSet):
    """Distances from a world point (..., 2) to every obstacle slot (..., M)."""
    if obs.lines.shape[-3] or obs.polygons.shape[-3]:
        raise NotImplementedError(
            "line and polygon obstacle slots are not ported yet (ROADMAP M9)"
        )
    d_pts = point_to_point(p[..., None, :], obs.points)
    d_circ = point_to_point(p[..., None, :], obs.circles) - obs.circle_radii
    return torch.cat(
        [_mask(d_pts, obs.point_mask), _mask(d_circ, obs.circle_mask)], dim=-1
    )


@dataclasses.dataclass(frozen=True)
class PointFootprint:
    """Robot = a point at the pose position (parity: PointRobotFootprint)."""

    def distances(self, pose, obs: ObstacleSet):
        return _point_distances(pose[..., :2], obs)


@dataclasses.dataclass(frozen=True)
class CircularFootprint:
    """Disc of given radius (parity: CircularRobotFootprint)."""

    radius: float = 0.3

    def distances(self, pose, obs: ObstacleSet):
        return _point_distances(pose[..., :2], obs) - self.radius
