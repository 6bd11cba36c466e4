"""Robot footprint models (port of
``mpc_local_planner_tpu.geometry.footprints``: the point, disc and two-disc
footprints).

``distances(pose, obs)`` returns the per-obstacle distance vector for a whole
padded ObstacleSet at once, in the slot order [points, circles, lines,
polygons]; inactive slots report BIG_DISTANCE. The line and polygon
footprints come with ROADMAP item M9 (K2c footprints).
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_local_planner_tpu_torch.geometry.distances import (
    point_to_point,
    point_to_polygon_signed,
    point_to_segment,
)
from mpc_local_planner_tpu_torch.geometry.obstacles import BIG_DISTANCE, ObstacleSet


def _mask(d, mask):
    return torch.where(mask, d, BIG_DISTANCE)


def _point_distances(p, obs: ObstacleSet):
    """Distances from a world point (..., 2) to every obstacle slot (..., M).
    A family with no slot adds no column and no work (its shape is static)."""
    q = p[..., None, :]
    d_pts = point_to_point(q, obs.points)
    d_circ = point_to_point(q, obs.circles) - obs.circle_radii
    cols = [_mask(d_pts, obs.point_mask), _mask(d_circ, obs.circle_mask)]
    if obs.lines.shape[-3]:
        d_line = point_to_segment(q, obs.lines[..., 0, :], obs.lines[..., 1, :])
        cols.append(_mask(d_line, obs.line_mask))
    if obs.polygons.shape[-3]:
        d_poly = point_to_polygon_signed(q, obs.polygons, obs.polygon_nv)
        cols.append(_mask(d_poly, obs.polygon_mask))
    return torch.cat(cols, dim=-1)


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


@dataclasses.dataclass(frozen=True)
class TwoCirclesFootprint:
    """Two discs on the body x-axis (parity: TwoCirclesRobotFootprint;
    front_offset/front_radius/rear_offset/rear_radius). The minimum of the
    two discs' distances splits its gradient 0.5/0.5 at a tie, as
    ``jnp.minimum`` does."""

    front_offset: float = 0.2
    front_radius: float = 0.2
    rear_offset: float = -0.2
    rear_radius: float = 0.2

    def distances(self, pose, obs: ObstacleSet):
        th = pose[..., 2]
        heading = torch.stack([torch.cos(th), torch.sin(th)], dim=-1)
        p = pose[..., :2]
        front = _point_distances(p + self.front_offset * heading, obs) - self.front_radius
        rear = _point_distances(p + self.rear_offset * heading, obs) - self.rear_radius
        return torch.minimum(front, rear)


def disc_footprint(footprint):
    """The footprint as discs on the body x-axis, ((offset, radius), ...):
    one for the point and the disc, two for the two-disc footprint (the
    geometry the fused kernel takes)."""
    if isinstance(footprint, TwoCirclesFootprint):
        return (
            (footprint.front_offset, footprint.front_radius),
            (footprint.rear_offset, footprint.rear_radius),
        )
    if isinstance(footprint, CircularFootprint):
        return ((0.0, footprint.radius),)
    if isinstance(footprint, PointFootprint):
        return ((0.0, 0.0),)
    raise TypeError(f"{type(footprint).__name__} is not a disc-family footprint")


FOOTPRINT_TYPES = {
    "point": PointFootprint,
    "circular": CircularFootprint,
    "two_circles": TwoCirclesFootprint,
}
_NOT_PORTED = ("line", "polygon")


def make_footprint(footprint_type: str, **kwargs):
    """Factory (parity: getRobotFootprintFromParamServer type switch)."""
    if footprint_type in _NOT_PORTED:
        raise NotImplementedError(
            f"the {footprint_type} footprint is not ported yet (ROADMAP M9, K2c footprints)"
        )
    try:
        cls = FOOTPRINT_TYPES[footprint_type]
    except KeyError:
        options = sorted(FOOTPRINT_TYPES) + list(_NOT_PORTED)
        raise ValueError(
            f"unknown footprint type {footprint_type!r}; options: {sorted(options)}"
        ) from None
    return cls(**kwargs)
