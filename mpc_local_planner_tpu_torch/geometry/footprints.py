"""Robot footprint models (port of
``mpc_local_planner_tpu.geometry.footprints``: the point, disc, line,
two-disc and polygon footprints).

``distances(pose, obs)`` returns the per-obstacle distance vector for a whole
padded ObstacleSet at once, in the slot order [points, circles, lines,
polygons]; inactive slots report BIG_DISTANCE. The line and polygon
footprints keep the JAX argument order of every nested minimum (the
footprint polygon is ``verts_a`` of ``polygon_to_polygon``, an obstacle line
comes first in ``segment_to_polygon``), so their subgradients split ties as
JAX's do, and cast their body-frame coordinates to the pose's dtype.
"""

from __future__ import annotations

import dataclasses

import torch

import math

from mpc_local_planner_tpu_torch.device import const
from mpc_local_planner_tpu_torch.geometry.distances import (
    point_to_point,
    point_to_polygon_signed,
    point_to_segment,
    polygon_to_polygon,
    segment_to_polygon,
    segment_to_segment,
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


def _segment_distances(a, b, obs: ObstacleSet):
    """Distances from the world segment [a, b] (..., 2) to every obstacle
    slot (..., M); a family with no slot adds no column."""
    a_, b_ = a[..., None, :], b[..., None, :]
    d_pts = point_to_segment(obs.points, a_, b_)
    d_circ = point_to_segment(obs.circles, a_, b_) - obs.circle_radii
    cols = [_mask(d_pts, obs.point_mask), _mask(d_circ, obs.circle_mask)]
    if obs.lines.shape[-3]:
        d_line = segment_to_segment(a_, b_, obs.lines[..., 0, :], obs.lines[..., 1, :])
        cols.append(_mask(d_line, obs.line_mask))
    if obs.polygons.shape[-3]:
        d_poly = segment_to_polygon(a_, b_, obs.polygons, obs.polygon_nv)
        cols.append(_mask(d_poly, obs.polygon_mask))
    return torch.cat(cols, dim=-1)


def _body_to_world(pose, body):
    """Body-frame points ``body`` (V, 2) at poses (..., 3): (..., V, 2),
    p + R(θ) v."""
    c, s = torch.cos(pose[..., 2])[..., None], torch.sin(pose[..., 2])[..., None]
    vx, vy = body[:, 0], body[:, 1]
    return torch.stack(
        [pose[..., 0, None] + (c * vx - s * vy), pose[..., 1, None] + (s * vx + c * vy)],
        dim=-1,
    )


def _point_pair(v, name):
    x, y = (float(c) for c in v)
    if not (math.isfinite(x) and math.isfinite(y)):
        raise ValueError(f"{name} must be finite, got {(x, y)}")
    return (x, y)


@dataclasses.dataclass(frozen=True)
class PointFootprint:
    """Robot = a point at the pose position (parity: PointRobotFootprint)."""

    def distances(self, pose, obs: ObstacleSet):
        return _point_distances(pose[..., :2], obs)

    @property
    def inscribed_radius(self):
        return 0.0


@dataclasses.dataclass(frozen=True)
class CircularFootprint:
    """Disc of given radius (parity: CircularRobotFootprint)."""

    radius: float = 0.3

    def distances(self, pose, obs: ObstacleSet):
        return _point_distances(pose[..., :2], obs) - self.radius

    @property
    def inscribed_radius(self):
        return self.radius


@dataclasses.dataclass(frozen=True)
class LineFootprint:
    """Body-frame segment (parity: LineRobotFootprint; line_start/line_end).
    The endpoints are kept as float pairs (the spec stays hashable) and cast
    to the pose's dtype, so a float32 solve stays float32."""

    line_start: tuple
    line_end: tuple

    def __post_init__(self):
        object.__setattr__(self, "line_start", _point_pair(self.line_start, "line_start"))
        object.__setattr__(self, "line_end", _point_pair(self.line_end, "line_end"))

    def distances(self, pose, obs: ObstacleSet):
        ends = _body_to_world(pose, const((self.line_start, self.line_end), pose))
        return _segment_distances(ends[..., 0, :], ends[..., 1, :], obs)

    @property
    def inscribed_radius(self):
        return 0.0


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

    @property
    def inscribed_radius(self):
        return min(self.front_radius, self.rear_radius)


@dataclasses.dataclass(frozen=True)
class PolygonFootprint:
    """Closed body-frame polygon (parity: PolygonRobotFootprint; vertices).
    The vertices are kept as a tuple of float pairs and cast to the pose's
    dtype. A slot point inside the polygon has a negative distance (the
    even-odd rule of ``point_to_polygon_signed``). As in the JAX package, a
    polygon of 2 vertices is its segment walked out and back (the distances
    of ``LineFootprint`` on it: the two edges' crossings cancel, so no point
    is inside) and a polygon of 1 vertex that point (its one edge has no
    length)."""

    vertices: tuple  # ((x, y), ...) body frame, closed implicitly

    def __post_init__(self):
        verts = tuple(_point_pair(v, "a vertex") for v in self.vertices)
        # no vertex, no edge: the JAX footprint takes it but computes no
        # distance (its einsum refuses the empty vertex array), so neither
        # does the port
        if not verts:
            raise ValueError("a polygon footprint needs 1 vertex or more, got 0")
        object.__setattr__(self, "vertices", verts)

    def distances(self, pose, obs: ObstacleSet):
        verts = _body_to_world(pose, const(self.vertices, pose))[..., None, :, :]
        nv = torch.full(verts.shape[:-2], len(self.vertices), dtype=torch.int32,
                        device=pose.device)
        d_pts = point_to_polygon_signed(obs.points, verts, nv)
        d_circ = point_to_polygon_signed(obs.circles, verts, nv) - obs.circle_radii
        cols = [_mask(d_pts, obs.point_mask), _mask(d_circ, obs.circle_mask)]
        if obs.lines.shape[-3]:
            d_line = segment_to_polygon(obs.lines[..., 0, :], obs.lines[..., 1, :], verts, nv)
            cols.append(_mask(d_line, obs.line_mask))
        if obs.polygons.shape[-3]:
            d_poly = polygon_to_polygon(verts, nv, obs.polygons, obs.polygon_nv)
            cols.append(_mask(d_poly, obs.polygon_mask))
        return torch.cat(cols, dim=-1)

    @property
    def inscribed_radius(self):
        """The least distance from the body origin to an edge."""
        v, r = self.vertices, math.inf
        for i, (ax, ay) in enumerate(v):
            bx, by = v[(i + 1) % len(v)]
            abx, aby = bx - ax, by - ay
            t = min(max(-(ax * abx + ay * aby) / max(abx * abx + aby * aby, 1e-12), 0.0), 1.0)
            r = min(r, math.hypot(ax + t * abx, ay + t * aby))
        return r


def disc_footprint(footprint):
    """The footprint as discs on the body x-axis, ((offset, radius), ...):
    one for the point and the disc, two for the two-disc footprint (the
    geometry the fused kernel takes). A subclass is its base's discs, tested
    in JAX ``_footprint_static``'s order (point, disc, two discs)."""
    if isinstance(footprint, PointFootprint):
        return ((0.0, 0.0),)
    if isinstance(footprint, CircularFootprint):
        return ((0.0, footprint.radius),)
    if isinstance(footprint, TwoCirclesFootprint):
        return (
            (footprint.front_offset, footprint.front_radius),
            (footprint.rear_offset, footprint.rear_radius),
        )
    raise TypeError(f"{type(footprint).__name__} is not a disc-family footprint")


FOOTPRINT_TYPES = {
    "point": PointFootprint,
    "circular": CircularFootprint,
    "line": LineFootprint,
    "two_circles": TwoCirclesFootprint,
    "polygon": PolygonFootprint,
}


def make_footprint(footprint_type: str, **kwargs):
    """Factory (parity: getRobotFootprintFromParamServer type switch)."""
    try:
        cls = FOOTPRINT_TYPES[footprint_type]
    except KeyError:
        raise ValueError(
            f"unknown footprint type {footprint_type!r}; options: {sorted(FOOTPRINT_TYPES)}"
        ) from None
    return cls(**kwargs)
