"""Fixed-shape batched obstacle containers (port of
``mpc_local_planner_tpu.geometry.obstacles``).

An ObstacleSet is a struct-of-arrays dataclass with fixed per-type capacities
and boolean active masks. Every field keeps the JAX package's name, shape and
dtype, so the converters round-trip.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import register_pytree_node

# distance reported for padded (inactive) slots — large but finite so AD never
# sees inf arithmetic
BIG_DISTANCE = 1.0e6

# number of trailing (non-batch) dims of each field
_TRAILING = {
    "points": 2, "point_vels": 2, "point_mask": 1,
    "circles": 2, "circle_radii": 1, "circle_vels": 2, "circle_mask": 1,
    "lines": 3, "line_vels": 2, "line_mask": 1,
    "polygons": 3, "polygon_nv": 1, "polygon_vels": 2, "polygon_mask": 1,
}


@dataclasses.dataclass(frozen=True)
class ObstacleSet:
    """Struct-of-arrays obstacle container; leading batch dims on every field."""

    points: torch.Tensor        # (..., Mp, 2)
    point_vels: torch.Tensor    # (..., Mp, 2)
    point_mask: torch.Tensor    # (..., Mp) bool

    circles: torch.Tensor       # (..., Mc, 2) centers
    circle_radii: torch.Tensor  # (..., Mc)
    circle_vels: torch.Tensor   # (..., Mc, 2)
    circle_mask: torch.Tensor   # (..., Mc) bool

    lines: torch.Tensor         # (..., Ml, 2, 2) endpoints
    line_vels: torch.Tensor     # (..., Ml, 2)
    line_mask: torch.Tensor     # (..., Ml) bool

    polygons: torch.Tensor      # (..., Mg, V, 2) padded vertices
    polygon_nv: torch.Tensor    # (..., Mg) int32 active vertex counts
    polygon_vels: torch.Tensor  # (..., Mg, 2)
    polygon_mask: torch.Tensor  # (..., Mg) bool

    @property
    def batch_ndim(self) -> int:
        return self.points.dim() - 2

    @property
    def capacities(self) -> Tuple[int, int, int, int]:
        return (
            self.points.shape[-2],
            self.circles.shape[-2],
            self.lines.shape[-3],
            self.polygons.shape[-3],
        )

    @property
    def total_capacity(self) -> int:
        return sum(self.capacities)

    def masks_concat(self) -> torch.Tensor:
        return torch.cat(
            [self.point_mask, self.circle_mask, self.line_mask, self.polygon_mask], dim=-1
        )

    def num_active(self) -> torch.Tensor:
        return self.masks_concat().sum(dim=-1, dtype=torch.int32)

    def total_slots(self) -> int:
        """Number of padded obstacle slots across all four families."""
        return self.total_capacity

    def padded_to(self, target_total: int) -> "ObstacleSet":
        """Pad with inactive POINT slots until ``total_slots() == target_total``
        (a scenario built with fewer slots than ``spec.obstacle_cap``, such as
        ``Scenario.goal_only`` under an obstacle-enabled config). Raises if
        over capacity."""
        cur = self.total_slots()
        if cur == target_total:
            return self
        if cur > target_total:
            raise ValueError(
                f"scenario has {cur} obstacle slots but the spec's "
                f"obstacle_cap is {target_total}; raise "
                "collision.obstacle_capacity or trim the obstacle set"
            )
        extra = target_total - cur
        batch = self.points.shape[:-2]
        zp = self.points.new_zeros(batch + (extra, 2))
        return dataclasses.replace(
            self,
            points=torch.cat([self.points, zp], dim=-2),
            point_vels=torch.cat([self.point_vels, zp], dim=-2),
            point_mask=torch.cat(
                [self.point_mask, self.point_mask.new_zeros(batch + (extra,))], dim=-1
            ),
        )

    def _map(self, fn):
        return ObstacleSet(
            **{name: fn(name, getattr(self, name)) for name in _TRAILING}
        )

    def predict(self, t) -> "ObstacleSet":
        """Constant-velocity extrapolation of every obstacle to time t
        (t has the set's batch shape)."""
        tt = t[..., None, None]
        return dataclasses.replace(
            self,
            points=self.points + self.point_vels * tt,
            circles=self.circles + self.circle_vels * tt,
            lines=self.lines + (self.line_vels * tt)[..., None, :],
            polygons=self.polygons + (self.polygon_vels * tt)[..., None, :],
        )

    def with_stage_axis(self) -> "ObstacleSet":
        """Insert a singleton stage axis right after the batch dims, so that
        the set broadcasts against per-stage poses (..., S, 3)."""
        nb = self.batch_ndim
        return self._map(lambda _n, a: a.unsqueeze(nb))

    def predict_stages(self, times) -> "ObstacleSet":
        """Per-stage predicted sets: ``times`` (..., T) with the set's batch
        dims in front; every leaf gains a stage axis (..., T, M, ...)."""
        nb = self.batch_ndim
        pred = self.with_stage_axis().predict(times)
        T = times.shape[-1]

        def expand(name, a):
            shape = list(a.shape)
            shape[nb] = T
            return a.expand(shape)

        return pred._map(expand)

    @staticmethod
    def empty(
        max_points: int = 0,
        max_circles: int = 0,
        max_lines: int = 0,
        max_polygons: int = 0,
        max_polygon_vertices: int = 8,
        dtype=torch.float32,
        device="cpu",
        batch: Tuple[int, ...] = (),
    ) -> "ObstacleSet":
        batch = tuple(batch)

        def z(*s, dt=dtype):
            return torch.zeros(batch + s, dtype=dt, device=device)

        return ObstacleSet(
            points=z(max_points, 2), point_vels=z(max_points, 2),
            point_mask=z(max_points, dt=torch.bool),
            circles=z(max_circles, 2), circle_radii=z(max_circles),
            circle_vels=z(max_circles, 2), circle_mask=z(max_circles, dt=torch.bool),
            lines=z(max_lines, 2, 2), line_vels=z(max_lines, 2),
            line_mask=z(max_lines, dt=torch.bool),
            polygons=z(max_polygons, max_polygon_vertices, 2),
            polygon_nv=z(max_polygons, dt=torch.int32),
            polygon_vels=z(max_polygons, 2), polygon_mask=z(max_polygons, dt=torch.bool),
        )

    @staticmethod
    def from_lists(
        points: Optional[Sequence] = None,
        circles: Optional[Sequence] = None,   # (x, y, r)
        lines: Optional[Sequence] = None,     # ((x1, y1), (x2, y2))
        polygons: Optional[Sequence] = None,  # [(x, y), ...] each
        point_vels: Optional[Sequence] = None,
        circle_vels: Optional[Sequence] = None,
        line_vels: Optional[Sequence] = None,
        polygon_vels: Optional[Sequence] = None,
        capacities: Optional[Tuple[int, int, int, int]] = None,
        max_polygon_vertices: Optional[int] = None,
        dtype=torch.float32,
        device="cpu",
    ) -> "ObstacleSet":
        """Build a padded set from Python lists on the host, then move it to
        ``device``. A polygon's padding repeats its last vertex, so the padded
        edges are degenerate."""
        points = list(points or [])
        circles = list(circles or [])
        lines = list(lines or [])
        polygons = [np.asarray(pg, dtype=np.float64) for pg in (polygons or [])]
        if capacities is None:
            capacities = (len(points), len(circles), len(lines), len(polygons))
        mp, mc, ml, mg = capacities
        if max_polygon_vertices is None:
            max_polygon_vertices = max([pg.shape[0] for pg in polygons], default=3)

        obs = ObstacleSet.empty(mp, mc, ml, mg, max_polygon_vertices, dtype=dtype,
                                device=device)

        def tensor(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt).to(device)

        def fill(rows, shape):
            a = np.zeros(shape, dtype=np.float64)
            for i, r in enumerate(rows):
                a[i] = np.asarray(r, dtype=np.float64)
            return tensor(a)

        def fill_mask(m, n):
            return tensor(np.arange(m) < n, torch.bool)

        upd = {}
        if mp:
            upd["points"] = fill(points, (mp, 2))
            upd["point_mask"] = fill_mask(mp, len(points))
            if point_vels:
                upd["point_vels"] = fill(point_vels, (mp, 2))
        if mc:
            carr = fill(circles, (mc, 3))
            upd["circles"] = carr[:, :2].contiguous()
            upd["circle_radii"] = carr[:, 2].contiguous()
            upd["circle_mask"] = fill_mask(mc, len(circles))
            if circle_vels:
                upd["circle_vels"] = fill(circle_vels, (mc, 2))
        if ml:
            upd["lines"] = fill(lines, (ml, 2, 2))
            upd["line_mask"] = fill_mask(ml, len(lines))
            if line_vels:
                upd["line_vels"] = fill(line_vels, (ml, 2))
        if mg:
            parr = np.zeros((mg, max_polygon_vertices, 2))
            nv = np.zeros((mg,), dtype=np.int32)
            for i, pg in enumerate(polygons):
                n = pg.shape[0]
                parr[i, :n] = pg
                parr[i, n:] = pg[-1]
                nv[i] = n
            upd["polygons"] = tensor(parr)
            upd["polygon_nv"] = tensor(nv, torch.int32)
            upd["polygon_mask"] = fill_mask(mg, len(polygons))
            if polygon_vels:
                upd["polygon_vels"] = fill(polygon_vels, (mg, 2))
        return dataclasses.replace(obs, **upd)


register_pytree_node(
    ObstacleSet,
    lambda o: ([getattr(o, n) for n in _TRAILING], None),
    lambda leaves, _ctx: ObstacleSet(*leaves),
)
