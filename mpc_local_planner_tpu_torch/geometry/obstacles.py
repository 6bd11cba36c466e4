"""Fixed-shape batched obstacle containers (port of
``mpc_local_planner_tpu.geometry.obstacles``).

An ObstacleSet is a struct-of-arrays dataclass with fixed per-type capacities
and boolean active masks. Every field keeps the JAX package's name, shape and
dtype, so the converters round-trip; this slice's distance functions read the
point and circle slots only.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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


register_pytree_node(
    ObstacleSet,
    lambda o: ([getattr(o, n) for n in _TRAILING], None),
    lambda leaves, _ctx: ObstacleSet(*leaves),
)
