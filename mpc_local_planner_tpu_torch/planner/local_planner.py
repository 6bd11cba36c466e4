"""The navigation shell's occupancy grid (port of the ``Costmap`` of
``mpc_local_planner_tpu.planner.local_planner``; the planner shell itself is
ROADMAP item M13).

Host-side numpy: a plain occupancy grid (data H×W uint8, origin, resolution),
the ROS costmap_2d equivalent.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

LETHAL_OBSTACLE = 254  # costmap_2d::LETHAL_OBSTACLE


@dataclasses.dataclass
class Costmap:
    """Occupancy grid (costmap_2d::Costmap2D)."""

    data: np.ndarray      # (H, W) uint8 cost values
    origin: Tuple[float, float]
    resolution: float

    def world_to_map(self, x, y):
        mx = int((x - self.origin[0]) / self.resolution)
        my = int((y - self.origin[1]) / self.resolution)
        return mx, my

    def cell_cost(self, x: float, y: float) -> int:
        mx, my = self.world_to_map(x, y)
        if 0 <= my < self.data.shape[0] and 0 <= mx < self.data.shape[1]:
            return int(self.data[my, mx])
        return LETHAL_OBSTACLE  # off-map = lethal (conservative)
