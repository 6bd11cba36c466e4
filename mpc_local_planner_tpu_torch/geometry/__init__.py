"""Obstacle and footprint geometry (port of
``mpc_local_planner_tpu.geometry``)."""

from mpc_local_planner_tpu_torch.geometry.distances import (  # noqa: F401
    point_to_point,
    point_to_segment,
    segment_to_segment,
    point_to_polygon_signed,
)
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet  # noqa: F401
from mpc_local_planner_tpu_torch.geometry.footprints import (  # noqa: F401
    PointFootprint,
    CircularFootprint,
    LineFootprint,
    TwoCirclesFootprint,
    PolygonFootprint,
    make_footprint,
    FOOTPRINT_TYPES,
)
