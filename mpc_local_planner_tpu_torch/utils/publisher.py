"""Visualization publisher (port of ``mpc_local_planner_tpu.utils.publisher``).

mpc_local_planner ``utils/publisher.h/.cpp`` :: Publisher —
publishLocalPlan / publishGlobalPlan / publishObstacles / publishViaPoints /
publishRobotFootprintModel (RViz markers). Without ROS, the sink is a
matplotlib axes (interactive or file export) — the visual-inspection loop of
the reference's manual validation strategy (SURVEY.md §5).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from mpc_local_planner_tpu_torch.core.tree import leaf_numpy


class Publisher:
    """Draws planner state onto a matplotlib axes."""

    def __init__(self, ax=None):
        self._ax = ax

    # -- lazily create the axes so headless use without plots costs nothing
    def ax(self):
        if self._ax is None:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            _, self._ax = plt.subplots(figsize=(7, 7))
            self._ax.set_aspect("equal")
        return self._ax

    def publish_local_plan(self, xs, **kw):
        """Planned trajectory (parity: publishLocalPlan → nav_msgs/Path)."""
        xs = leaf_numpy(xs)
        self.ax().plot(xs[:, 0], xs[:, 1], "-o", markersize=2.5,
                       color=kw.get("color", "tab:blue"), label=kw.get("label", "local plan"))

    def publish_global_plan(self, plan, **kw):
        plan = leaf_numpy(plan)
        self.ax().plot(plan[:, 0], plan[:, 1], "--", color=kw.get("color", "tab:green"),
                       label=kw.get("label", "global plan"))

    def publish_obstacles(self, obstacles, **kw):
        """Obstacle markers (parity: publishObstacles)."""
        import matplotlib.patches as mp

        ax = self.ax()
        color = kw.get("color", "tab:red")
        pts = leaf_numpy(obstacles.points)
        mask = leaf_numpy(obstacles.point_mask)
        if pts.size:
            ax.plot(pts[mask, 0], pts[mask, 1], ".", color=color)
        centers = leaf_numpy(obstacles.circles)
        radii = leaf_numpy(obstacles.circle_radii)
        for c, r, m in zip(centers, radii, leaf_numpy(obstacles.circle_mask)):
            if m:
                ax.add_patch(mp.Circle(c, r, fill=False, color=color))
        lines = leaf_numpy(obstacles.lines)
        for seg, m in zip(lines, leaf_numpy(obstacles.line_mask)):
            if m:
                ax.plot(seg[:, 0], seg[:, 1], "-", color=color)
        polys = leaf_numpy(obstacles.polygons)
        nv = leaf_numpy(obstacles.polygon_nv)
        for pg, n, m in zip(polys, nv, leaf_numpy(obstacles.polygon_mask)):
            if m:
                closed = np.vstack([pg[:n], pg[:1]])
                ax.plot(closed[:, 0], closed[:, 1], "-", color=color)

    def publish_via_points(self, via_points, via_mask=None, **kw):
        vp = leaf_numpy(via_points)
        if via_mask is not None:
            vp = vp[leaf_numpy(via_mask)]
        if vp.size:
            self.ax().plot(vp[:, 0], vp[:, 1], "x", color=kw.get("color", "tab:orange"),
                           label=kw.get("label", "via points"))

    def publish_robot_footprint(self, pose, footprint, **kw):
        """Footprint outline at a pose (parity: publishRobotFootprintModel)."""
        import matplotlib.patches as mp

        from mpc_local_planner_tpu_torch.geometry import footprints as fp

        ax = self.ax()
        color = kw.get("color", "tab:purple")
        pose = leaf_numpy(pose)
        c, s = np.cos(pose[2]), np.sin(pose[2])
        R = np.array([[c, -s], [s, c]])
        if isinstance(footprint, fp.CircularFootprint):
            ax.add_patch(mp.Circle(pose[:2], footprint.radius, fill=False, color=color))
        elif isinstance(footprint, fp.TwoCirclesFootprint):
            for off, r in ((footprint.front_offset, footprint.front_radius),
                           (footprint.rear_offset, footprint.rear_radius)):
                ax.add_patch(mp.Circle(pose[:2] + R @ np.array([off, 0.0]), r,
                                       fill=False, color=color))
        elif isinstance(footprint, fp.LineFootprint):
            a = pose[:2] + R @ leaf_numpy(footprint.line_start)
            b = pose[:2] + R @ leaf_numpy(footprint.line_end)
            ax.plot([a[0], b[0]], [a[1], b[1]], "-", color=color)
        elif isinstance(footprint, fp.PolygonFootprint):
            v = pose[:2] + (R @ leaf_numpy(footprint.vertices).T).T
            closed = np.vstack([v, v[:1]])
            ax.plot(closed[:, 0], closed[:, 1], "-", color=color)
        else:  # point
            ax.plot([pose[0]], [pose[1]], "+", color=color)

    def save(self, path: str, title: Optional[str] = None):
        ax = self.ax()
        if title:
            ax.set_title(title)
        ax.legend(loc="best", fontsize=8)
        ax.figure.savefig(path, dpi=120, bbox_inches="tight")
