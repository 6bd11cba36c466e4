"""Navigation-shell logic without ROS: plan handling, costmap obstacles,
feasibility checks and the per-cycle pipeline (port of
``mpc_local_planner_tpu.planner.local_planner``).

src/mpc_local_planner_ros.cpp :: MpcLocalPlannerROS::{pruneGlobalPlan,
transformGlobalPlan, estimateLocalGoalOrientation,
updateObstacleContainerWithCostmap, updateViaPointsContainer,
isPoseTrajectoryFeasible, computeVelocityCommands} and
base_local_planner::CostmapModel::footprintCost.

Host-side per-cycle work on numpy (not per solver iteration). The costmap is
a plain occupancy grid (data H×W uint8, origin, resolution), the ROS
costmap_2d equivalent. ``native.py`` builds a C++ implementation of the hot
scans (``native/costmap.cpp``, the same algorithms); the functions here are
the reference implementation and the fallback where no compiler is found.
``LocalPlanner`` owns an unbatched ``Controller`` on its device (CUDA unless
the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

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


def prune_global_plan(plan: np.ndarray, robot_xy, dist_behind: float = 1.0) -> np.ndarray:
    """Drop plan poses more than dist_behind behind the robot.

    Parity: MpcLocalPlannerROS::pruneGlobalPlan (erase up to the pose within
    dist of the robot). plan: (P, 3).
    """
    if plan.shape[0] == 0:
        return plan
    d = np.linalg.norm(plan[:, :2] - np.asarray(robot_xy)[None, :], axis=1)
    idx = int(np.argmin(d))
    # keep everything from the closest pose onward, minus the behind margin
    keep_from = idx
    while keep_from > 0 and d[keep_from - 1] < dist_behind:
        keep_from -= 1
    return plan[keep_from:]


def transform_global_plan(
    plan: np.ndarray, robot_pose, max_lookahead: float
) -> np.ndarray:
    """Truncate the (already frame-aligned) plan at the lookahead horizon.

    Parity: MpcLocalPlannerROS::transformGlobalPlan — the ROS version also
    re-frames via tf2; here plans are already in the planning frame, so this
    is the lookahead truncation + nearest-pose rebase.
    """
    if plan.shape[0] == 0:
        return plan
    d = np.linalg.norm(plan[:, :2] - np.asarray(robot_pose)[None, :2], axis=1)
    start = int(np.argmin(d))
    acc = 0.0
    end = start
    for i in range(start + 1, plan.shape[0]):
        acc += float(np.linalg.norm(plan[i, :2] - plan[i - 1, :2]))
        end = i
        if acc > max_lookahead:
            break
    return plan[start : end + 1]


def estimate_local_goal_orientation(
    plan: np.ndarray, look_ahead_poses: int = 3
) -> float:
    """Average heading over the last few plan segments.

    Parity: MpcLocalPlannerROS::estimateLocalGoalOrientation (used with
    global_plan_overwrite_orientation — raw grid-planner goal orientations
    are unreliable).
    """
    n = plan.shape[0]
    if n < 2:
        return float(plan[-1, 2]) if n else 0.0
    k = min(look_ahead_poses, n - 1)
    sin_s = cos_s = 0.0
    for i in range(n - k, n):
        dxy = plan[i, :2] - plan[i - 1, :2]
        th = np.arctan2(dxy[1], dxy[0])
        sin_s += np.sin(th)
        cos_s += np.cos(th)
    return float(np.arctan2(sin_s, cos_s))


def extract_via_points(plan: np.ndarray, separation: float) -> np.ndarray:
    """Sample via points every `separation` meters of arc length.

    Parity: MpcLocalPlannerROS::updateViaPointsContainer
    (global_plan_viapoint_sep). Returns (Mv, 3); empty if separation <= 0.
    """
    if separation <= 0 or plan.shape[0] < 2:
        return np.zeros((0, 3))
    pts = [plan[0]]
    acc = 0.0
    for i in range(1, plan.shape[0]):
        acc += float(np.linalg.norm(plan[i, :2] - plan[i - 1, :2]))
        if acc >= separation:
            pts.append(plan[i])
            acc = 0.0
    return np.asarray(pts[1:]) if len(pts) > 1 else np.zeros((0, 3))


def costmap_to_obstacle_points(
    costmap: Costmap,
    robot_pose,
    behind_dist: float = 1.5,
    cutoff_dist: float = 2.5,
    threshold: int = LETHAL_OBSTACLE,
    force_inclusion_dist: float = 0.0,
) -> np.ndarray:
    """Extract lethal cells as point obstacles around the robot.

    Parity: MpcLocalPlannerROS::updateObstacleContainerWithCostmap — scans
    the local costmap, keeps lethal cells in front (or within behind_dist
    behind) of the robot and within cutoff_dist; cells within
    force_inclusion_dist bypass the direction filter entirely. Returns
    (M, 2) world points.

    Only *boundary* lethal cells (those with a free 4-neighbor, or on the
    map edge) are emitted: interior cells of a solid lethal block can never
    be the nearest-distance minimizer, so dropping them is exact for the
    distance constraints while keeping the obstacle count within the
    solver's static capacity.
    """
    lethal = costmap.data >= threshold
    interior = np.zeros_like(lethal)
    interior[1:-1, 1:-1] = (
        lethal[1:-1, 1:-1]
        & lethal[:-2, 1:-1] & lethal[2:, 1:-1]
        & lethal[1:-1, :-2] & lethal[1:-1, 2:]
    )
    ys, xs = np.nonzero(lethal & ~interior)
    if xs.size == 0:
        return np.zeros((0, 2))
    wx = costmap.origin[0] + (xs + 0.5) * costmap.resolution
    wy = costmap.origin[1] + (ys + 0.5) * costmap.resolution
    p = np.asarray(robot_pose, dtype=np.float64)
    rel = np.stack([wx - p[0], wy - p[1]], axis=1)
    dist = np.linalg.norm(rel, axis=1)
    heading = np.array([np.cos(p[2]), np.sin(p[2])])
    forward = rel @ heading
    keep = (dist <= cutoff_dist) & (
        (forward >= 0.0)
        | (dist <= behind_dist)
        | (dist <= force_inclusion_dist)
    )
    return np.stack([wx[keep], wy[keep]], axis=1)


def _cluster_cells(costmap: Costmap, threshold: int, min_cluster: int):
    """8-connected clustering of lethal cells → list of (K, 2) world points.

    Parity: the DBSCAN front end shared by the costmap_converter plugins
    (python fallback of native cluster_cells)."""
    from scipy import ndimage

    lab, n = ndimage.label(
        costmap.data >= threshold, structure=np.ones((3, 3), dtype=int)
    )
    out = []
    for i in range(1, n + 1):
        ys, xs = np.nonzero(lab == i)
        if xs.size >= min_cluster:
            out.append(
                np.stack(
                    [
                        costmap.origin[0] + (xs + 0.5) * costmap.resolution,
                        costmap.origin[1] + (ys + 0.5) * costmap.resolution,
                    ],
                    axis=1,
                )
            )
    return out


def _line_point_dist(a, b, pts):
    v = b - a
    L = np.linalg.norm(v)
    if L < 1e-12:
        return np.linalg.norm(pts - a[None], axis=1)
    return np.abs(v[0] * (pts[:, 1] - a[1]) - v[1] * (pts[:, 0] - a[0])) / L


def extract_line_segments(
    costmap: Costmap,
    threshold: int = LETHAL_OBSTACLE,
    min_cluster: int = 2,
    inlier_dist: float = 0.08,
    min_inliers: int = 4,
    max_out: int = 64,
) -> np.ndarray:
    """Line-segment obstacles via per-cluster dominant-line extraction.

    Parity: costmap_converter :: CostmapToLinesDBSRANSAC (DBSCAN clusters +
    RANSAC line fits); deterministic hull-pair scoring replaces the random
    sampling. Python fallback of native mpc_costmap_extract_lines.
    Returns (L, 2, 2) segment endpoints.
    """
    from scipy.spatial import ConvexHull

    segs = []
    for cells in _cluster_cells(costmap, threshold, min_cluster):
        used = np.zeros(cells.shape[0], dtype=bool)
        while (~used).sum() >= min_inliers and len(segs) < max_out:
            rem = cells[~used]
            if rem.shape[0] >= 3:
                try:
                    hull = rem[ConvexHull(rem).vertices]
                except Exception:  # degenerate (collinear) clusters
                    hull = rem
            else:
                hull = rem
            best_cnt, best_ab = -1, None
            for i in range(hull.shape[0]):
                for j in range(i + 1, hull.shape[0]):
                    cnt = int(
                        (_line_point_dist(hull[i], hull[j], rem) <= inlier_dist).sum()
                    )
                    if cnt > best_cnt:
                        best_cnt, best_ab = cnt, (hull[i], hull[j])
            if best_cnt < min_inliers or best_ab is None:
                break
            a, b = best_ab
            v = b - a
            L = np.linalg.norm(v)
            if L < 1e-12:
                break
            v = v / L
            d = _line_point_dist(a, b, cells)
            inl = (~used) & (d <= inlier_dist)
            t = (cells[inl] - a[None]) @ v
            segs.append(
                np.stack([a + t.min() * v, a + t.max() * v], axis=0)
            )
            used |= inl
    return (
        np.asarray(segs) if segs else np.zeros((0, 2, 2))
    )


def cluster_centroids(
    costmap: Costmap,
    threshold: int = LETHAL_OBSTACLE,
    min_cluster: int = 2,
    max_out: int = 64,
) -> np.ndarray:
    """Blob detection: per-cluster (cx, cy, bounding radius).

    Parity: the blob front end of CostmapToDynamicObstacles (python fallback
    of native mpc_costmap_cluster_centroids)."""
    out = []
    for cells in _cluster_cells(costmap, threshold, min_cluster)[:max_out]:
        c = cells.mean(axis=0)
        r = float(np.max(np.linalg.norm(cells - c[None], axis=1)))
        out.append([c[0], c[1], r + 0.5 * costmap.resolution])
    return np.asarray(out) if out else np.zeros((0, 3))


def tracker_update(
    prev_tracks: np.ndarray,
    centroids: np.ndarray,
    dt: float,
    gate_dist: float = 0.6,
    vel_alpha: float = 0.5,
    next_id: int = 0,
    max_out: int = 64,
    max_missed: int = 2,
):
    """Greedy nearest-neighbor blob tracker with exponential velocity
    smoothing and coasting. Tracks: rows (id, x, y, vx, vy, age, missed,
    radius). Parity: CostmapToDynamicObstacles velocity estimation — its
    Kalman tracks survive missed detections; here an unmatched track coasts
    on its constant-velocity prediction for up to ``max_missed`` frames
    before being dropped, so one clustering flicker does not reset a moving
    obstacle's smoothed velocity to zero (and demote it to background).
    ``centroids``: (M, 2) xy or (M, 3) xy + bounding radius. Matching gates
    against the PREDICTED position (x + vx·dt). Python fallback of native
    mpc_tracker_update. Returns (tracks, next_id)."""
    prev = np.asarray(prev_tracks, dtype=np.float64).reshape(-1, 8)
    cur = np.asarray(centroids, dtype=np.float64)
    cur = cur.reshape(-1, cur.shape[-1] if cur.size else 2)
    radii = cur[:, 2] if cur.shape[-1] > 2 else np.zeros(cur.shape[0])
    pred = prev[:, 1:3] + dt * prev[:, 3:5]
    used = np.zeros(prev.shape[0], dtype=bool)
    rows = []
    for c, r in zip(cur[:max_out, :2], radii[:max_out]):
        best, best_d = -1, gate_dist
        for p in range(prev.shape[0]):
            if used[p]:
                continue
            d = float(np.linalg.norm(c - pred[p]))
            if d < best_d:
                best, best_d = p, d
        if best >= 0 and dt > 1e-9:
            used[best] = True
            mv = (c - prev[best, 1:3]) / dt
            v = vel_alpha * mv + (1.0 - vel_alpha) * prev[best, 3:5]
            rows.append([prev[best, 0], c[0], c[1], v[0], v[1],
                         prev[best, 5] + 1, 0.0, r])
        else:
            rows.append([next_id, c[0], c[1], 0.0, 0.0, 0.0, 0.0, r])
            next_id += 1
    # coast unmatched tracks on their constant-velocity prediction
    for p in range(prev.shape[0]):
        if used[p] or prev[p, 6] + 1 > max_missed:
            continue
        if len(rows) >= max_out:
            break
        rows.append([prev[p, 0], pred[p, 0], pred[p, 1],
                     prev[p, 3], prev[p, 4], prev[p, 5] + 1,
                     prev[p, 6] + 1, prev[p, 7]])
    return (
        np.asarray(rows) if rows else np.zeros((0, 8)),
        next_id,
    )


def footprint_cost(
    costmap: Costmap, pose, footprint_radius: float = 0.0
) -> float:
    """Cost of a pose against the costmap (disc footprint).

    Parity: base_local_planner::CostmapModel::footprintCost — returns < 0 on
    collision. Simplified to an inscribed-circle test over covered cells.
    """
    cx, cy = float(pose[0]), float(pose[1])
    if footprint_radius <= 0:
        c = costmap.cell_cost(cx, cy)
        return -1.0 if c >= LETHAL_OBSTACLE else float(c)
    r_cells = max(1, int(np.ceil(footprint_radius / costmap.resolution)))
    mx, my = costmap.world_to_map(cx, cy)
    worst = 0.0
    H, W = costmap.data.shape
    for dy in range(-r_cells, r_cells + 1):
        for dx in range(-r_cells, r_cells + 1):
            if dx * dx + dy * dy > r_cells * r_cells:
                continue
            x, y = mx + dx, my + dy
            c = (
                int(costmap.data[y, x])
                if (0 <= y < H and 0 <= x < W)
                else LETHAL_OBSTACLE
            )
            if c >= LETHAL_OBSTACLE:
                return -1.0
            worst = max(worst, float(c))
    return worst


def is_pose_trajectory_feasible(
    costmap: Costmap,
    xs: np.ndarray,
    footprint_radius: float = 0.0,
    check_poses: int = -1,
    min_resolution_angular: float = np.pi,
) -> bool:
    """Post-solve collision veto of the planned states against the costmap.

    Parity: MpcLocalPlannerROS::isPoseTrajectoryFeasible
    (collision_check_no_poses / collision_check_min_resolution_angular —
    intermediate poses are interpolated when consecutive states differ too
    much in heading).
    """
    n = xs.shape[0] if check_poses < 0 else min(check_poses, xs.shape[0])
    for i in range(n):
        if footprint_cost(costmap, xs[i], footprint_radius) < 0:
            return False
        if i + 1 < n:
            dth = abs(float(np.mod(xs[i + 1, 2] - xs[i, 2] + np.pi, 2 * np.pi) - np.pi))
            if dth > min_resolution_angular:
                mid = 0.5 * (xs[i] + xs[i + 1])
                if footprint_cost(costmap, mid, footprint_radius) < 0:
                    return False
    return True


class LocalPlanner:
    """End-to-end per-cycle pipeline (computeVelocityCommands).

    Owns an unbatched Controller plus the plan/obstacle/feasibility logic:
    the ``test_mpc_optim_node``-style standalone mode. Feed it a global
    plan, a costmap and odometry; get twists back. ``device``: the
    Controller's (CUDA unless the caller passes ``"cpu"``).
    """

    def __init__(self, config, dtype=torch.float32, device=None):
        from mpc_local_planner_tpu_torch.planner.controller import Controller

        self.config = config
        # single-robot by design (one planner per ROS nav stack); fleets
        # batch at the Controller level (Controller(config, batch=K)) — the
        # plan/costmap pipeline here is per-robot host code
        self.controller = Controller(config, dtype=dtype, device=device)
        self._global_plan: Optional[np.ndarray] = None
        #: last OptimalControlResult when controller.publish_ocp_results is
        #: set (the "mpc/ocp_result" topic)
        self.last_ocp_result = None
        # dynamic-obstacle tracker state (costmap_converter == "dynamic";
        # persists across plans — map obstacles outlive any one goal)
        self._tracks = np.zeros((0, 8))
        self._next_track_id = 0

    def set_plan(self, plan: np.ndarray) -> None:
        """MpcLocalPlannerROS::setPlan."""
        self._global_plan = np.asarray(plan, dtype=np.float64)
        self.controller.reset()

    def set_state_feedback(self, state, stamp: float = 0.0) -> None:
        """External state estimate (Controller::stateFeedbackCallback
        consuming mpc_local_planner_msgs/StateFeedback)."""
        self._state_feedback = np.asarray(state, dtype=np.float64)
        self._state_feedback_stamp = stamp

    def _obstacles(self, costmap, pose, extra_obstacles):
        """The cycle's ObstacleSet on the Controller's device: costmap cells
        through the configured converter mode (points / polygons / lines /
        dynamic, the native scans where they are built) and the custom
        circles, padded to the spec's capacities."""
        from mpc_local_planner_tpu_torch import native
        from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet

        col = self.config.collision
        mode = col.costmap_converter
        pts = np.zeros((0, 2))
        polys: list = []
        line_segs = np.zeros((0, 2, 2))
        dyn_circles: list = []
        dyn_vels: list = []
        poly_cap = col.polygon_capacity if mode == "polygons" else 0
        line_cap = col.line_capacity if mode == "lines" else 0
        dyn_cap = col.dynamic_capacity if mode == "dynamic" else 0
        have_native = native.available()
        if costmap is not None and col.include_costmap_obstacles:
            if mode == "polygons" and have_native:
                raw = native.extract_polygons(
                    costmap,
                    max_polys=col.polygon_capacity,
                    max_total_verts=col.polygon_capacity
                    * max(col.max_polygon_vertices, 8)
                    * 4,
                )
                for hull in raw:
                    if hull.shape[0] > col.max_polygon_vertices:
                        # decimate oversize hulls to the static vertex budget
                        idx = np.linspace(
                            0, hull.shape[0] - 1, col.max_polygon_vertices
                        ).astype(int)
                        hull = hull[idx]
                    polys.append(hull)
            elif mode == "lines":
                fn = native.extract_lines if have_native else extract_line_segments
                line_segs = fn(
                    costmap,
                    inlier_dist=col.line_inlier_dist,
                    min_inliers=col.line_min_inliers,
                    max_out=col.line_capacity,
                )
            elif mode == "dynamic":
                fn = native.cluster_centroids if have_native else cluster_centroids
                cen = fn(costmap, max_out=col.dynamic_capacity)
                upd = native.tracker_update if have_native else tracker_update
                self._tracks, self._next_track_id = upd(
                    self._tracks, cen if cen.size else np.zeros((0, 3)),
                    dt=self.config.grid.dt_ref,
                    gate_dist=col.tracker_gate_dist,
                    vel_alpha=col.tracker_vel_alpha,
                    next_id=self._next_track_id,
                    max_out=col.dynamic_capacity,
                    max_missed=col.tracker_max_missed,
                )
                # foreground/background separation (the reference's
                # CostmapToDynamicObstacles subtracts a background model and
                # chains a static converter for it): only tracks moving at
                # ≥ dynamic_min_speed become velocity-carrying circles, from
                # the TRACKS (a track coasting through a missed detection
                # keeps constraining the solver); everything else goes
                # through the static point path below, with the fast blobs'
                # cells excluded so a pedestrian is not also a frozen point
                # cloud the solver could never clear
                exclusions = []  # (cx, cy, r) of fast blobs
                for row in self._tracks:
                    if np.hypot(row[3], row[4]) >= col.dynamic_min_speed:
                        dyn_circles.append((row[1], row[2], row[7]))
                        dyn_vels.append((row[3], row[4]))
                        exclusions.append((row[1], row[2], row[7]))
                pfn = native.extract_points if have_native else costmap_to_obstacle_points
                pts = pfn(
                    costmap, pose, col.costmap_obstacles_behind_robot_dist,
                    col.cutoff_dist,
                    force_inclusion_dist=col.force_inclusion_dist,
                )
                for ex, ey, er in exclusions:
                    keep = (
                        np.hypot(pts[:, 0] - ex, pts[:, 1] - ey)
                        > er + costmap.resolution
                    )
                    pts = pts[keep]
            else:  # "points"
                fn = native.extract_points if have_native else costmap_to_obstacle_points
                pts = fn(
                    costmap, pose, col.costmap_obstacles_behind_robot_dist,
                    col.cutoff_dist,
                    force_inclusion_dist=col.force_inclusion_dist,
                )
        cap = col.obstacle_capacity
        if pts.shape[0] > cap:
            # keep the nearest cap points (cutoff radius, then nearest)
            d = np.linalg.norm(pts - pose[None, :2], axis=1)
            pts = pts[np.argsort(d)[:cap]]
        extras = list(extra_obstacles)[: col.circle_capacity] if extra_obstacles else []
        circles = extras + dyn_circles[:dyn_cap]
        circle_vels = [(0.0, 0.0)] * len(extras) + dyn_vels[:dyn_cap]
        return ObstacleSet.from_lists(
            points=list(pts),
            circles=circles,
            circle_vels=circle_vels if any(v != (0.0, 0.0) for v in circle_vels) else None,
            lines=list(line_segs[:line_cap]),
            polygons=polys[:poly_cap] if poly_cap else None,
            capacities=(cap, col.circle_capacity + dyn_cap, line_cap, poly_cap),
            max_polygon_vertices=col.max_polygon_vertices,
            device=self.controller.device,
        )

    def compute_velocity_commands(
        self,
        robot_pose,
        robot_vel,
        costmap: Optional[Costmap] = None,
        extra_obstacles=None,
    ):
        """One control cycle. Returns (twist (3,) numpy, ControlResult | None).

        prune → transform → obstacles → via points → Controller.step →
        feasibility veto. With prefer_x_feedback set and a state feedback
        message present, the fed-back state replaces odometry
        (RobotDynamicsInterface::mergeStateFeedbackAndOdomFeedback).
        """
        from mpc_local_planner_tpu_torch import native
        from mpc_local_planner_tpu_torch.ocp.spec import Scenario

        if self._global_plan is None or self._global_plan.shape[0] == 0:
            raise RuntimeError("no global plan set")
        c = self.config.controller
        col = self.config.collision
        pose = np.asarray(robot_pose, dtype=np.float64)
        fb = getattr(self, "_state_feedback", None)
        if c.prefer_x_feedback and fb is not None:
            pose = self.controller.spec.model.merge_state_feedback_and_odom(
                fb, pose, prefer_feedback=True
            )
            pose = np.asarray(pose, dtype=np.float64)

        self._global_plan = prune_global_plan(
            self._global_plan, pose[:2], c.global_plan_prune_distance
        )
        local = transform_global_plan(
            self._global_plan, pose, c.max_global_plan_lookahead_dist
        )
        if local.shape[0] == 0:
            raise RuntimeError("plan left the local horizon")
        goal = local[-1].copy()
        if c.global_plan_overwrite_orientation:
            goal[2] = estimate_local_goal_orientation(local)

        obs = self._obstacles(costmap, pose, extra_obstacles)

        via = extract_via_points(local, c.global_plan_viapoint_sep)
        vcap = self.config.via_capacity
        via_pad = np.zeros((vcap, 3))
        nv = min(via.shape[0], vcap)
        via_pad[:nv] = via[:nv]
        via_mask = np.arange(vcap) < nv

        spec = self.controller.spec
        dev = self.controller.device

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(dev)

        scen = Scenario(
            x0=f32(pose),
            xf=f32(goal),
            obstacles=obs,
            via_points=f32(via_pad),
            via_mask=torch.as_tensor(via_mask).to(dev),
            u_prev=f32(np.asarray(robot_vel)[: spec.nu]),
        )
        result = self.controller.step(scen, plan=f32(local), elapsed=self.config.grid.dt_ref)

        # post-solve feasibility veto against the raw costmap
        if costmap is not None:
            xs = result.x_seq.values.cpu().numpy()
            radius = getattr(spec.footprint, "inscribed_radius", 0.0)
            check = native.trajectory_feasible if native.available() else (
                is_pose_trajectory_feasible)
            feasible = check(
                costmap, xs, footprint_radius=radius,
                check_poses=col.collision_check_no_poses,
                min_resolution_angular=col.collision_check_min_resolution_angular,
            )
            if not feasible:
                self.controller.reset()
                return np.zeros(3), None

        # the reference applies u0 whenever the solver returned a solution
        # (optimal_solution_found is informational; the costmap check above
        # is the safety gate); only a diverged solve (NaN / blown-up state)
        # zeroes the command and drops the warm start
        eq = result.solve.eq_norm.cpu().numpy()
        viol = result.solve.ineq_viol.cpu().numpy()
        diverged = ~np.isfinite(eq) | ~np.isfinite(viol) | (eq > 0.5) | (viol > 0.5)
        if bool(np.any(diverged)):
            self.controller.reset()
            return np.zeros(3), None
        if c.publish_ocp_results:
            from mpc_local_planner_tpu_torch.msgs import OptimalControlResult

            self.last_ocp_result = OptimalControlResult.from_control_result(result)
        return result.twist.cpu().numpy(), result

    def is_goal_reached(self, robot_pose) -> bool:
        if self._global_plan is None or self._global_plan.shape[0] == 0:
            return False
        goal = self._global_plan[-1]
        return self.controller.is_goal_reached(
            torch.as_tensor(np.asarray(robot_pose)), torch.as_tensor(goal)
        )
