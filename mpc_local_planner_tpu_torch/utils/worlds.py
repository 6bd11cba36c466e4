"""Stage-like scenario worlds, the grid global planner and the closed-loop
episode runner (port of ``mpc_local_planner_tpu.utils.worlds``).

``mpc_local_planner_examples/{maps,stage}`` ships Stage-simulator worlds
(rooms, corridors, door passages) and relies on move_base's global planner
(navfn/global_planner grid Dijkstra/A*) for the global plan the local
planner tracks. Off-ROS, this module provides the same ingredients for
closed-loop scenario regression:

  * occupancy-grid world builders (walls, door gaps, box clutter, a moving
    pedestrian) emitting the planner's ``Costmap``;
  * ``astar_plan``, the ``make_plan`` analog: 8-connected A* over the
    inflated costmap with line-of-sight shortcutting and headings from the
    segment directions;
  * ``run_episode``: global plan → ``LocalPlanner`` cycles on its device
    (CUDA unless the caller passes ``device="cpu"``) → the simulated robot.

World construction and global planning are host-side numpy: per-episode
setup, not the device path.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

from mpc_local_planner_tpu_torch.planner.local_planner import Costmap

LETHAL = 254


# --------------------------------------------------------------------------- #
# world builders
# --------------------------------------------------------------------------- #
class WorldBuilder:
    """Occupancy-grid scene under construction (world frame, meters)."""

    def __init__(self, width_m: float, height_m: float, resolution: float = 0.05,
                 origin: Tuple[float, float] = (0.0, 0.0)):
        self.resolution = float(resolution)
        self.origin = (float(origin[0]), float(origin[1]))
        H = int(round(height_m / resolution))
        W = int(round(width_m / resolution))
        self.data = np.zeros((H, W), dtype=np.uint8)

    def _to_cells(self, x: float, y: float) -> Tuple[int, int]:
        return (
            int(round((x - self.origin[0]) / self.resolution)),
            int(round((y - self.origin[1]) / self.resolution)),
        )

    def add_box(self, x0: float, y0: float, x1: float, y1: float):
        """Fill the axis-aligned rectangle [x0,x1]×[y0,y1] with lethal cells."""
        cx0, cy0 = self._to_cells(min(x0, x1), min(y0, y1))
        cx1, cy1 = self._to_cells(max(x0, x1), max(y0, y1))
        H, W = self.data.shape
        self.data[max(cy0, 0) : min(cy1 + 1, H), max(cx0, 0) : min(cx1 + 1, W)] = LETHAL
        return self

    def add_wall(self, x0: float, y0: float, x1: float, y1: float,
                 thickness: float = 0.1,
                 gaps: Optional[List[Tuple[float, float]]] = None):
        """Axis-aligned wall from (x0,y0) to (x1,y1) with optional door gaps.

        Each gap is (center_along_wall_m, width_m) measured from the wall's
        start point. Only horizontal or vertical walls are supported (the
        Stage worlds the reference ships are axis-aligned).
        """
        gaps = gaps or []
        if abs(x1 - x0) >= abs(y1 - y0):  # horizontal
            lo, hi = min(x0, x1), max(x0, x1)
            # gap centers are measured from the DECLARED start (x0, y0), so a
            # wall drawn right-to-left places its doors from its own start
            sgn = 1.0 if x1 >= x0 else -1.0
            segs = _split_segments(lo, hi, [(x0 + sgn * c, w) for c, w in gaps])
            for a, b in segs:
                self.add_box(a, y0 - thickness / 2, b, y0 + thickness / 2)
        else:  # vertical
            lo, hi = min(y0, y1), max(y0, y1)
            sgn = 1.0 if y1 >= y0 else -1.0
            segs = _split_segments(lo, hi, [(y0 + sgn * c, w) for c, w in gaps])
            for a, b in segs:
                self.add_box(x0 - thickness / 2, a, x0 + thickness / 2, b)
        return self

    def add_border(self, thickness: float = 0.1):
        H, W = self.data.shape
        t = max(1, int(round(thickness / self.resolution)))
        self.data[:t, :] = LETHAL
        self.data[-t:, :] = LETHAL
        self.data[:, :t] = LETHAL
        self.data[:, -t:] = LETHAL
        return self

    def costmap(self) -> Costmap:
        return Costmap(data=self.data, origin=self.origin, resolution=self.resolution)


def _split_segments(lo: float, hi: float, gaps: List[Tuple[float, float]]):
    """[lo,hi] minus the gap intervals → list of solid segments."""
    edges = sorted((c - w / 2, c + w / 2) for c, w in gaps)
    segs, cur = [], lo
    for a, b in edges:
        if a > cur:
            segs.append((cur, min(a, hi)))
        cur = max(cur, b)
    if cur < hi:
        segs.append((cur, hi))
    return segs


def two_rooms(door_width: float = 0.7, size: float = 6.0,
              resolution: float = 0.05) -> Costmap:
    """Two rooms split by a vertical wall with one door at mid-height.

    Parity: the door-passage scenario of the reference's Stage maps.
    """
    w = WorldBuilder(size, size, resolution)
    w.add_border(0.1)
    w.add_wall(size / 2, 0.0, size / 2, size, thickness=0.15,
               gaps=[(size / 2, door_width)])
    return w.costmap()


def corridor_corner(width: float = 1.0, size: float = 5.0,
                    resolution: float = 0.05) -> Costmap:
    """L-shaped corridor: along the bottom edge then up the right edge."""
    w = WorldBuilder(size, size, resolution)
    w.add_border(0.1)
    # fill everything except the L-corridor
    w.add_box(0.0, width + 0.1, size - width - 0.1, size)
    return w.costmap()


def stamp_disc(costmap: Costmap, cx: float, cy: float, r: float) -> Costmap:
    """Copy of the costmap with a lethal disc added (a moving agent's cells)."""
    data = costmap.data.copy()
    H, W = data.shape
    res = costmap.resolution
    r_cells = max(1, int(round(r / res)))
    mx = int(round((cx - costmap.origin[0]) / res))
    my = int(round((cy - costmap.origin[1]) / res))
    for dy in range(-r_cells, r_cells + 1):
        for dx in range(-r_cells, r_cells + 1):
            if dx * dx + dy * dy > r_cells * r_cells:
                continue
            x, y = mx + dx, my + dy
            if 0 <= x < W and 0 <= y < H:
                data[y, x] = LETHAL
    return Costmap(data=data, origin=costmap.origin, resolution=costmap.resolution)


def pedestrian_crossing(size: float = 6.0, resolution: float = 0.1,
                        ped_start=(3.0, 5.0), ped_vel=(0.0, -0.3),
                        ped_radius: float = 0.15):
    """Open bordered room + a pedestrian crossing on a straight line.

    Returns (costmap_at(t) → Costmap, ped_at(t) → (x, y)). Parity: the
    reference's dynamic-obstacle Stage scenarios (moving agents the
    CostmapToDynamicObstacles pipeline must track and the solver
    anticipate via constant-velocity prediction).
    """
    w = WorldBuilder(size, size, resolution)
    w.add_border(0.1)
    static = w.costmap()

    def ped_at(t: float):
        return (ped_start[0] + ped_vel[0] * t, ped_start[1] + ped_vel[1] * t)

    def costmap_at(t: float) -> Costmap:
        px, py = ped_at(t)
        return stamp_disc(static, px, py, ped_radius)

    return costmap_at, ped_at


def cluttered_room(n_boxes: int = 6, size: float = 6.0, box: float = 0.45,
                   resolution: float = 0.05, seed: int = 0,
                   keepout: float = 0.8) -> Costmap:
    """Random box field with start/goal corners kept clear."""
    rng = np.random.default_rng(seed)
    w = WorldBuilder(size, size, resolution)
    w.add_border(0.1)
    placed = 0
    while placed < n_boxes:
        cx, cy = rng.uniform(0.8, size - 0.8, size=2)
        if np.hypot(cx - 0.8, cy - 0.8) < keepout + box:
            continue
        if np.hypot(cx - (size - 0.8), cy - (size - 0.8)) < keepout + box:
            continue
        w.add_box(cx - box / 2, cy - box / 2, cx + box / 2, cy + box / 2)
        placed += 1
    return w.costmap()


# --------------------------------------------------------------------------- #
# grid global planner (move_base make_plan analog)
# --------------------------------------------------------------------------- #
def inflate(data: np.ndarray, radius_cells: int) -> np.ndarray:
    """Boolean blocked-mask of cells within radius_cells of a lethal cell
    (a disk of that radius in cells)."""
    blocked = data >= LETHAL
    if radius_cells <= 0:
        return blocked
    H, W = blocked.shape
    out = np.zeros_like(blocked)
    r = radius_cells
    offs = [
        (dy, dx)
        for dy in range(-r, r + 1)
        for dx in range(-r, r + 1)
        if dy * dy + dx * dx <= r * r
    ]
    for dy, dx in offs:
        y0, y1 = max(dy, 0), min(H + dy, H)
        x0, x1 = max(dx, 0), min(W + dx, W)
        out[y0:y1, x0:x1] |= blocked[y0 - dy : y1 - dy, x0 - dx : x1 - dx]
    return out


def _line_of_sight(blocked: np.ndarray, a, b) -> bool:
    """True if the straight cell-space segment a→b stays unblocked (sampled
    at half-cell steps)."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    n = int(np.ceil(np.linalg.norm(b - a) * 2)) + 1
    for t in np.linspace(0.0, 1.0, n):
        x, y = a + t * (b - a)
        if blocked[int(round(y)), int(round(x))]:
            return False
    return True


def astar_plan(costmap: Costmap, start_xy, goal_xy, robot_radius: float = 0.2,
               simplify: bool = True) -> np.ndarray:
    """(P, 3) global plan start→goal over the inflated grid; raises
    ``ValueError`` when the start or the goal is blocked or off the map, or
    when no path exists.

    8-connected A* (diagonal cost √2, no corner-cutting past a blocked
    orthogonal neighbour) on the cells clear of obstacles by robot_radius,
    optional line-of-sight shortcutting, the path densified to steps of at
    most three cells, headings from the segment directions (the last pose
    keeps the final segment's heading).
    """
    res = costmap.resolution
    blocked = inflate(costmap.data, int(np.ceil(robot_radius / res)))
    H, W = blocked.shape

    def cell(p):
        return (
            int(round((p[0] - costmap.origin[0]) / res)),
            int(round((p[1] - costmap.origin[1]) / res)),
        )

    start, goal = cell(start_xy), cell(goal_xy)
    for name, (cx, cy) in (("start", start), ("goal", goal)):
        if not (0 <= cx < W and 0 <= cy < H) or blocked[cy, cx]:
            raise ValueError(f"{name} cell {cx, cy} is blocked or off-map")

    nbrs = [(1, 0, 1.0), (-1, 0, 1.0), (0, 1, 1.0), (0, -1, 1.0),
            (1, 1, 2**0.5), (1, -1, 2**0.5), (-1, 1, 2**0.5), (-1, -1, 2**0.5)]
    g = {start: 0.0}
    came = {}
    h0 = np.hypot(goal[0] - start[0], goal[1] - start[1])
    open_q = [(h0, start)]
    closed = set()
    while open_q:
        _, cur = heapq.heappop(open_q)
        if cur == goal:
            break
        if cur in closed:
            continue
        closed.add(cur)
        cx, cy = cur
        for dx, dy, c in nbrs:
            nx, ny = cx + dx, cy + dy
            if not (0 <= nx < W and 0 <= ny < H) or blocked[ny, nx]:
                continue
            if dx and dy and (blocked[cy, nx] or blocked[ny, cx]):
                continue
            ng = g[cur] + c
            if ng < g.get((nx, ny), np.inf):
                g[(nx, ny)] = ng
                came[(nx, ny)] = cur
                f = ng + np.hypot(goal[0] - nx, goal[1] - ny)
                heapq.heappush(open_q, (f, (nx, ny)))
    if goal not in came and goal != start:
        raise ValueError("no path found")

    path = [goal]
    while path[-1] != start:
        path.append(came[path[-1]])
    path.reverse()

    if simplify and len(path) > 2:
        out = [path[0]]
        i = 0
        while i < len(path) - 1:
            j = len(path) - 1
            while j > i + 1 and not _line_of_sight(blocked, path[i], path[j]):
                j -= 1
            out.append(path[j])
            i = j
        path = out

    pts = np.array(
        [
            (costmap.origin[0] + (cx + 0.5) * res, costmap.origin[1] + (cy + 0.5) * res)
            for cx, cy in path
        ]
    )
    dense = [pts[0]]
    for a, b in zip(pts[:-1], pts[1:]):
        n = max(2, int(np.ceil(np.linalg.norm(b - a) / (3 * res))))
        for t in np.linspace(0, 1, n + 1)[1:]:
            dense.append(a + t * (b - a))
    pts = np.array(dense)
    d = np.diff(pts, axis=0)
    theta = np.arctan2(d[:, 1], d[:, 0])
    theta = np.append(theta, theta[-1])
    return np.column_stack([pts, theta])


def run_episode(config, costmap, start, goal,
                robot_radius: float = 0.2, max_cycles: int = 200,
                substeps: int = 6, device=None):
    """Closed-loop navigation episode (parity: one Stage demo run).

    Global A* plan → LocalPlanner cycles, executing each cycle's planned
    control profile by ZOH sub-sampling (variable-dt min-time grids plan
    stages shorter than the control period). ``costmap`` may be a static
    `Costmap` or a callable t → Costmap (worlds with moving agents; the
    global plan uses the t = 0 snapshot). Returns
    (reached: bool, traj (K, 3), n_vetoes: int) — traj carries one pose per
    *attempted* cycle (vetoed cycles repeat the held pose), so traj[k] is
    the robot pose at time k·dt_ref for clearance checks against moving
    agents. The LocalPlanner runs on ``device``; the robot is simulated in
    float64 on the host.
    """
    import torch

    from mpc_local_planner_tpu_torch.planner.local_planner import LocalPlanner

    cm_at = costmap if callable(costmap) else (lambda t: costmap)
    lp = LocalPlanner(config, device=device)
    plan = astar_plan(cm_at(0.0), start[:2], goal[:2], robot_radius=robot_radius)
    lp.set_plan(plan)
    model = lp.controller.spec.model
    x = np.asarray(start, dtype=np.float64).copy()
    u_prev = np.zeros(lp.controller.spec.nu)
    traj = [x.copy()]
    vetoes = 0
    dt_ref = config.grid.dt_ref
    for cycle in range(max_cycles):
        cm = cm_at(cycle * dt_ref)
        twist, res = lp.compute_velocity_commands(x, u_prev, costmap=cm)
        if res is None:
            vetoes += 1
            traj.append(x.copy())
            continue
        h = dt_ref / substeps
        for s in range(substeps):
            u_prev = res.u_seq.interpolate((s + 0.5) * h, mode="zoh").cpu().numpy()
            x = x + h * model.f(torch.from_numpy(x), torch.from_numpy(u_prev)).numpy()
        traj.append(x.copy())
        if lp.is_goal_reached(x):
            return True, np.asarray(traj), vetoes
    return False, np.asarray(traj), vetoes


def min_clearance(costmap: Costmap, traj_xy: np.ndarray) -> float:
    """Minimum distance from any trajectory point to any lethal cell center
    (brute force — fine at test scale)."""
    ys, xs = np.nonzero(costmap.data >= LETHAL)
    if xs.size == 0:
        return np.inf
    cells = np.stack(
        [costmap.origin[0] + (xs + 0.5) * costmap.resolution,
         costmap.origin[1] + (ys + 0.5) * costmap.resolution], axis=1
    )
    d = np.linalg.norm(traj_xy[:, None, :2] - cells[None, :, :], axis=-1)
    return float(d.min())
