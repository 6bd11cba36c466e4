"""Grid global planner (port of the planner part of
``mpc_local_planner_tpu.utils.worlds``; its world builders and the episode
runner come with ROADMAP item M13).

move_base hands the local planner a global plan from a grid planner over the
inflated costmap; ``astar_plan`` is that ``make_plan`` analog: 8-connected A*
with line-of-sight shortcutting and headings from the segment directions.
Host-side numpy: global planning is per-episode setup, not the device path.
"""

from __future__ import annotations

import heapq

import numpy as np

from mpc_local_planner_tpu_torch.planner.local_planner import Costmap

LETHAL = 254


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
