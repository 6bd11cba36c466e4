"""Stage-like multi-room navigation demo (the reference's Stage simulator
demos: maps + move_base's global planner + mpc_local_planner).

Builds a world, plans globally with the A* make_plan analog, drives the
whole LocalPlanner pipeline to the goal (``run_episode``) and renders the
episode (needs matplotlib and PyYAML).

    python -m mpc_local_planner_tpu_torch.examples.demo_rooms [out.png] [scenario] [--device cpu]

scenario ∈ {two_rooms, corridor, clutter} (default two_rooms).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                   "examples", "cfg", "diff_drive_quadratic_form.yaml")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="rooms_scene.png")
    ap.add_argument("scenario", nargs="?", default="two_rooms",
                    choices=("two_rooms", "corridor", "clutter"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    from mpc_local_planner_tpu_torch.planner import load_config
    from mpc_local_planner_tpu_torch.utils.publisher import Publisher
    from mpc_local_planner_tpu_torch.utils.worlds import (
        astar_plan,
        cluttered_room,
        corridor_corner,
        min_clearance,
        run_episode,
        two_rooms,
    )

    worlds = {
        "two_rooms": (two_rooms(door_width=0.8, resolution=0.1),
                      (0.8, 0.8, 0.0), (5.2, 5.2, 0.0)),
        "corridor": (corridor_corner(width=1.1, resolution=0.1),
                     (0.55, 0.55, 0.0), (4.45, 4.45, 1.57)),
        "clutter": (cluttered_room(n_boxes=5, resolution=0.1, seed=3),
                    (0.8, 0.8, 0.0), (5.2, 5.2, 0.0)),
    }
    cm, start, goal = worlds[args.scenario]
    cfg = load_config(CFG)

    reached, traj, vetoes = run_episode(
        cfg, cm, np.asarray(start), np.asarray(goal),
        robot_radius=0.25, max_cycles=250, device=args.device,
    )
    clr = min_clearance(cm, traj)
    print(f"{args.scenario}: reached={reached} cycles={traj.shape[0]} "
          f"vetoes={vetoes} min_clearance={clr:.3f} m")

    plan = astar_plan(cm, start[:2], goal[:2], robot_radius=0.25)
    pub = Publisher()
    pub.publish_global_plan(plan)
    pub.publish_local_plan(traj, label="driven trajectory")
    ys, xs = np.nonzero(cm.data >= 254)
    pub.ax().plot(cm.origin[0] + (xs + 0.5) * cm.resolution,
                  cm.origin[1] + (ys + 0.5) * cm.resolution, "s",
                  color="0.3", markersize=2, label="walls")
    pub.save(args.out, title=f"{args.scenario} | reached={reached}")
    print(f"scene written to {args.out}")


if __name__ == "__main__":
    main()
