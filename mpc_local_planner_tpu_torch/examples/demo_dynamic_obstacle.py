"""Dynamic-obstacle demo: anticipating a crossing pedestrian.

A diff-drive robot heads straight to a goal while a circular obstacle
crosses its path at constant velocity. With
collision.enable_dynamic_obstacles the solver constrains against the
*predicted* obstacle positions at each stage time (StageInequalitySE2's
constant-velocity extrapolation), so the robot yields before the crossing
instead of reacting late. Renders the episode (needs matplotlib).

    python -m mpc_local_planner_tpu_torch.examples.demo_dynamic_obstacle [out.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses as dc

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="demo_dynamic.png")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch

    from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
    from mpc_local_planner_tpu_torch.ocp.spec import Scenario
    from mpc_local_planner_tpu_torch.planner import Controller, load_config
    from mpc_local_planner_tpu_torch.utils.publisher import Publisher

    cfg = load_config(
        {
            "robot": {"type": "unicycle", "max_vel_x": 0.5, "max_vel_theta": 0.6},
            # stage density matters against moving obstacles: the constraint
            # holds at stage points, so the continuous path can cut up to
            # ~(v_rel·dt)²/(8·dist) inside the margin between stages; dt 0.15
            # holds the full margin
            "grid": {"grid_size_ref": 30, "dt_ref": 0.15},
            "planning": {
                "objective_type": "quadratic_form",
                "state_weights": [1.0, 1.0, 0.5],
                "terminal_cost_type": "quadratic",
                "final_state_weights": [20.0, 20.0, 2.0],
            },
            "collision": {
                "min_obstacle_dist": 0.15,
                "obstacle_capacity": 1,
                "enable_dynamic_obstacles": True,
            },
            "solver": {"iterations": 8, "inner_iterations": 8,
                       "tol_eq": 0.001, "tol_ineq": 0.001},
        }
    )
    ctrl = Controller(cfg, device=args.device)
    spec, dev = ctrl.spec, ctrl.device
    goal = torch.tensor([3.0, 0.0, 0.0])
    sim_dt = cfg.grid.dt_ref

    # pedestrian: starts above the path, walks down across it
    ped_pos = np.array([1.6, 1.2])
    ped_vel = np.array([0.0, -0.45])
    ped_r = 0.25

    x = np.array([0.0, 0.0, 0.0])
    traj, ped_traj = [x.copy()], [ped_pos.copy()]
    reached = False
    for cycle in range(60):
        obs = ObstacleSet.from_lists(
            circles=[(float(ped_pos[0]), float(ped_pos[1]), ped_r)],
            circle_vels=[(float(ped_vel[0]), float(ped_vel[1]))],
            device=dev,
        )
        scen = Scenario.goal_only(torch.tensor(x, dtype=torch.float32), goal,
                                  obstacle_set=obs, device=dev)
        scen = dc.replace(scen, u_prev=torch.zeros(2, device=dev))
        res = ctrl.step(scen, elapsed=sim_dt)
        # execute the planned control profile for one period
        sub = 5
        h = sim_dt / sub
        for s in range(sub):
            u = res.u_seq.interpolate((s + 0.5) * h, mode="zoh").cpu().numpy()
            x = x + h * spec.model.f(torch.from_numpy(x), torch.from_numpy(u)).numpy()
        ped_pos = ped_pos + sim_dt * ped_vel
        traj.append(x.copy())
        ped_traj.append(ped_pos.copy())
        if ctrl.is_goal_reached(torch.from_numpy(x), goal.double()):
            reached = True
            print(f"goal reached in {cycle + 1} cycles")
            break
    if not reached:
        print("goal NOT reached", x)

    traj = np.asarray(traj)
    ped_traj = np.asarray(ped_traj)
    # closest approach between robot and pedestrian over the episode
    dmin = float(np.min(np.linalg.norm(traj[:, :2] - ped_traj, axis=1)))
    print(f"closest robot-pedestrian distance: {dmin:.3f} m "
          f"(required ≥ {ped_r + cfg.collision.min_obstacle_dist:.2f})")

    pub = Publisher()
    pub.publish_local_plan(traj, label="robot trajectory")
    ax = pub.ax()
    ax.plot(ped_traj[:, 0], ped_traj[:, 1], ":", color="tab:red", label="pedestrian path")
    import matplotlib.patches as mp

    for k in range(0, len(ped_traj), 6):
        ax.add_patch(mp.Circle(ped_traj[k], ped_r, fill=False, color="tab:red", alpha=0.4))
        ax.annotate(f"t={k * sim_dt:.1f}s", ped_traj[k] + [0.05, 0.05], fontsize=7)
        if k < len(traj):
            ax.plot(*traj[k, :2], "o", color="tab:blue", markersize=5)
            ax.annotate(f"t={k * sim_dt:.1f}s", traj[k, :2] + [0.03, -0.12], fontsize=7)
    pub.save(args.out, title="dynamic obstacle anticipation (constant-velocity prediction)")
    print(f"scene written to {args.out}")


if __name__ == "__main__":
    main()
