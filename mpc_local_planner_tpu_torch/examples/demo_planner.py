"""Standalone planner demo (test_mpc_optim_node + the Stage demos).

Runs a full closed-loop navigation episode — global plan, costmap with
obstacles, MPC cycles, feasibility vetoes — through ``LocalPlanner`` and
renders the scene to a PNG (needs matplotlib; the config needs PyYAML).

    python -m mpc_local_planner_tpu_torch.examples.demo_planner \
        [config.yaml] [out.png] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default="examples/cfg/diff_drive_quadratic_form.yaml")
    ap.add_argument("out", nargs="?", default="demo_scene.png")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch

    from mpc_local_planner_tpu_torch.planner import LocalPlanner, load_config
    from mpc_local_planner_tpu_torch.planner.local_planner import Costmap
    from mpc_local_planner_tpu_torch.utils.publisher import Publisher

    cfg = load_config(args.config)
    lp = LocalPlanner(cfg, device=args.device)

    # global plan: an S-curve to (3, 1)
    t = np.linspace(0, 1, 40)
    plan = np.stack([3.0 * t, 0.5 * (1 - np.cos(np.pi * t)), np.zeros_like(t)], axis=1)
    lp.set_plan(plan)

    # costmap: one lethal blob near the plan (forces a detour), one beside it
    data = np.zeros((60, 80), dtype=np.uint8)
    data[24:26, 19:22] = 254   # world ≈ (1.5, 1.0), near the path
    data[32:36, 55:58] = 254   # world ≈ (5.2, 1.8), off the path
    cm = Costmap(data=data, origin=(-0.5, -1.5), resolution=0.1)

    model = lp.controller.spec.model
    x = np.array([0.0, 0.0, 0.0])
    u_prev = np.zeros(2)  # control currently applied (feeds the rate bounds)
    traj = [x.copy()]
    for cycle in range(120):
        twist, res = lp.compute_velocity_commands(x, u_prev, costmap=cm)
        if res is None:
            print(f"cycle {cycle}: solver/feasibility veto — holding")
            continue
        # execute the planned control profile for one control period (ZOH
        # sampling of u_seq: a variable-dt grid's stages can be much shorter
        # than the control period)
        sub = 6
        h = cfg.grid.dt_ref / sub
        for s in range(sub):
            u_prev = res.u_seq.interpolate((s + 0.5) * h, mode="zoh").cpu().numpy()
            x = x + h * model.f(torch.from_numpy(x), torch.from_numpy(u_prev)).numpy()
        traj.append(x.copy())
        if lp.is_goal_reached(x):
            print(f"goal reached in {cycle + 1} cycles")
            break

    pub = Publisher()
    pub.publish_global_plan(plan)
    pub.publish_local_plan(np.asarray(traj), label="driven trajectory")
    ys, xs = np.nonzero(cm.data >= 254)
    pub.ax().plot(cm.origin[0] + (xs + 0.5) * cm.resolution,
                  cm.origin[1] + (ys + 0.5) * cm.resolution, "s",
                  color="tab:red", markersize=3, label="lethal cells")
    pub.publish_robot_footprint(traj[-1], lp.controller.spec.footprint)
    pub.save(args.out, title=f"{cfg.robot.type} | {cfg.planning.objective_type}")
    print(f"scene written to {args.out}")


if __name__ == "__main__":
    main()
