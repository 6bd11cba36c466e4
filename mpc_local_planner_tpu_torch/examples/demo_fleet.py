"""Batched fleet demo: many robots, one Controller, one card.

The reference runs ONE ``Controller::step`` per process; the port runs a
whole fleet as one batched solve (the warm solve and the straggler rescue as
launches of the fused kernel, the cold solve on kernel K1), the rescue
re-solving only the lanes that need more iterations
(``solver.rescue_slots``, the batched analog of IPOPT's per-problem
iteration count). Each robot drives its own start→goal journey through its
own obstacle field; per-cycle fleet convergence and arrivals are printed,
and a PNG shows every driven trajectory (needs matplotlib).

    python -m mpc_local_planner_tpu_torch.examples.demo_fleet [n_robots] [out.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses as dc

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("robots", nargs="?", type=int, default=24)
    ap.add_argument("out", nargs="?", default="demo_fleet.png")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    B = args.robots

    import torch

    from mpc_local_planner_tpu_torch.benchmarks import random_ensemble
    from mpc_local_planner_tpu_torch.planner import Controller, load_config

    cfg = load_config(
        {
            "robot": {
                "type": "simple_car",
                "simple_car": {
                    "wheelbase": 0.5, "max_vel_x": 0.4,
                    "max_vel_x_backwards": 0.2, "max_steering_angle": 1.0,
                    "acc_lim_x": 0.5,
                },
            },
            "grid": {
                "grid_size_ref": 30,
                "dt_ref": 0.3,
                "xf_fixed": [True, True, True],
                "variable_grid": {"enable": True, "min_dt": 0.001, "max_dt": 0.5},
            },
            "planning": {"objective": {"type": "minimum_time"}},
            "collision": {"min_obstacle_dist": 0.1, "obstacle_capacity": 8},
            "footprint_model": {"type": "circular", "radius": 0.2},
            "solver": {
                "tol_eq": 0.001, "tol_ineq": 0.001,
                # straggler rescue: compact unconverged lanes, deeper budget
                "rescue_slots": max(4, B // 4),
            },
        }
    )
    ctrl = Controller(cfg, batch=B, device=args.device)
    scen = random_ensemble(ctrl.spec, B, torch.Generator().manual_seed(7), device=ctrl.device)

    trajs = [[scen.x0[b].cpu().numpy()] for b in range(B)]
    arrived = np.zeros(B, dtype=bool)
    conv_hist = []
    for cycle in range(120):
        res = ctrl.step(scen)
        conv_t = res.solve.converged
        conv = conv_t.cpu().numpy()
        conv_hist.append(conv.mean())
        # advance converged lanes one optimized stage; feed back executed u
        x0n = torch.where(conv_t[:, None], res.solve.primal.xs[:, 1, :], scen.x0)
        upn = torch.where(conv_t[:, None], res.solve.primal.us[:, 0, :], scen.u_prev)
        scen = dc.replace(scen, x0=x0n, u_prev=upn)
        x_np = x0n.cpu().numpy()
        for b in range(B):
            if conv[b] and not arrived[b]:
                trajs[b].append(x_np[b])
        dp = np.linalg.norm(scen.xf.cpu().numpy()[:, :2] - x_np[:, :2], axis=-1)
        arrived |= dp < 0.2
        if cycle % 20 == 0 or arrived.all():
            print(f"cycle {cycle:3d}: conv {conv.mean():.3f}  arrived {int(arrived.sum())}/{B}")
        if arrived.all():
            break

    print(
        f"done: {int(arrived.sum())}/{B} robots arrived, "
        f"mean per-cycle fleet conv {np.mean(conv_hist):.3f} "
        "(blocked robots hold, as the reference does pending a global replan)"
    )

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    xf = scen.xf.cpu().numpy()
    for b in range(B):
        t = np.asarray(trajs[b])
        ax.plot(t[:, 0], t[:, 1], lw=0.8)
        ax.plot(xf[b, 0], xf[b, 1], "x", color="k", markersize=4)
    obs = scen.obstacles
    c = obs.circles.cpu().numpy()
    m = obs.circle_mask.cpu().numpy()
    rr = obs.circle_radii.cpu().numpy()
    for b in range(min(B, 8)):  # draw a sample of the obstacle fields
        for j in range(c.shape[1]):
            if m[b, j]:
                ax.add_patch(plt.Circle(c[b, j], rr[b, j], fill=False, color="0.7", lw=0.5))
    ax.set_aspect("equal")
    ax.set_title(f"{B}-robot fleet, min-time car-like, straggler rescue on")
    fig.savefig(args.out, dpi=120, bbox_inches="tight")
    print(f"scene written to {args.out}")


if __name__ == "__main__":
    main()
