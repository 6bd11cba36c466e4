"""Serving-runtime demo: drive a rolling journey stream for a few blocks.

The production loop the reference gets from move_base
(``computeVelocityCommands`` at ``controller_frequency``, and
recovery-behaviour replanning on failure), batched: E journeys advance
through warm MPC cycles (``JourneyStream``, the early-exit serving preset;
every SQP iteration's KKT solve is kernel K1 on the card); journeys retire
on goal-reached or on a stuck abandon and redraw.

    python -m mpc_local_planner_tpu_torch.examples.demo_serving \
        [n_journeys] [cycles_per_block] [blocks] [--device cpu]
"""

from __future__ import annotations

import argparse
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("journeys", nargs="?", type=int, default=16)
    ap.add_argument("cycles", nargs="?", type=int, default=32)
    ap.add_argument("blocks", nargs="?", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    E, K, blocks = args.journeys, args.cycles, args.blocks

    import torch

    from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time, random_ensemble
    from mpc_local_planner_tpu_torch.device import resolve_device
    from mpc_local_planner_tpu_torch.planner.serving import JourneyStream, StreamSettings
    from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings

    device = resolve_device(args.device)
    spec = config3_carlike_min_time(N=30, obstacle_cap=8)
    # serving preset: converge-or-budget-exhausted (the ipopt.max_iter analog)
    warm = SolverSettings(
        n_al=8, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
        alphas=(1.0, 0.5, 0.22), early_exit=True,
    )
    stream = JourneyStream(
        spec, warm,
        redraw_fn=lambda gen, n: random_ensemble(spec, n, gen, device=device),
        settings=StreamSettings(), device=device,
    )
    print(f"cold-planning {E} journeys ...", flush=True)
    state = stream.init(E, torch.Generator().manual_seed(0))
    run = stream.block_fn(K)
    state, _ = run(state)  # settle
    float(state.result.cost.sum())

    total = dict(conv=0, reached=0, abandoned=0, cycles=0)
    for b in range(blocks):
        t0 = time.perf_counter()
        state, stats = run(state)
        n_conv = int(stats.converged.sum())  # host fetch waits for the block
        dt_ms = (time.perf_counter() - t0) * 1e3 / K
        total["conv"] += n_conv
        total["reached"] += int(stats.reached.sum())
        total["abandoned"] += int(stats.abandoned.sum())
        total["cycles"] += K * E
        print(
            f"block {b + 1}/{blocks}: {dt_ms:.2f} ms/cycle, "
            f"conv {n_conv / (K * E):.3f}, "
            f"goals +{int(stats.reached.sum())}, "
            f"abandons +{int(stats.abandoned.sum())}",
            flush=True,
        )
    print(
        f"stream totals: conv {total['conv'] / total['cycles']:.4f} over "
        f"{total['cycles']} lane-cycles, {total['reached']} goals reached, "
        f"{total['abandoned']} journeys abandoned (classify them offline "
        "with stream.audit_abandoned)"
    )


if __name__ == "__main__":
    main()
