#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mpc_local_planner_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):
  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA versions
  2. build   — nvcc builds kernel K1 (csrc/riccati_sweep.cu) and each
               group of the fused kernel's instantiations that the smoke
               launches (csrc/fused_al_sqp.cu: one library per working type,
               model, objective family, grid and collocation family, five
               instantiations each; 16 of the 96) into _build/, all at
               once; as soon as K1 is built, the main paths' ensembles and
               cold solves (phases 4, 12, 17, 20, 24, 27, 30 and 33: the
               cold preset, un-fused, K1 once per SQP iteration; path B's
               from its A* plans), each in a process of its own beside the
               builds (``cold_phase``: host-bound, the card idle); each
               build's seconds, each cold solve's line and the wall time
  3. kernel  — K1 against its plain PyTorch version on the Riccati inputs of
               one real flagship SQP iteration (B=4096 and 1024, N=30, and
               B=4096 at N=96, past the cap K1 once had), in float64 and
               float32; kernel, plain and bound times (the kernel timed
               around the wrapper's call and on the device alone, behind a
               busy-wait), its launch geometry held to the library's and
               its blocks per SM
  4. main    — the flagship warm fleet cycle on the un-fused path
               (fused="off"), as bench.py::main drives it: config3 (N=30, 8
               circle slots), 4096 lanes, from phase 2's cold 16×15 solve,
               2 settle + 8 timed warm cycles (3×4, 3 candidates) with the
               1024-slot 4×4 rescue (8 candidates); K1 must carry every
               SQP iteration (280 launches); its cold oracle runs in the
               last phase
  5. gate    — the warm solve with K1 against the same solve with the plain
               KKT solve, on 256 lanes of the live warm state
  6. trace   — one un-fused warm cycle under torch.profiler: device kernel
               time, K1's share, the device's busy share
  7. K2a     — K2a against its plain version on the live warm state: 4096
               lanes at 3×4 (3 candidates) and 1024 lanes at 4×4 (8
               candidates), float64 at every prefix of the schedule and
               float32; kernel, plain and bound times
  8. fused   — the same main path with fused="auto" from the same cold solve:
               the warm solve and the rescue run as one K2a launch each (20
               launches), K1 none (its oracle in the last phase)
  9. gate    — the fused warm solve (K2a) against the un-fused one (AD
               derivatives + K1) on 256 lanes of the live warm state
 10. trace   — one fused warm cycle under torch.profiler
 11. K1      — K1 against its plain version without the free δτ
               (free_tau=False), on BASELINE config #2's Riccati inputs
               (B=4096), float64 and float32
 12. config2 — the warm fleet cycle of BASELINE config #2 (unicycle, disc
               r=0.2, 10 circle slots, quadratic form with Qf, terminal
               ball, fixed dt 0.3, N=30) with fused="auto" from phase 2's
               cold 8×10 solve (un-fused, K1: 80 launches), 2 settle + 8
               timed warm cycles (3×4) with the 1024-slot 4×4 rescue; the
               fused kernel must carry the warm solve and the rescue (20
               launches), K1 nothing
 13. kernel  — the fused kernel against its plain version on config #2's
               live warm state, as phase 7 does for the flagship
 14. family  — the kernel against its plain version (float64 at every
               prefix, float32) at B=1024 for the flagship with the
               front-wheel car and with the kinematic bicycle, and for
               config #1 (no obstacle slot, integral left-sum), each from
               its own cold solve (the fused kernel's, at the cold preset)
               and two fused fleet cycles; run last, with phase 23
 15. gate    — config #2's fused warm solve against the un-fused one, 256
               lanes of its live warm state
 16. trace   — one config #2 warm cycle under torch.profiler
 17. path A  — the reference's car-like config (family_spec
               "canonical_carlike": the simple car with the two-disc
               footprint, 8 circle slots, minimum time) on the fused path as
               bench.py's families mode runs it: from phase 2's cold 16×15
               (un-fused, K1), 2 settle + 8 timed warm cycles (3×4) with the
               1024-slot 4×4 rescue; 20 fused launches, none of K1
 18. kernel  — the fused kernel against its plain version on path A's live
               warm state (4096 lanes at 3×4, 1024 at 4×4)
 19. gate    — path A's fused warm solve against the un-fused one; trace
 20. path B  — the wall world (family_spec "converter_lines": the flagship
               disc, 6 line slots from the wall sampler) at the family's
               shipping defaults, bench.py's BENCH_LINES_SEED=astar: per-lane
               A* plans (``lines_astar_plans``, built across processes) seed
               the cold 16×15 solve and every fresh restart, the rescue
               reseeds a diverged slot from its lane's plan (its oracle,
               in phases 36 and 37, re-plans A* from the current states);
               warm 4×4, the 2048-slot 4×4 rescue chained twice per cycle,
               stuck_restart=2; 30 fused launches (3 per cycle), none of K1
               (the plans and the cold solve are phase 2's);
               a line with the plans' count, the build's seconds and the
               converged_frac beside the straight-line seed's of record
 21. kernel  — the fused kernel against its plain version on path B's live
               warm state (4096 lanes at 4×4, the 2048-slot rescue)
 22. gate    — path B's fused warm solve against the un-fused one; trace
 23. K2c     — the kernel against its plain version at B=1024 (float64 at
               every prefix, float32; kernel, plain and bound times) on
               polygon slots with a varying vertex count, dynamic circle and
               line slots, all four families with the two-disc footprint and
               dynamic obstacles, the kinematic bicycle with the two-disc
               footprint, and all four families moving with a line footprint
               and with a polygon footprint; and (K2d, the caps lifted)
               ordered via points with an orientation weight and masked
               slots, path A's spec with 30 obstacle slots (the example
               configs' capacity, 8 obstacles in them) and the flagship at
               N=80; and (K2f) the non-uniform grid under config #2's
               integral trapezoidal form and under the mixed-dynamic case;
               and (K2b, K2e) the flagship with midpoint differences, on
               the shooting_rk4 grid and on the shooting_rk7_2 grid (rk7's
               11 stages at 2 substeps, the most the kernel takes);
               each from its own cold solve (the fused kernel's, at the
               cold preset: one launch where the un-fused solve is host-bound
               for tens of seconds) and two fused fleet cycles. The
               seventeen cases of phases 14 and 23 run in the last phase,
               each in a process of its own (``chip_smoke.py
               --family-case NAME``); then each is timed alone
 24. path C  — the polygon-footprint family (family_spec "polygon_footprint":
               the simple car with a 0.5 × 0.3 m rectangle, 8 circle slots,
               minimum time) as bench.py's families mode runs it: phase 2's
               cold 16×15, 2 settle + 8 timed warm cycles (3×4) with the
               1024-slot 4×4 rescue; 20 fused launches, none of K1; run
               after path B
 25. kernel  — the fused kernel against its plain version on path C's live
               warm state (4096 lanes at 3×4, 1024 at 4×4)
 26. gate    — path C's fused warm solve against the un-fused one; trace
 27. path D  — the via-points family (family_spec "via_points": the flagship
               with 4 corridor via points, position weight 2, unordered,
               8 circle slots) as bench.py's families mode runs it: phase
               2's cold 16×15, 2 settle + 8 timed warm cycles (3×4) with the
               1024-slot 4×4 rescue; 20 fused launches, none of K1; run
               after path C
 28. kernel  — the fused kernel against its plain version on path D's live
               warm state (4096 lanes at 3×4, 1024 at 4×4)
 29. gate    — path D's fused warm solve against the un-fused one; trace
 30. path E  — the non-uniform family (family_spec "nonuniform": the
               flagship with a per-stage dt, the kernel's K2f branch) as
               bench.py's families mode runs it: phase 2's cold 16×15
               un-fused, its KKT solves the plain lqr_solve (δdt_k a third
               control column: no K1 launch; nor in its oracle), 2 settle +
               8 timed warm
               cycles (3×4) with the 1024-slot 4×4 rescue; 20 fused
               launches, 0 of K1; run after path D
 31. kernel  — the fused kernel against its plain version on path E's live
               warm state (4096 lanes at 3×4, 1024 at 4×4)
 32. gate    — path E's fused warm solve against the un-fused one; trace
 33. path F  — the Crank–Nicolson flagship (the flagship's spec with
               ``collocation="crank_nicolson_differences"``: the kernel's
               K2b branch, the −E⁻¹ fold) as the flagship runs: phase 2's
               cold 16×15, 2 settle + 8 timed warm cycles (3×4) with the
               1024-slot 4×4 rescue; 20 fused launches, none of K1; run
               after path E
 34. kernel  — the fused kernel against its plain version on path F's live
               warm state (4096 lanes at 3×4, 1024 at 4×4)
 35. gate    — path F's fused warm solve against the un-fused one; trace
 36. golden  — ``classify_feasibility`` on the first 16 lanes of path B's
               final state, A*-seeded, at 1e-3 (bench.py's BENCH_CALIBRATE):
               the float64 AL solve on the card, SLSQP on the host; golden
               feasible share, agreement with the cold oracle, its misses
               and false certificates, conv_on_feasible against the golden
               labels; in the last phase, after path B's oracle, which it
               runs itself and prints
 37. f64 tier — ``make_f64_fallback`` over every straggler of path B's last
               warm result, the float64 solve on the card, the A* seed as
               its fresh seed: stragglers, rescued, seconds; no flag turns
               false, every lane not rescued bit-equal; in the last phase,
               after path B's oracle, which it runs itself
 38. pscan   — ``lqr_solve_pscan`` against ``lqr_solve`` on K1's inputs
               (B=4096, N=30) on the card, float64 and float32, both timed
               beside K1's device time; run after path B
 39. LM      — ``solve_single_lm`` on 1024 flagship lanes on the card and
               the first 16 on the CPU, float64: bench.py's gate on those
               lanes, the seconds of both; in the last phase
 41. fleet   — ``Controller(cfg, batch=4096)`` on examples/demo_fleet.py's
               config (the flagship: simple car, disc r=0.2, 8 circle
               slots, N=30, minimum time, 1024 rescue slots) on
               ``random_ensemble`` seed 0: a cold step (K1: 240 launches)
               and 8 warm steps (the fused kernel: the warm 2×4 solve and
               the 4×4 rescue, 2 launches each), the planned stage 1 and
               u0 fed back; step 4 passes ``elapsed`` (per-lane shifts),
               step 6 moves 512 lanes' goals past the reinit distance
               (they must restart fresh); the last warm solve against the
               un-fused one with bench.py's gate; one more warm step
               under torch.profiler; run after path F
 42. robot   — ``Controller(cfg)`` unbatched on
               examples/cfg/carlike_minimum_time.yaml (N=50, two discs, 30
               slots) in a closed loop of at most 30 cycles around 3
               circles (``ObstacleSet.from_lists``, ``Scenario.goal_only``)
               until ``is_goal_reached``: cycles to the goal, the median
               and p90 warm step; K1 once per SQP iteration, the fused
               kernel never; one more warm step under torch.profiler
 43. surface — the rest of the Controller unbatched: time_based_single_step
               grid adaptation from N=50, ``calibrate_cycle_budget`` under
               ``max_cycle_ms``, ``precompile`` over 3 horizons, an
               ``lsq_lm`` step and the float64 tier (no flag true → false)
 44. serving — ``JourneyStream`` as bench.py::serving_mode runs it (the
               flagship, warm 8×4 early-exit, ``StreamSettings()``) over 16
               journeys of ``random_ensemble`` seed 0: ``init`` (the cold
               16×15 solve), a settling block of 4 cycles and two timed
               blocks of 4 (examples/demo_serving.py's blocks are 32);
               the amortized cycle, the counts, K1 once per SQP iteration
               (counted apart), the fused kernel never; one more cycle under
               torch.profiler; its sampled oracle and abandon audit in the
               last phase
 45. shell   — ``LocalPlanner`` on examples/demo_planner.py's scenario
               (diff_drive_quadratic_form: unicycle, N=20, 30 point slots;
               the 60×80 costmap with two lethal blocks; the cosine plan) in
               a closed loop of at most 60 cycles with the native costmap
               runtime built from native/costmap.cpp: cycles to the goal,
               vetoes, the cycle's and the shell's own host times, K1 once
               per SQP iteration, the fused kernel never
 46. parallel — the parallel layer from phase 8's final state (4096 lanes):
               ``make_sharded_solver`` (warm 3×4, the 1024-slot 4×4 rescue)
               on a 1×1 mesh of the card, bit-equal to ``make_solver`` then
               ``make_rescue``, and on a 2×2 mesh of the one card (four
               shards of 1024 lanes, 256 slots each), bit-equal to the
               per-block reference; ``dryrun_multichip`` on that mesh (256
               lanes a shard at 1×1, then its cross-shard, rescue and
               early-exit checks at 32 lanes a shard, the solves they
               compare with converged and unconverged lanes); a cluster of two ``parallel.dryrun``
               processes on the card (gloo, 2 × 2048 lanes of the flagship
               at the fleet rescue's 4×4 budget, one fused launch each) whose
               identical RESULT lines equal ``ensemble_summary`` of the
               single-process solve of all 4096 lanes, and a one-rank NCCL
               group running the same all_reduce (started first, beside the
               in-process checks); the mixed ensemble of the flagship and
               config #2 at 2048 lanes each, bit-equal per group
 47. aux     — ``ClosedLoopControlTask`` with JAX
               test_controllers_plants_tasks.py:118's Controller config (at
               most 10 cycles: K1 8 a warm cycle, never fused);
               ``run_feedback_loop`` of an LQR law over 4096 plants;
               ``save_controller_state``/``load_controller_state`` of phase
               41's fleet Controller, the resumed warm step bit-equal;
               ``profile_solver_phases`` at B=4096; ``torch_trace`` around one
               fused solve in the smoke's own process, after phases 3-46
               (the trace names the fused kernel; its K1 and fused kernel
               events equal the launches counted); the convergence and
               active-constraint reports of phase 8's result
 last    — the cold oracles of phases 4, 8, 12, 17, 24, 27, 30 and 33
               (each path saves its final state) and of the serving stream
               (with its abandon audit), the float64 checks of phases 7,
               13, 18, 21, 25, 28, 31 and 34 at every prefix of the schedule
               (each of those phases saves its warm inputs and runs the
               float32 check and the times at once), phases 36, 37 and 39
               (started first; 36 and 37 run path B's oracle) and the
               B=1024 cases of phases 14 and 23: 45 processes, at most 17
               at once (``last_phase``)
 48. summary — the seconds of the build, of each path and of the last
               phase (``smoke_split_s``), the kernels line, the card line,
               then the result line

Every traced phase (6, 10, 16, 19, 22, 26, 29, 32, 35, 41, 42, 44, 47)
traces in the smoke's own process through ``profiling.torch_trace`` and
fails unless its trace holds as many K1 and fused kernel events as the
wrappers counted launches; the smoke runs no trace in another process.

Needs a CUDA card; without one (or without the package beside it) it exits
non-zero before printing any result.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import time

T_START = time.perf_counter()  # the smoke process's start, for the traces' age
BATCH = 4096
RESCUE_SLOTS = 1024
LINES_RESCUE_SLOTS = 2048  # the wall world's rescue (bench.py families mode)
# path B's converged_frac from the straight-line seed, the figure of record
# before the A* seed (this script on an H100 at 700 W; PERF.md)
LINES_STRAIGHT_LINE_CONVERGED_FRAC = 0.7400
ASTAR_PROCESSES = 8  # A* plans built across this many processes (the host's cores)
CALIBRATION_LANES = 16  # the golden classifier's sample (bench.py BENCH_CALIBRATE)
CALIBRATION_TOL = 1e-3  # the pipeline's feasibility tolerance
F64_SLOTS = 2048  # the float64 tier's chunk
LM_LANES, LM_CPU_LANES = 1024, 16
GATE_LANES = 256
SETTLE_CYCLES = 2
TIMED_CYCLES = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# The Controller phases' configs, as dicts (no YAML reader on the card's
# machine). FLEET_CONFIG is examples/demo_fleet.py's at 4096 robots (rescue
# slots B//4); CARLIKE_MINIMUM_TIME is examples/cfg/carlike_minimum_time.yaml
# written out (tests/test_torch_config.py holds the two equal).
FLEET_CONFIG = {
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
    "solver": {"tol_eq": 0.001, "tol_ineq": 0.001, "rescue_slots": BATCH // 4},
}
CARLIKE_MINIMUM_TIME = {
    "robot": {
        "type": "simple_car",
        "simple_car": {
            "wheelbase": 0.5, "max_vel_x": 0.4, "max_vel_x_backwards": 0.2,
            "max_steering_angle": 1.0, "acc_lim_x": 0.5,
        },
    },
    "grid": {
        "grid_size_ref": 50,
        "dt_ref": 0.3,
        "xf_fixed": [True, True, True],
        "collocation_method": "forward_differences",
        "variable_grid": {"enable": True, "min_dt": 0.001, "max_dt": 0.5},
    },
    "planning": {"objective": {"type": "minimum_time"}},
    "collision": {"min_obstacle_dist": 0.1, "obstacle_capacity": 30},
    "footprint_model": {
        "type": "two_circles", "front_offset": 0.15, "front_radius": 0.2,
        "rear_offset": -0.15, "rear_radius": 0.2,
    },
    "solver": {"tol_eq": 0.001, "tol_ineq": 0.001},
}
# Errors are max |kernel − plain| over the step, relative to the step's
# largest entry. f64: the two versions do the same arithmetic in another
# order, so they agree to a few ulps (1e-15 measured on an H100).
K1_RTOL_F64 = 1e-9
# f32: the 30-stage backward recursion amplifies f32 rounding (6e-8); both
# versions sit about 1e-6 from the f64 answer on these inputs (H100).
K1_RTOL_F32 = 1e-4
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
# The fused kernel against its plain version in float64
# (solvers/agreement.py): conv flags identical on every lane; max relative
# |Δ| over xs, us, dt and the duals within 1e-8 on 99.5% of the lanes both
# converged with no tie shown; and on every lane at most 100 times the plain
# version's own change under rounding. A lane that the plain version
# leaves elsewhere when it takes its near-ties of the line search, the
# growth test and the clip of a dt within rounding of its bound the other
# way (a tie shown) is held to 100 times the larger of the two changes, its
# ρ to one growth factor. The check
# runs at every prefix of the solve's schedule (1×1, 1×2, then whole AL
# phases), so a lane is held tight before its rounding can grow; a lane
# whose own change passes 1e-6 (a chaotic lane) is counted and left out of
# it, but at 1×1 every lane is held, and none beyond 1e-4
# (agreement.EVERY_LANE_CAP). The plain version's own change is its largest
# under a one-ulp change of its states and under one ulp on each entry of
# its per-iteration KKT inputs, the rounding by which the kernel's
# derivatives differ from it.


def _fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# the fused kernel's launches by collocation rule, summed over the main paths'
# runs (``reset_counts`` before each, ``rule_counts`` after it)
RULE_LAUNCHES = collections.Counter()


def reset_counts():
    """Set every kernel's launch counts to 0, just before a main path."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    riccati_cuda.lqr_solve_cuda.launches = 0
    k2a.fused_solve_cuda.launches = 0
    k2a.fused_solve_cuda.launches_by_rule.clear()
    k2a.fused_solve_cuda.launches_by_group.clear()


def rule_counts():
    """The fused kernel's launches by collocation rule since ``reset_counts``,
    just after a main path; added to RULE_LAUNCHES."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a

    counts = dict(k2a.fused_solve_cuda.launches_by_rule)
    RULE_LAUNCHES.update(counts)
    return counts


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def flagship(N=30, obstacle_cap=8):
    """The flagship problem and bench.py::main's solver settings."""
    from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time

    return fleet_settings(config3_carlike_min_time(N=N, obstacle_cap=obstacle_cap))


K1_LONG_N = 96  # phase 3's horizon past K1's old cap of 64


def fleet_settings(spec):
    """``spec`` with bench.py::main's settings: the cold preset, the warm
    3×4 solve (fused="off") and the 4×4 rescue with 8 candidates."""
    from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings

    cold = SolverSettings.for_spec(spec)
    warm = SolverSettings(
        n_al=3, n_sqp=4, rho0=120.0, rho_growth=5.0, reg0=1.0,
        tol_eq=1e-3, tol_ineq=1e-3, alphas=(1.0, 0.5, 0.22), fused="off",
    )
    rescue = dataclasses.replace(
        warm, n_al=4, n_sqp=4,
        alphas=(1.0, 0.7, 0.5, 0.35, 0.22, 0.14, 0.08, 0.03),
    )
    return spec, cold, warm, rescue


def config2():
    """BASELINE config #2 at its full width and depth (N=30, 10 circle
    slots)."""
    from mpc_local_planner_tpu_torch.benchmarks import config2_diffdrive_obstacles

    return config2_diffdrive_obstacles(N=30, obstacle_cap=10)


def ensemble(spec, batch, device, seed=0, family=None):
    """``random_ensemble``, or ``family_ensemble`` of a named family."""
    import torch

    from mpc_local_planner_tpu_torch.benchmarks import family_ensemble, random_ensemble

    gen = torch.Generator().manual_seed(seed)
    if family is not None:
        return family_ensemble(family, spec, batch, gen, dtype=torch.float32, device=device)
    return random_ensemble(spec, batch, gen, dtype=torch.float32, device=device)


def riccati_inputs(spec, settings, scen):
    """The K1 inputs of the first SQP iteration from the straight-line seed
    (the state of a reset lane) under ``settings``."""
    import torch

    from mpc_local_planner_tpu_torch.solvers import al_sqp

    init, duals = al_sqp.default_init(spec, settings, scen)
    obs_k = al_sqp._stage_obstacles(spec, scen, init.dt, spec.N + 1)
    kkt = al_sqp._kkt_system(
        spec, al_sqp._make_stage_fns(spec), al_sqp._make_terminal_fns(spec),
        init, scen, duals, obs_k,
    )
    reg = torch.full_like(init.dt, settings.reg0)
    return kkt + (reg,)


def _cuda_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps=20, rounds=5):
    """The device time of one call of ``fn``, the host's share hidden: each
    round queues ``reps`` calls behind a busy-wait kernel on the stream and
    times them between CUDA events recorded after the wait, so that the
    device runs them back to back; the median of ``rounds`` rounds. The wait
    is lengthened until it outlasts the queueing (``fused_probe.py`` has the
    same function, for trees without this one)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles, per = 2_000_000, []
    while len(per) < rounds:
        gate = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        gate.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        hidden = not gate.query()  # still waiting when the last call was queued
        torch.cuda.synchronize()
        if hidden:
            per.append(start.elapsed_time(end) / reps)
        elif cycles > 2_000_000_000:
            _fail("the host did not queue the timed calls within the wait")
        else:
            cycles *= 4
    return statistics.median(per)


def _max_rel_err(a, b):
    """max |a − b| over the step, relative to the step's largest entry."""
    import torch

    errs, scale = [], []
    for x, y in zip(a, b):
        errs.append(torch.max(torch.abs(x.double() - y.double())).item())
        scale.append(torch.max(torch.abs(y.double())).item())
    return max(errs), max(errs) / max(max(scale), 1e-30)


def kernel_phase(spec, warm, device, batches=(BATCH, RESCUE_SLOTS), tag="K1"):
    """K1 against the plain lqr_solve at ``batches``, on the inputs of a
    warm-settings SQP iteration (reg = 1), with the free δτ where ``spec``
    has a variable dt. The cold solve's first iteration (reg = 1e-6 at the
    seed) overflows float32 in both versions alike, which the solver's NaN
    quarantine absorbs."""
    import torch

    from mpc_local_planner_tpu_torch.ops import riccati_cuda
    from mpc_local_planner_tpu_torch.solvers.riccati import lqr_solve

    report = {}
    for batch in batches:
        args32 = riccati_inputs(spec, warm, ensemble(spec, batch, device))
        kw = dict(nx=spec.nx, free_tau=spec.variable_dt)
        row = {}
        for name, args in (("f64", tuple(a.double() for a in args32)), ("f32", args32)):
            out_k = riccati_cuda.lqr_solve_cuda(*args, **kw)
            out_p = lqr_solve(*args, **kw)
            torch.cuda.synchronize()
            abs_err, rel_err = _max_rel_err(out_k, out_p)
            tol = K1_RTOL_F64 if name == "f64" else K1_RTOL_F32
            finite = all(bool(torch.isfinite(t).all()) for t in out_k)
            print(
                f"{tag} {name} B={batch} free_tau={kw['free_tau']}: max_abs_err={abs_err:.3e} "
                f"rel_err={rel_err:.3e} (tol {tol:g}) finite={finite}"
            )
            if not finite or not rel_err <= tol:
                _fail(f"K1 disagrees with its plain version ({name}, B={batch})")
            row[f"max_abs_err_{name}"] = abs_err
            row[f"rel_err_{name}"] = rel_err
        nbytes = sum(a.numel() * a.element_size() for a in args32)
        nbytes += sum(t.numel() * t.element_size() for t in out_k)
        row["bytes"] = nbytes
        row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        row["ms"] = _cuda_ms(lambda: riccati_cuda.lqr_solve_cuda(*args32, **kw), 25)
        row["device_ms"] = _device_ms(lambda: riccati_cuda.lqr_solve_cuda(*args32, **kw))
        row["plain_ms"] = _cuda_ms(lambda: lqr_solve(*args32, **kw), 5)
        N = spec.N
        geo = riccati_cuda.library_geometry(riccati_cuda._load(), N, torch.float32)
        if geo != riccati_cuda.launch_geometry(N, torch.float32, riccati_cuda.DESIGN):
            _fail(f"K1's library geometry {geo} differs from launch_geometry at N={N}")
        row["geometry"] = geo._asdict()
        row["blocks_per_sm"] = riccati_cuda.occupancy(riccati_cuda._load(), N, torch.float32)
        print(
            f"{tag} f32 B={batch}: kernel {row['ms']:.4f} ms (the wrapper's call), "
            f"{row['device_ms']:.4f} ms (device), plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({nbytes} B at {HBM_BYTES_PER_S:.3g} B/s); "
            f"{json.dumps(row['geometry'])}, {row['blocks_per_sm']} blocks per SM"
        )
        report[batch] = row
    return report


def astar_plans(scen):
    """``lines_astar_plans`` over ASTAR_PROCESSES worker processes: (plans on
    the card, ok flags, seconds)."""
    from mpc_local_planner_tpu_torch.benchmarks import lines_astar_plans

    t0 = time.perf_counter()
    plans, ok = lines_astar_plans(scen, processes=ASTAR_PROCESSES)
    return plans, ok, time.perf_counter() - t0


def main_path(spec, cold, warm, rescue_set, device, cold_start, slots=RESCUE_SLOTS, chain=1,
              stuck_restart=0):
    """bench.py::main on the port from ``cold_start`` (``cold_phase``'s: the
    ensemble and its cold solve, made in the build phase; families mode
    for a named family: the rescue chained ``chain`` times per cycle, the
    stuck-lane restart; where the cold start carries per-lane A* plans,
    the wall family's shipping seed, bench.py's ``BENCH_LINES_SEED=astar``:
    the plans seed every fresh restart and the rescue reseeds a diverged
    slot from its lane's plan). The cold oracle runs in the last phase
    (``oracle_phase``) from the final state. Returns (extra, settled state,
    seconds, one cycle from the settled state, the cold start, K1's launch
    count after the timed cycles, the final state: scenarios and
    result)."""
    import torch

    from mpc_local_planner_tpu_torch.ocp.grid import primal_from_plan
    from mpc_local_planner_tpu_torch.ops import riccati_cuda
    from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle
    from mpc_local_planner_tpu_torch.solvers.al_sqp import init_duals
    from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    secs, seed_info = dict(cold_start["secs"]), dict(cold_start["seed_info"])
    scen, r, plans = cold_start["scen"], cold_start["r"], cold_start["plans"]
    batch = scen.x0.shape[0]
    fresh_init = reseed = None
    if plans is not None:
        fresh_init = lambda s: primal_from_plan(spec, plans, s.x0)  # noqa: E731
        reseed = lambda sk, idx: primal_from_plan(  # noqa: E731
            spec, plans.index_select(0, idx), sk.x0)
    duals0 = init_duals(spec, cold, dtype=torch.float32, device=device, batch=(batch,))
    rescue1 = make_rescue(spec, warm, slots, rescue_settings=rescue_set, device=device,
                          fresh_init=reseed)

    def rescue(scen, r):
        for _ in range(chain):
            r = rescue1(scen, r)
        return r

    cycle = make_fleet_cycle(spec, warm, duals0, rescue=rescue, device=device,
                             fresh_init=fresh_init, stuck_restart=stuck_restart)
    stuck = torch.zeros((batch,), dtype=torch.int32, device=device)

    def run(scen, r):
        nonlocal stuck
        if not stuck_restart:
            return cycle(scen, r)
        scen, r, stuck = cycle(scen, r, stuck)
        return scen, r

    for _ in range(SETTLE_CYCLES):
        scen, r = run(scen, r)
    sync()
    settled = (scen, r)
    stuck_settled = stuck

    def one_cycle(scen_, r_):
        """One cycle from the settled state's stuck counts."""
        if not stuck_restart:
            return cycle(scen_, r_)
        return cycle(scen_, r_, stuck_settled)[:2]

    t0 = time.perf_counter()
    for _ in range(TIMED_CYCLES):
        scen, r = run(scen, r)
    n_conv = int(torch.sum(r.converged))  # host fetch ends the chain
    dt = (time.perf_counter() - t0) / TIMED_CYCLES
    k1_after_cycles = riccati_cuda.lqr_solve_cuda.launches
    extra = {
        "batch": batch,
        "cycle_ms": dt * 1e3,
        "total_solves_per_s": batch / dt,
        "warm_iterations": warm.n_al * warm.n_sqp,
        "converged_frac": n_conv / batch,
        **seed_info,
    }
    return extra, settled, secs, one_cycle, cold_start, k1_after_cycles, (scen, r)


# the main paths whose ensembles and cold solves ``cold_phase`` makes while
# the fused kernel's groups build: phases 4 and 8 (the flagship), 12, 17,
# 20, 24, 27, 30 and 33
COLD_PATHS = ("flagship", "config2", "canonical_carlike", "converter_lines",
              "polygon_footprint", "via_points", "nonuniform", "crank_nicolson")


def path_settings(tag):
    """(spec, cold, warm, rescue, family) of the main path ``tag``: the
    flagship, config #2, a family of bench.py's families mode, or the
    Crank–Nicolson flagship."""
    from mpc_local_planner_tpu_torch.benchmarks import family_spec

    if tag == "flagship":
        return (*flagship(), None)
    if tag == "config2":
        return (*fleet_settings(config2()), None)
    if tag == "crank_nicolson":
        return (*fleet_settings(crank_nicolson_flagship()), None)
    return (*fleet_settings(family_spec(tag, N=30)), tag)


def cold_phase(tag, path, device=None):
    """A main path's ensemble (4096 lanes, seed 0) and its cold solve at the
    cold preset (un-fused: K1 once per SQP iteration, none on the
    non-uniform grid), in a process of its own while the fused kernel's
    groups build: host-bound work that leaves the card idle. The wall
    family's cold solve starts from per-lane A* plans (bench.py's
    ``BENCH_LINES_SEED=astar``), which its path reuses. Saves them to
    ``path`` and prints its line."""
    import torch

    from mpc_local_planner_tpu_torch.ocp.grid import initial_primal, primal_from_plan
    from mpc_local_planner_tpu_torch.ops import riccati_cuda
    from mpc_local_planner_tpu_torch.solvers.al_sqp import init_duals, make_solver

    device = device or torch.device("cuda", 0)
    spec, cold, _, _, family = path_settings(tag)
    scen = ensemble(spec, BATCH, device, family=family)
    secs, seed_info, plans = {}, {}, None
    if tag == "converter_lines":
        plans, ok, secs["astar_build_parallel_s"] = astar_plans(scen)
        seed_info["astar_plans"] = int(ok.sum())
        init = primal_from_plan(spec, plans, scen.x0)
    else:
        init = initial_primal(spec, scen)
    duals0 = init_duals(spec, cold, dtype=torch.float32, device=device, batch=(BATCH,))
    k1_before = riccati_cuda.lqr_solve_cuda.launches
    t0 = time.perf_counter()
    r = make_solver(spec, cold, device)(scen, init, duals0)
    n_conv = int(torch.sum(r.converged))
    secs["cold_solve_parallel_s"] = time.perf_counter() - t0
    k1 = riccati_cuda.lqr_solve_cuda.launches - k1_before
    torch.save({"scen": scen, "r": r, "plans": plans, "secs": secs, "seed_info": seed_info},
               path)
    print(json.dumps({"cold": {"path": tag, "batch": BATCH, "budget": [cold.n_al, cold.n_sqp],
                               "converged": n_conv, "k1_launches": k1, **secs, **seed_info}}))
    expected = 0 if spec.nonuniform_dt else cold.n_al * cold.n_sqp
    if k1 != expected:
        _fail(f"K1 launched {k1} times in the {tag} cold solve, expected {expected}")


def load_cold_start(path):
    import torch

    return torch.load(path, map_location="cuda:0", weights_only=False)


def oracle_phase(job, quiet=False):
    """A main path's cold oracle, in the last phase: the feasibility
    denominator of its final state. The cold preset (un-fused, K1 once per
    SQP iteration; none on the non-uniform grid) from the straight-line
    seed, or, for the wall family (``plan_seed``), from A* plans re-built
    at the current states as bench.py does. Prints the path's
    ``feasible_frac_cold_oracle`` and ``conv_on_feasible`` (not when
    ``quiet``); returns (the oracle's flags, its seed)."""
    import torch

    from mpc_local_planner_tpu_torch.ocp.grid import initial_primal, primal_from_plan
    from mpc_local_planner_tpu_torch.ops import riccati_cuda
    from mpc_local_planner_tpu_torch.solvers.al_sqp import init_duals, make_solver

    spec, cold, (scen, r) = job["spec"], job["cold"], job["final"]
    batch, dev, secs = scen.x0.shape[0], scen.x0.device, {}
    if job["plan_seed"]:
        # feasible from the current state with a fresh global plan
        plans_now, _, secs["astar_oracle_build_parallel_s"] = astar_plans(scen)
        seed = primal_from_plan(spec, plans_now, scen.x0)
    else:
        seed = initial_primal(spec, scen)
    duals0 = init_duals(spec, cold, dtype=torch.float32, device=dev, batch=(batch,))
    k1_before = riccati_cuda.lqr_solve_cuda.launches
    t0 = time.perf_counter()
    feas = make_solver(spec, cold, dev)(scen, seed, duals0).converged
    n_feas = int(torch.sum(feas))
    secs["oracle_parallel_s"] = time.perf_counter() - t0
    k1 = riccati_cuda.lqr_solve_cuda.launches - k1_before
    line = {"path": job["tag"], "batch": batch, "feasible_frac_cold_oracle": n_feas / batch,
            "conv_on_feasible": int(torch.sum(r.converged & feas)) / max(n_feas, 1),
            "k1_launches": k1, **secs, "device": card_line()}
    if not quiet:
        print(json.dumps({"oracle": line}))
    expected = 0 if spec.nonuniform_dt else cold.n_al * cold.n_sqp
    if k1 != expected:
        _fail(f"K1 launched {k1} times in the {job['tag']} oracle, expected {expected}")
    return feas, seed


def warm_inputs(spec, warm, settled, n):
    """The next warm solve's inputs (advanced scenarios, resampled primal,
    shifted duals) for the first ``n`` lanes of a live warm state, as
    bench.py's gate builds them."""
    import torch

    from mpc_local_planner_tpu_torch.core.tree import tree_map
    from mpc_local_planner_tpu_torch.ocp.grid import warm_start_resample
    from mpc_local_planner_tpu_torch.solvers.al_sqp import shift_duals

    scen, r = settled
    take = lambda t: tree_map(lambda a: a[:n].contiguous(), t)  # noqa: E731
    x0n = torch.where(r.converged[:, None], r.primal.xs[:, 1, :], scen.x0)
    return (
        dataclasses.replace(take(scen), x0=x0n[:n]),
        take(warm_start_resample(r.primal, x0n, steps=1, spec=spec)),
        take(shift_duals(r.duals, warm, steps=1)),
    )


def gate_phase(spec, reference, candidate, settled, n=GATE_LANES):
    """bench.py's kernel-vs-reference gate on the live warm state: the warm
    solve under ``candidate`` settings against the same solve under
    ``reference``."""
    from mpc_local_planner_tpu_torch.solvers import agreement
    from mpc_local_planner_tpu_torch.solvers.al_sqp import make_solver

    scen_g, init_g, dn_g = warm_inputs(spec, reference, settled, n)
    dev = scen_g.x0.device
    out_k = make_solver(spec, candidate, dev)(scen_g, init_g, dn_g)
    out_p = make_solver(spec, reference, dev)(scen_g, init_g, dn_g)
    return agreement.gate(out_k, out_p, candidate.n_al * candidate.n_sqp)


def schedule_prefixes(st):
    """Budgets (n_al, n_sqp) that run the first iterations of ``st``'s
    schedule: one SQP iteration, two, then each whole AL phase; the last is
    ``st``'s own."""
    prefixes = [(1, 1), (1, 2)] + [(a, st.n_sqp) for a in range(1, st.n_al + 1)]
    return sorted(set(prefixes), key=lambda b: (b[0], b[1]))


def k2a_f64_phase(spec, st, args64, tag, floor=0.25):
    """K2a against its plain version in float64 at every prefix of ``st``'s
    schedule (``agreement.f64_agreement``, every lane at 1×1, at least
    ``floor`` of the lanes converged on both after the whole schedule);
    prints one line per prefix and the error of the lane that ends furthest
    apart at each prefix."""
    import torch

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.solvers import agreement

    scen, init, duals = args64
    rows = []
    prefixes = schedule_prefixes(st)
    for n_al, n_sqp in prefixes:
        sp = dataclasses.replace(st, n_al=n_al, n_sqp=n_sqp)
        last, first = (n_al, n_sqp) == (st.n_al, st.n_sqp), (n_al, n_sqp) == (1, 1)
        out_k = k2a.fused_solve_cuda(spec, sp, scen, init, duals)
        out_p = k2a.fused_solve_plain(spec, sp, scen, init, duals)
        plain = lambda i, **kw: k2a.fused_solve_plain(spec, sp, scen, i, duals, **kw)  # noqa: E731,B023
        outs_q, outs_r, outs_t = agreement.plain_runs(plain, init)
        outs_s = agreement.spread_runs(plain, init) if first else ()
        torch.cuda.synchronize()
        respread = agreement.lane_spread(
            lambda s, i, d, **kw: k2a.fused_solve_plain(spec, sp, s, i, d, **kw),  # noqa: B023
            scen, init, duals)
        info, passed, err, sens = agreement.f64_agreement(
            out_k, out_p, outs_q, outs_t, sp.rho_growth,
            min_converged_frac=floor if last else 0.0, every_lane=first,
            outs_r=outs_r, outs_spread=outs_s, respread=respread,
        )
        print(f"{tag} f64 at {n_al}x{n_sqp}: {json.dumps(info)} passed={passed}")
        if not passed:
            _fail(f"the fused kernel disagrees with its plain version in float64 "
                  f"({tag} at {n_al}x{n_sqp})")
        rows.append(((n_al, n_sqp), err, sens))
    worst = int(torch.argmax(rows[-1][1]))
    trail = ", ".join(f"{a}x{s} {float(e[worst]):.3e} ({float(q[worst]):.3e})"
                      for (a, s), e, q in rows)
    print(f"{tag} f64 lane {worst}, its error at each prefix (plain version's "
          f"one-ulp sensitivity): {trail}")


def _double(args32):
    from mpc_local_planner_tpu_torch.core.tree import tree_map

    return tuple(
        tree_map(lambda a: a.double() if a.is_floating_point() else a, t) for t in args32
    )


def k2a_check(spec, st, args32, tag, floor=0.25):
    """The fused kernel against its plain version on one set of warm inputs:
    float64 at every prefix of the schedule, then float32 at bench-gate
    semantics, each with at least ``floor`` of the lanes converged on both
    after the whole schedule. Returns the gate's info."""
    k2a_f64_phase(spec, st, _double(args32), tag, floor)
    return k2a_f32_check(spec, st, args32, tag, floor)


def k2a_f32_check(spec, st, args32, tag, floor=0.25):
    """``k2a_check``'s float32 part: bench.py's gate. Returns its info."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.solvers import agreement

    out_k = k2a.fused_solve_cuda(spec, st, *args32)
    out_p = k2a.fused_solve_plain(spec, st, *args32)
    info, passed = agreement.gate(out_k, out_p, st.n_al * st.n_sqp, floor)
    print(f"{tag} f32: {json.dumps(info)} passed={passed}")
    if not passed:
        _fail(f"the fused kernel disagrees with its plain version in float32 ({tag})")
    return info


def k2a_times(spec, st, args32, info, tag):
    """The fused kernel's float32 times on ``args32`` (CUDA events, median
    of 25 launches; the plain version's of 3 calls) beside its bound (the
    bytes it moves over the memory rate, its operations, ``k2a_flops`` on
    this run's slot families and polygon edges, over the float32 peak);
    prints them and returns the row."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a

    batch = args32[0].x0.shape[0]
    ins, outs = k2a.kernel_io(spec, *args32)
    nbytes = sum(a.numel() * a.element_size() for a in ins + outs)
    flops = batch * k2a.k2a_flops(spec, st.n_al, st.n_sqp, len(st.alphas), args32[0].obstacles,
                                  args32[0].via_mask)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    row = {
        "max_abs_err": info["max_dxs_on_converged"],
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "ms": _cuda_ms(lambda: k2a.fused_solve_cuda(spec, st, *args32), 25),
        "plain_ms": _cuda_ms(lambda: k2a.fused_solve_plain(spec, st, *args32), 3),
    }
    print(
        f"{tag} f32: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({nbytes} B, {flops} FLOP)"
    )
    return row


class F64Checks:
    """The main paths' float64 checks (``k2a_f64_phase``) and cold oracles
    (``oracle_phase``), their inputs saved as each path makes them and run
    at the end, each in a process of its own beside the B=1024 cases
    (``last_phase``): host-bound, they would run one after the other here;
    the host has cores to spare. ``all_jobs`` starts the longest first: the
    solver phases, then the oracles, then the float64 checks."""

    def __init__(self):
        import tempfile

        self.dir = tempfile.TemporaryDirectory()
        self.jobs = []
        self.oracles = []
        self.solver = []

    def all_jobs(self):
        return self.solver + self.oracles + self.jobs

    def add_oracle(self, tag, spec, cold, final, plan_seed=False):
        """A main path's cold oracle on its final state (scenarios, result)."""
        import torch

        path = f"{self.dir.name}/oracle_{len(self.oracles)}.pt"
        torch.save({"tag": tag, "spec": spec, "cold": cold, "final": final,
                    "plan_seed": plan_seed}, path)
        self.oracles.append((f"oracle {tag}", [sys.executable, __file__, "--oracle", path]))
        return path

    def add_serving(self, path):
        """The serving stream's sampled oracle and false-abandon audit on its
        final state and abandoned rows, saved to ``path``."""
        self.oracles.insert(0, ("serving oracle and audit",
                                [sys.executable, __file__, "--serving-oracle", path]))

    def add(self, spec, st, args32, tag, floor=0.25):
        import torch

        path = f"{self.dir.name}/f64_{len(self.jobs)}.pt"
        torch.save({"spec": spec, "st": st, "args": args32, "tag": tag, "floor": floor}, path)
        self.jobs.append((tag, [sys.executable, __file__, "--f64-check", path]))

    def add_solver_phases(self, tag, spec, cold, final):
        """Phases 36 (the golden calibration), 37 (the float64 tier) and 39
        (Levenberg–Marquardt): path B's final state saved for the first two,
        each of which runs path B's oracle itself first (the golden
        calibration prints its line); each phase a process of its own,
        started first in the last phase (the longest jobs)."""
        import torch

        path = f"{self.dir.name}/pathB_final.pt"
        torch.save({"tag": tag, "spec": spec, "cold": cold, "final": final,
                    "plan_seed": True}, path)
        self.solver = [(f"solver phase {name}", [sys.executable, __file__, "--solver-phase",
                                                 name, path])
                       for name in ("f64_tier", "golden", "lm")]


def k2a_phase(spec, warm, rescue_set, settled, checks, name="K2a", slots=RESCUE_SLOTS):
    """The fused kernel against its plain version on the live warm state:
    the next warm solve's inputs at 4096 lanes under ``warm`` and at
    ``slots`` lanes with the rescue's settings, in float32 here, in float64
    at every prefix of the schedule with ``checks`` at the end; kernel,
    plain and bound times (``k2a_times``)."""
    report = {}
    for batch, st in ((BATCH, warm), (slots, rescue_set)):
        args32 = warm_inputs(spec, st, settled, batch)
        tag = f"{name} B={batch} {st.n_al}x{st.n_sqp}"
        checks.add(spec, st, args32, tag)
        report[batch] = k2a_times(spec, st, args32, k2a_f32_check(spec, st, args32, tag), tag)
    return report


def model_cases():
    """Phase 14's specs: the flagship with the front-wheel car and with the
    kinematic bicycle, and config #1 (no obstacle slot, point footprint,
    integral left-sum)."""
    from mpc_local_planner_tpu_torch.benchmarks import (
        config1_unicycle_quadratic,
        config3_carlike_min_time,
    )
    from mpc_local_planner_tpu_torch.systems.models import (
        KinematicBicycleModelVelocityInput,
        SimpleCarFrontWheelDrivingModel,
    )

    car = config3_carlike_min_time(N=30, obstacle_cap=8)
    return (
        ("front-wheel", dataclasses.replace(car, model=SimpleCarFrontWheelDrivingModel(0.5)), None),
        ("bicycle", dataclasses.replace(car, model=KinematicBicycleModelVelocityInput(0.3, 0.2)),
         None),
        ("config1", dataclasses.replace(config1_unicycle_quadratic(N=20), integral_form=True),
         None),
    )


def k2c_cases():
    """Phase 23's specs and slot mixes (``benchmarks.mixed_obstacles``, as
    the JAX package's tests/test_fused_solver.py draws them): polygon slots
    with a varying vertex count, dynamic circle and line slots, all four
    families with the canonical two-disc footprint and dynamic obstacles,
    the kinematic bicycle with the two-disc footprint (8 circle slots,
    ``random_ensemble``), and all four families moving with the JAX tests'
    line footprint and with the polygon-footprint family's rectangle."""
    from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time, family_spec
    from mpc_local_planner_tpu_torch.geometry.footprints import (
        CircularFootprint,
        LineFootprint,
    )
    from mpc_local_planner_tpu_torch.systems.models import KinematicBicycleModelVelocityInput

    def car(footprint, dynamic=False, **slots):
        M = sum(slots.get(k, 0) for k in ("mp", "mc", "ml", "mg"))
        spec = dataclasses.replace(config3_carlike_min_time(N=30, obstacle_cap=M),
                                   footprint=footprint, enable_dynamic_obstacles=dynamic)
        return spec, dict(slots, dynamic=dynamic)

    two = family_spec("canonical_carlike", N=30).footprint
    return (
        ("polygons", *car(CircularFootprint(0.15), mc=1, mg=2, V=5, vary_nv=True)),
        ("lines-dynamic", *car(CircularFootprint(0.2), True, mc=2, ml=3)),
        ("mixed-dynamic", *car(two, True, mp=1, mc=2, ml=2, mg=1, V=4)),
        ("bicycle-two-circles", dataclasses.replace(
            family_spec("canonical_carlike", N=30),
            model=KinematicBicycleModelVelocityInput(0.3, 0.2)), None),
        ("line-footprint-mixed-dynamic", *car(LineFootprint((-0.1, 0.0), (0.35, 0.0)), True,
                                              mp=1, mc=2, ml=2, mg=1, V=4)),
        ("polygon-footprint-mixed-dynamic", *car(family_spec("polygon_footprint").footprint,
                                                 True, mp=1, mc=2, ml=2, mg=1, V=4)),
    )


def family_case(name, save=None, batch=RESCUE_SLOTS):
    """One case of phases 14 and 23: the fused kernel against its plain
    version on ``family_state``'s warm inputs (at least a quarter of the
    lanes converged on both, or the case's ``CONVERGED_FLOOR``); with
    ``save``, the inputs and the float32 check's info go to that file for
    ``last_phase`` to time."""
    import torch

    spec, warm, args32 = family_state(name, batch)
    info = k2a_check(spec, warm, args32, f"{name} B={batch} {warm.n_al}x{warm.n_sqp}",
                     CONVERGED_FLOOR.get(name, 0.25))
    if save is not None:
        torch.save({"args": args32, "info": info}, save)


def k2d_cases():
    """The B=1024 cases of via points and of the caps lifted (K2d, F1, F3):
    the JAX package's fused-kernel via ensemble (``tests/test_fused_solver.py``:
    3 slots uniform in [0.2, 2]³, about 30% masked) ordered with an
    orientation weight, path A's spec with 30 obstacle slots, as every
    ``examples/cfg/*.yaml`` sets ``obstacle_capacity: 30`` (its 8 obstacles
    in them, the rest masked), and the flagship at N=80."""
    from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time, family_spec

    via = dataclasses.replace(
        config3_carlike_min_time(N=30, obstacle_cap=8), objective="minimum_time_via_points",
        via_cap=3, via_position_weight=2.0, via_orientation_weight=0.5, via_points_ordered=True)
    return (
        ("via-ordered-orientation", via, "random_via"),
        ("carlike-30-slots", dataclasses.replace(family_spec("canonical_carlike", N=30),
                                                 obstacle_cap=30), "8_obstacles"),
        ("flagship-N80", config3_carlike_min_time(N=80, obstacle_cap=8), None),
    )


def k2f_cases():
    """The B=1024 cases of the non-uniform grid (K2f): config #2 with the
    integral trapezoidal form, hybrid weight 0.4 and a variable per-stage dt
    in [1e-3, 0.5] (the spec of the JAX package's
    ``tests/test_fused_solver.py::test_fused_nonuniform_trapezoidal_quadratic_matches_xla``
    at N=30: the dt_{k-1} coupling row), and ``mixed-dynamic`` on the grid
    (the cumulative prediction times under ``GEO_ALL``)."""
    from mpc_local_planner_tpu_torch.benchmarks import config2_diffdrive_obstacles

    trap = dataclasses.replace(
        config2_diffdrive_obstacles(N=30, obstacle_cap=10), integral_form=True,
        cost_integration="trapezoidal", hybrid_time_weight=0.4, variable_dt=True,
        nonuniform_dt=True, dt_min=1e-3, dt_max=0.5)
    mixed, slots = {n: (s, m) for n, s, m in k2c_cases()}["mixed-dynamic"]
    return (
        ("nonuniform-trapezoidal-quadratic", trap, None),
        ("nonuniform-mixed-dynamic", dataclasses.replace(mixed, nonuniform_dt=True), slots),
    )


def colloc_cases():
    """The B=1024 cases of the other collocation rules (K2b, K2e): the
    flagship with midpoint differences (the fold at the kernel's SE(2)
    midpoint), on the shooting_rk4 grid, and on the shooting_rk7_2 grid
    (11 stages at 2 substeps: 22 evaluations per stage of the grid, the
    largest the kernel takes)."""
    from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time

    flag = config3_carlike_min_time(N=30, obstacle_cap=8)
    return tuple((name, dataclasses.replace(flag, collocation=rule), None) for name, rule in (
        ("midpoint-flagship", "midpoint_differences"),
        ("shooting-rk4-flagship", "shooting_rk4"),
        ("shooting-rk7-2-flagship", "shooting_rk7_2"),
    ))


def crank_nicolson_flagship():
    """Path F's spec: the flagship with Crank–Nicolson differences."""
    return dataclasses.replace(flagship()[0], collocation="crank_nicolson_differences")


# The least share of the lanes converged on both versions after the whole
# schedule, where a case's form converges fewer than the rule's quarter.
# The trapezoidal form converges 91 of 1024 lanes at the warm 3×4 on the
# card (JAX converges as few on the CPU: tests/test_torch_nonuniform_solves.py);
# it is held to 64 lanes, the count the gate asks of its 256.
CONVERGED_FLOOR = {"nonuniform-trapezoidal-quadratic": 1 / 16}


def all_cases():
    return model_cases() + k2c_cases() + k2d_cases() + k2f_cases() + colloc_cases()


def case_spec(name):
    """(spec, slot mix) of a case of ``model_cases``, ``k2c_cases``,
    ``k2d_cases``, ``k2f_cases`` or ``colloc_cases``."""
    return {n: (s, m) for n, s, m in all_cases()}[name]


def family_state(name, batch=RESCUE_SLOTS, case=None):
    """One case of ``all_cases``, or
    ``case`` under ``name`` (a spec, and a slot mix for
    ``benchmarks.mixed_obstacles``, None for ``random_ensemble``'s circles,
    or a kind of ``benchmarks.case_ensemble``) at ``batch`` lanes: its own
    cold solve and two fleet cycles (fused, the flagship's warm settings).
    The cold solve is the fused kernel's at the spec's cold preset: the
    same algorithm as the un-fused solve the main paths run (the plain
    version, which the kernel is held to, drives the port's own ``solve``),
    in one launch, where the un-fused one is host-bound for tens of seconds
    and seventeen of them at once crowd the host. Returns (spec, the warm
    settings, the fleet cycle's next warm inputs)."""
    import torch

    from mpc_local_planner_tpu_torch.benchmarks import case_ensemble, mixed_obstacles
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle
    from mpc_local_planner_tpu_torch.solvers.al_sqp import (
        SolverSettings,
        default_init,
        init_duals,
    )

    device = torch.device("cuda", 0)
    spec, slots = case or case_spec(name)
    warm = dataclasses.replace(flagship()[2], fused="auto")
    t0 = time.perf_counter()
    cold = SolverSettings.for_spec(spec)
    if slots is None:
        scen = ensemble(spec, batch, device)
    elif isinstance(slots, str):
        scen = case_ensemble(slots, spec, batch, torch.Generator().manual_seed(0), device=device)
    else:
        scen = ensemble(dataclasses.replace(spec, obstacle_cap=0), batch, device)
        gen = torch.Generator().manual_seed(1)
        scen = dataclasses.replace(scen, obstacles=mixed_obstacles(
            batch, gen, dtype=torch.float32, device=device, **slots))
    init, duals = default_init(spec, cold, scen)
    r = k2a.fused_solve_cuda(spec, cold, scen, init, duals)
    duals0 = init_duals(spec, warm, dtype=torch.float32, device=device, batch=(batch,))
    cycle = make_fleet_cycle(spec, warm, duals0, device=device)
    for _ in range(SETTLE_CYCLES):
        scen, r = cycle(scen, r)
    torch.cuda.synchronize()
    print(f"{name}: cold {cold.n_al}x{cold.n_sqp} solve and {SETTLE_CYCLES} cycles at "
          f"B={batch} in {time.perf_counter() - t0:.2f} s, converged "
          f"{int(torch.sum(r.converged))}")
    return spec, warm, warm_inputs(spec, warm, (scen, r), batch)


# processes at once in the last phase: as many as the B=1024 cases that ran
# at once before the paths' float64 checks joined them, and the only count
# measured (33 jobs in 142.58-148.29 s on an H100 host of 8 cores, 96 GiB);
# the phase prints the host's cores and each job its peak resident memory,
# the limits a larger count would meet
MAX_PROCS = 17


def run_processes(jobs, tmp):
    """Run ``jobs`` ((label, argv) pairs), each in a process of its own, at
    most MAX_PROCS at once, each one's output into a file under ``tmp``;
    print the outputs in the order of ``jobs``; return the labels of the
    jobs that failed. Every process is waited for, and killed if this one
    stops early."""
    pending, running, codes = list(enumerate(jobs)), {}, {}
    try:
        while pending or running:
            while pending and len(running) < MAX_PROCS:
                i, (_, argv) = pending.pop(0)
                log = open(f"{tmp}/job_{i}.log", "w")
                running[i] = (subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT), log)
            for i, (proc, log) in list(running.items()):
                if proc.poll() is not None:
                    log.close()
                    codes[i] = proc.returncode
                    del running[i]
            time.sleep(0.2)
    finally:
        for proc, log in running.values():
            proc.kill()
            proc.wait()
            log.close()
    failed = []
    for i, (label, _) in enumerate(jobs):
        with open(f"{tmp}/job_{i}.log") as log:
            print(log.read(), end="", flush=True)
        if codes[i] != 0:
            failed.append(label)
    return failed


def last_phase(checks, names):
    """The main paths' cold oracles and float64 checks, the serving stream's
    oracle and audit, and phases 36, 37 and 39 (``checks``) and phases 14
    and 23, each ``family_case``, in a process of its own,
    all at once (host-bound work
    that leaves the card idle, so they share the card and the host's
    cores); prints each one's lines in order and fails if any failed. Then
    each case's kernel, plain and bound times (``k2a_times``), one case
    after the other in this process, so that no other process shares the
    card while a case is timed; one JSON row per case. Returns each case's
    row."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        saved = {name: f"{tmp}/{name}.pt" for name in names}
        jobs = checks.all_jobs() + [
            (name, [sys.executable, __file__, "--family-case", name, saved[name]])
            for name in names
        ]
        failed = run_processes(jobs, tmp)
        if failed:
            _fail(f"failed in the last phase: {', '.join(failed)}")
        print(f"checks and cases: {len(jobs)} processes, at most {MAX_PROCS} at once, done in "
              f"{time.perf_counter() - t0:.2f} s on {os.cpu_count()} host cores")
        warm = dataclasses.replace(flagship()[2], fused="auto")
        rows = {}
        for name in names:
            case = torch.load(saved[name], map_location="cuda:0", weights_only=False)
            args32, batch = case["args"], case["args"][0].x0.shape[0]
            tag = f"{name} B={batch} {warm.n_al}x{warm.n_sqp}"
            row = k2a_times(case_spec(name)[0], warm, args32, case["info"], tag)
            print(json.dumps({"family_case": name, "batch": batch, **row}))
            rows[name] = row
    return rows


def fused_path(tag, spec, cold, warm_f, rescue_f, device, card, floor, checks, oracle=True,
               **kw):
    """A warm fleet cycle on the fused path from the build phase's cold start
    (``main_path``'s keywords pass through): the fused kernel must carry
    every warm solve and rescue pass (1 + chain launches per cycle), K1
    nothing, and converged_frac reach ``floor``. Prints the path's line;
    its cold oracle joins ``checks`` (the last phase) unless ``oracle`` is
    false. Returns (extra, settled state, one cycle, fused launches, the
    final state)."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    reset_counts()
    t0 = time.perf_counter()
    extra, settled, secs, cycle, _, _, final = main_path(
        spec, cold, warm_f, rescue_f, device, **kw
    )
    fused = k2a.fused_solve_cuda.launches
    k1 = riccati_cuda.lqr_solve_cuda.launches
    by_rule = rule_counts()
    print(json.dumps({**extra, "path": tag, "fused_launches": fused,
                      "fused_launches_by_rule": by_rule, "k1_launches": k1,
                      "k1_launches_in_warm_cycles": k1,
                      "device": card, **secs, "main_path_s": time.perf_counter() - t0}))
    expected = (1 + kw.get("chain", 1)) * (SETTLE_CYCLES + TIMED_CYCLES)
    if fused != expected:
        _fail(f"the fused kernel launched {fused} times on the {tag} path, expected {expected}")
    if k1 != 0:
        _fail(f"K1 launched {k1} times on the {tag} path, expected 0 (its cold solve is the "
              "build phase's)")
    if oracle:
        checks.add_oracle(tag, spec, cold, final)
    if not extra["converged_frac"] >= floor:
        _fail(f"{tag} converged_frac {extra['converged_frac']} below the {floor} floor")
    return {**extra, **secs}, settled, cycle, fused, final


def gate_and_trace(tag, spec, warm, warm_f, settled, cycle, cycle_ms):
    """The fused warm solve against the un-fused one on 256 lanes of the
    live warm state, then one warm cycle under torch.profiler."""
    gate, passed = gate_phase(spec, warm, warm_f, settled)
    print(json.dumps({f"{tag}_fused_vs_unfused_gate": gate, "passed": passed}))
    if not passed:
        _fail(f"{tag} fused-vs-un-fused gate failed: {gate}")
    print(json.dumps({f"trace_{tag}": trace_phase(cycle, settled, cycle_ms)}))


def trace_phase(cycle, settled, cycle_ms):
    """One warm cycle (solve + rescue) from the settled state under
    ``profiling.torch_trace``, recording the device's activity alone: from
    the trace file, the device's kernel time per cycle, K1's and K2a's parts
    of it, and the device's busy share against the unprofiled cycle time.
    Fails unless the trace holds as many K1 and fused kernel events as
    their wrappers counted launches in the traced block."""
    import glob
    import tempfile

    from mpc_local_planner_tpu_torch.profiling import torch_trace

    scen, r = settled
    with tempfile.TemporaryDirectory() as tmp:
        before = launch_counts()
        with torch_trace(tmp, cpu=False):
            cycle(scen, r)
        counted = [n - b for n, b in zip(launch_counts(), before)]
        (path,) = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        with open(path) as fh:
            trace = json.load(fh)
    ms, count = collections.Counter(), collections.Counter()
    for e in trace["traceEvents"]:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms[e["name"]] += e["dur"] / 1e3
            count[e["name"]] += 1
    device_ms = sum(ms.values())
    out = {
        "device_kernel_ms_per_cycle": device_ms,
        "kernel_launches_per_cycle": sum(count.values()),
        "device_busy_frac": device_ms / cycle_ms,
    }
    for tag, key in (("k1", "riccati_sweep_kernel"), ("k2a", "k2a_kernel")):
        out[f"{tag}_ms_per_cycle"] = sum(v for k, v in ms.items() if key in k)
        out[f"{tag}_launches_per_cycle"] = sum(v for k, v in count.items() if key in k)
    out["top_kernels_ms"] = {k[:60]: v for k, v in ms.most_common(5)}
    out["alignment"] = trace["torch_trace_alignment"]
    out["k1_fused_launches_counted"] = counted
    if [out["k1_launches_per_cycle"], out["k2a_launches_per_cycle"]] != counted:
        _fail(f"the trace holds (K1, fused) kernel events ({out['k1_launches_per_cycle']}, "
              f"{out['k2a_launches_per_cycle']}), the wrappers counted {counted}: {out}")
    return out


PATH_FAMILIES = ("canonical_carlike", "converter_lines", "polygon_footprint", "via_points",
                 "nonuniform")  # paths A-E


def fused_groups():
    """The fused kernel's library groups that the smoke launches: those of
    the flagship, config #2, paths A-F and every case of phases 14 and 23,
    in float32 and float64."""
    import torch

    from mpc_local_planner_tpu_torch.benchmarks import family_spec
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a

    specs = [flagship()[0], config2(), crank_nicolson_flagship()]
    specs += [family_spec(f, N=30) for f in PATH_FAMILIES]
    specs += [spec for _, spec, _ in all_cases()]
    return sorted({k2a.group(s, d) for s in specs for d in (torch.float32, torch.float64)})


def build_phase(tmp):
    """Build K1 and the fused kernel's groups the smoke launches, all at once
    (one nvcc each); as soon as K1 is built, make the main paths' cold
    starts (``cold_phase``), each in a process of its own, beside the
    fused kernel's builds. Print each build's seconds, ptxas' registers,
    stack frames and spills for every instantiation, the cold solves'
    lines and the phase's wall time. Returns (the wall time, the seconds
    until the builds were done, each path's cold start file)."""
    from concurrent.futures import ThreadPoolExecutor

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda, riccati_cuda

    files = {tag: f"{tmp}/cold_{tag}.pt" for tag in COLD_PATHS}
    jobs = [(f"cold {tag}", [sys.executable, __file__, "--cold", tag, files[tag]])
            for tag in COLD_PATHS]

    def colds(k1):
        k1.result()
        return run_processes(jobs, tmp)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        k1 = pool.submit(riccati_cuda.build)
        fused = pool.submit(fused_al_sqp_cuda.build, fused_groups())
        cold = pool.submit(colds, k1)
        builds = [k1.result(), *fused.result()]
        built_s = time.perf_counter() - t0
        failed = cold.result()
    wall = time.perf_counter() - t0
    for built in builds:
        print(f"build: {built['path']} in {built['seconds']:.2f} s")
        for name, usage in ptxas_rows(built["ptxas"]):
            print(f"  ptxas: {name}: {usage}")
    if failed:
        _fail(f"failed in the build phase: {', '.join(failed)}")
    print(f"build: phase 2 wall {wall:.2f} s (the builds {built_s:.2f} s, the cold solves "
          "beside them)")
    return wall, built_s, files


def ptxas_rows(report):
    """(kernel, 'R registers, S B stack, spills st/ld B') per entry function
    of ptxas' report; the fused kernel's name as its template arguments."""
    import re

    rows, name, usage = [], None, {}
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            args = re.search(r"k2a_kernelI([fd])Li(\d)ELi(\d)ELi(\d+)ELb([01])ELi(\d)E", name)
            if args:
                t, model, obj, geo, nonu, colloc = args.groups()
                objective = {"0": "minimum time", "1": "quadratic", "2": "via points"}[obj]
                rule = {"0": "", "1": ", midpoint / Crank-Nicolson / shooting"}[colloc]
                name = (f"k2a_kernel<{'float' if t == 'f' else 'double'}, model {model}, "
                        f"{objective}, GEO {geo}{', NONU' if nonu == '1' else ''}{rule}>")
            usage = {}
        for key, pat in (("stack", r"(\d+) bytes stack frame"), ("st", r"(\d+) bytes spill stores"),
                         ("ld", r"(\d+) bytes spill loads"), ("reg", r"Used (\d+) registers")):
            found = re.search(pat, line)
            if found:
                usage[key] = found.group(1)
        if name and "reg" in usage:
            rows.append((name, f"{usage['reg']} registers, {usage.get('stack', '?')} B stack, "
                               f"spills {usage.get('st', '?')}/{usage.get('ld', '?')} B"))
            name = None
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a  # fails outside the repo
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    # ---- 1. device ------------------------------------------------------ #
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)

    # ---- 2. build ------------------------------------------------------- #
    t_start = time.perf_counter()
    import tempfile

    cold_dir = tempfile.TemporaryDirectory()
    build_s, built_s, cold_files = build_phase(cold_dir.name)
    laps, t_lap = {}, [time.perf_counter()]

    def lap(tag):
        """The seconds since the last lap, under ``tag`` in ``smoke_split_s``."""
        now = time.perf_counter()
        laps[tag] = now - t_lap[0]
        t_lap[0] = now

    # ---- 3. K1 against its plain version --------------------------------- #
    spec, cold, warm, rescue_set, _ = path_settings("flagship")
    k1 = kernel_phase(spec, warm, device)
    kernel_phase(flagship(N=K1_LONG_N)[0], warm, device, batches=(BATCH,),
                 tag=f"K1 N={K1_LONG_N}")
    lap("3_k1")

    # ---- 4. main path, un-fused ------------------------------------------ #
    reset_counts()
    t0 = time.perf_counter()
    extra, settled, secs, cycle, cold_start, _, final = main_path(
        spec, cold, warm, rescue_set, device, load_cold_start(cold_files["flagship"]))
    launches = riccati_cuda.lqr_solve_cuda.launches
    main_s = time.perf_counter() - t0
    expected = (SETTLE_CYCLES + TIMED_CYCLES) * (
        warm.n_al * warm.n_sqp + rescue_set.n_al * rescue_set.n_sqp)
    print(json.dumps({**extra, "path": "unfused", "k1_launches": launches,
                      "k2a_launches": k2a.fused_solve_cuda.launches, "device": card, **secs,
                      "main_path_s": main_s}))
    if launches != expected or k2a.fused_solve_cuda.launches != 0:
        _fail(f"K1 launched {launches} times on the un-fused path, expected {expected}")
    if not extra["converged_frac"] >= 0.5:
        _fail(f"converged_frac {extra['converged_frac']} below the 0.5 floor")

    # ---- 5. K1-vs-plain gate on the live warm state ------------------------ #
    gate, passed = gate_phase(spec, dataclasses.replace(warm, kkt="scan"), warm, settled)
    print(json.dumps({"k1_vs_plain_gate": gate, "passed": passed}))
    if not passed:
        _fail(f"K1-vs-plain gate failed: {gate}")

    # ---- 6. where one un-fused warm cycle's device time goes -------------- #
    print(json.dumps({"trace": trace_phase(cycle, settled, extra["cycle_ms"])}))
    lap("4_6_unfused")

    # ---- 7. K2a against its plain version --------------------------------- #
    checks = F64Checks()
    checks.add_oracle("unfused", spec, cold, final)
    warm_f = dataclasses.replace(warm, fused="auto")
    rescue_f = dataclasses.replace(rescue_set, fused="auto")
    k2a_rows = k2a_phase(spec, warm_f, rescue_f, settled, checks)
    lap("7_k2a")

    # ---- 8. main path, fused, from the same cold solve --------------------- #
    reset_counts()
    t0 = time.perf_counter()
    extra_f, settled_f, secs_f, cycle_f, _, k1_in_cycles, final_f = main_path(
        spec, cold, warm_f, rescue_f, device, cold_start=cold_start
    )
    checks.add_oracle("fused", spec, cold, final_f)
    k2a_launches = k2a.fused_solve_cuda.launches
    k1_fused = riccati_cuda.lqr_solve_cuda.launches
    by_rule = rule_counts()
    main_f_s = time.perf_counter() - t0
    print(json.dumps({**extra_f, "path": "fused", "k2a_launches": k2a_launches,
                      "fused_launches_by_rule": by_rule,
                      "k1_launches": k1_fused, "k1_launches_in_warm_cycles": k1_in_cycles,
                      "device": card, **secs_f, "main_path_s": main_f_s}))
    if k2a_launches != 2 * (SETTLE_CYCLES + TIMED_CYCLES):
        _fail(f"K2a launched {k2a_launches} times on the fused path, expected "
              f"{2 * (SETTLE_CYCLES + TIMED_CYCLES)}")
    if k1_in_cycles != 0 or k1_fused != 0:
        _fail(f"K1 launched {k1_in_cycles} times in the fused warm cycles and {k1_fused} "
              "in all, expected 0 (the cold solve is the build phase's)")
    if not extra_f["converged_frac"] >= 0.5:
        _fail(f"fused converged_frac {extra_f['converged_frac']} below the 0.5 floor")

    # ---- 9. fused-vs-un-fused gate on the live warm state ------------------- #
    gate_f, passed = gate_phase(spec, warm, warm_f, settled_f)
    print(json.dumps({"k2a_vs_unfused_gate": gate_f, "passed": passed}))
    if not passed:
        _fail(f"fused-vs-un-fused gate failed: {gate_f}")

    # ---- 10. where one fused warm cycle's device time goes ----------------- #
    print(json.dumps({"trace_fused": trace_phase(cycle_f, settled_f, extra_f["cycle_ms"])}))
    lap("8_10_fused")

    # ---- 11. K1 without the free δτ (config #2, fixed dt) ------------------- #
    spec2, cold2, warm2, rescue2, _ = path_settings("config2")
    kernel_phase(spec2, warm2, device, batches=(BATCH,), tag="K1 config2")

    # ---- 12. config #2 main path, fused ------------------------------------- #
    warm2_f = dataclasses.replace(warm2, fused="auto")
    rescue2_f = dataclasses.replace(rescue2, fused="auto")
    extra2, settled2, cycle2, fused2, _ = fused_path(
        "config2_fused", spec2, cold2, warm2_f, rescue2_f, device, card, 0.25, checks,
        cold_start=load_cold_start(cold_files["config2"]),
    )

    # ---- 13. the kernel against its plain version on config #2 -------------- #
    k2_rows = k2a_phase(spec2, warm2_f, rescue2_f, settled2, checks, name="config2")

    # ---- 15-16. config #2 fused-vs-un-fused gate, trace ---------------------- #
    gate_and_trace("config2", spec2, warm2, warm2_f, settled2, cycle2, extra2["cycle_ms"])
    lap("11_16_config2")

    # ---- 17-19. path A: the reference's car-like config (two discs) --------- #
    specA, coldA, warmA, rescueA, _ = path_settings("canonical_carlike")
    warmA_f = dataclasses.replace(warmA, fused="auto")
    rescueA_f = dataclasses.replace(rescueA, fused="auto")
    extraA, settledA, cycleA, fusedA, _ = fused_path(
        "canonical_carlike_fused", specA, coldA, warmA_f, rescueA_f, device, card, 0.5,
        checks, cold_start=load_cold_start(cold_files["canonical_carlike"]),
    )
    rows_a = k2a_phase(specA, warmA_f, rescueA_f, settledA, checks, name="pathA")
    gate_and_trace("canonical_carlike", specA, warmA, warmA_f, settledA, cycleA,
                   extraA["cycle_ms"])
    lap("17_19_path_a")

    # ---- 20-22. path B: the wall world (line slots), warm 4x4, chained ------ #
    specB, coldB, warmB, _, _ = path_settings("converter_lines")
    warmB = dataclasses.replace(warmB, n_al=4)
    warmB_f = dataclasses.replace(warmB, fused="auto")
    rescueB_f = dataclasses.replace(warmB_f, alphas=rescue_set.alphas)
    extraB, settledB, cycleB, fusedB, finalB = fused_path(
        "converter_lines_fused", specB, coldB, warmB_f, rescueB_f, device, card, 0.25,
        checks, oracle=False, cold_start=load_cold_start(cold_files["converter_lines"]),
        slots=LINES_RESCUE_SLOTS, chain=2, stuck_restart=2,
    )
    print(json.dumps({"pathB_seed": "astar", "astar_plans": extraB["astar_plans"],
                      "of": BATCH, **{k: extraB[k] for k in (
                          "astar_build_parallel_s", "converged_frac")},
                      "straight_line_converged_frac_of_record":
                          LINES_STRAIGHT_LINE_CONVERGED_FRAC, "device": card}))
    rows_b = k2a_phase(specB, warmB_f, rescueB_f, settledB, checks, name="pathB",
                       slots=LINES_RESCUE_SLOTS)
    gate_and_trace("converter_lines", specB, warmB, warmB_f, settledB, cycleB,
                   extraB["cycle_ms"])
    # phases 36, 37 and 39 run at the end beside the float64 checks; 36 and
    # 37 run path B's oracle (A* re-planned at the current states) first
    checks.add_solver_phases("converter_lines_fused", specB, coldB, finalB)
    lap("20_22_path_b")

    # ---- 38. the horizon-parallel Riccati solve on K1's inputs ------------ #
    pscan_phase(spec, warm, device, k1[BATCH])
    lap("38_pscan")

    # ---- 24-26. path C: the polygon-footprint family (a moving rectangle) -- #
    specC, coldC, warmC, rescueC, _ = path_settings("polygon_footprint")
    warmC_f = dataclasses.replace(warmC, fused="auto")
    rescueC_f = dataclasses.replace(rescueC, fused="auto")
    extraC, settledC, cycleC, fusedC, _ = fused_path(
        "polygon_footprint_fused", specC, coldC, warmC_f, rescueC_f, device, card, 0.5,
        checks, cold_start=load_cold_start(cold_files["polygon_footprint"]),
    )
    rows_c = k2a_phase(specC, warmC_f, rescueC_f, settledC, checks, name="pathC")
    gate_and_trace("polygon_footprint", specC, warmC, warmC_f, settledC, cycleC,
                   extraC["cycle_ms"])
    lap("24_26_path_c")

    # ---- 27-29. path D: the via-points family (K2d) ------------------------ #
    specD, coldD, warmD, rescueD, _ = path_settings("via_points")
    warmD_f = dataclasses.replace(warmD, fused="auto")
    rescueD_f = dataclasses.replace(rescueD, fused="auto")
    extraD, settledD, cycleD, fusedD, _ = fused_path(
        "via_points_fused", specD, coldD, warmD_f, rescueD_f, device, card, 0.5,
        checks, cold_start=load_cold_start(cold_files["via_points"]),
    )
    rows_d = k2a_phase(specD, warmD_f, rescueD_f, settledD, checks, name="pathD")
    gate_and_trace("via_points", specD, warmD, warmD_f, settledD, cycleD, extraD["cycle_ms"])
    lap("27_29_path_d")

    # ---- 30-32. path E: the non-uniform grid (K2f) ------------------------ #
    specE, coldE, warmE, rescueE, _ = path_settings("nonuniform")
    warmE_f = dataclasses.replace(warmE, fused="auto")
    rescueE_f = dataclasses.replace(rescueE, fused="auto")
    extraE, settledE, cycleE, fusedE, _ = fused_path(
        "nonuniform_fused", specE, coldE, warmE_f, rescueE_f, device, card, 0.5,
        checks, cold_start=load_cold_start(cold_files["nonuniform"]),
    )
    rows_e = k2a_phase(specE, warmE_f, rescueE_f, settledE, checks, name="pathE")
    gate_and_trace("nonuniform", specE, warmE, warmE_f, settledE, cycleE, extraE["cycle_ms"])
    lap("30_32_path_e")

    # ---- 33-35. path F: the Crank–Nicolson flagship (K2b) ---------------- #
    specF, coldF, warmF, rescueF, _ = path_settings("crank_nicolson")
    warmF_f = dataclasses.replace(warmF, fused="auto")
    rescueF_f = dataclasses.replace(rescueF, fused="auto")
    extraF, settledF, cycleF, fusedF, _ = fused_path(
        "crank_nicolson_fused", specF, coldF, warmF_f, rescueF_f, device, card, 0.5,
        checks, cold_start=load_cold_start(cold_files["crank_nicolson"]),
    )
    rows_f = k2a_phase(specF, warmF_f, rescueF_f, settledF, checks, name="pathF")
    gate_and_trace("crank_nicolson", specF, warmF, warmF_f, settledF, cycleF,
                   extraF["cycle_ms"])
    lap("33_35_path_f")

    # ---- 41-43. the Controller: the fleet, one robot, the rest ------------ #
    fleet, fleet_ctrl, fleet_scen = controller_fleet_phase(device, card)
    robot = controller_robot_phase(device, card)
    controller_surface_phase(device, card)
    lap("41_43_controller")

    # ---- 44-45. serving and the planner shell ---------------------------- #
    serving = serving_phase(device, card, checks)
    lap("44_serving")
    shell = shell_phase(device, card)
    lap("45_shell")

    # ---- 46-47. the parallel layer and the aux surface --------------------- #
    par = parallel_phase(device, card, spec, warm_f, rescue_f, final_f)
    lap("46_parallel")
    aux = aux_phase(device, card, spec, warm_f, final_f, fleet_ctrl, fleet_scen)
    lap("47_aux")
    paths_s = time.perf_counter() - t_start - build_s

    # ---- the paths' f64 checks; 14 and 23: the other models, config #1, the
    # K2c-K2f, K2b and K2e cases ------------------------------------------- #
    t_cases = time.perf_counter()
    case_rows = last_phase(checks, [name for name, _, _ in all_cases()])
    print(json.dumps({"smoke_split_s": {
        "build_and_cold_solves": build_s, "builds": built_s, "phases_3_to_47": paths_s,
        "f64_checks_and_cases": time.perf_counter() - t_cases,
        "total_before_summary": time.perf_counter() - t_start, "paths": laps}}))

    # ---- 48. summary ---------------------------------------------------- #
    row, row2, row3 = k1[BATCH], k2a_rows[BATCH], k2_rows[BATCH]
    from mpc_local_planner_tpu_torch.ocp.collocation import SHOOTING_PREFIX

    def rule_launches(*prefixes):
        """The main paths' launches of the rules that start with one of ``prefixes``."""
        return sum(n for rule, n in RULE_LAUNCHES.items() if rule.startswith(prefixes))

    def fused_row(name, launches, r, line=264, by_path=None):
        row = {
            "name": name,
            "route": "cuda",
            "source": "mpc_local_planner_tpu_torch/csrc/fused_al_sqp.cu",
            "replaces": f"mpc_local_planner_tpu/ops/fused_al_sqp_pallas.py:{line}",
            "launches": launches if by_path is None else sum(by_path.values()),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        }
        if by_path is not None:
            row["launches_by_path"] = by_path
        return row

    k1_by_path = {"unfused_main": launches, "controller_fleet": fleet["k1_launches"],
                  "controller_robot": robot["k1_launches"], "serving": serving["k1_launches"],
                  "shell": shell["k1_launches"],
                  **{p: n for line in (par, aux) for p, n in line["k1_launches_by_path"].items()}}
    k2a_by_path = {"fused_main": k2a_launches, "controller_fleet": fleet["fused_launches"],
                   **{p: n for line in (par, aux)
                      for p, n in line["fused_launches_by_path"].items()}}
    print(json.dumps({"kernels": [{
        "name": "K1 riccati_sweep",
        "route": "cuda",
        "source": "mpc_local_planner_tpu_torch/csrc/riccati_sweep.cu",
        "replaces": "mpc_local_planner_tpu/ops/riccati_pallas.py:37",
        "launches": sum(k1_by_path.values()),
        "launches_by_path": k1_by_path,
        "max_abs_err": row["max_abs_err_f32"],
        "ms": row["ms"],
        "device_ms": row["device_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    },
        fused_row("K2a fused_al_sqp", k2a_launches, row2, by_path=k2a_by_path),
        fused_row("K2 fused_al_sqp: unicycle, quadratic form, terminal ball, fixed dt "
                  "(config #2)", fused2, row3,
                  by_path={"config2_main": fused2, **par["config2_fused_launches_by_path"]}),
        fused_row("K2 fused_al_sqp: simple car, two-disc footprint (K2c; the reference's "
                  "car-like config, path A)", fusedA, rows_a[BATCH]),
        fused_row("K2 fused_al_sqp: simple car, disc, line slots (K2c; the wall world, "
                  "path B, warm 4x4)", fusedB, rows_b[BATCH]),
        fused_row("K2 fused_al_sqp: simple car, polygon footprint, circle slots (K2c; the "
                  "polygon-footprint family, path C)", fusedC, rows_c[BATCH]),
        fused_row("K2 fused_al_sqp: simple car, minimum time with via points (K2d; the "
                  "via-points family, path D)", fusedD, rows_d[BATCH]),
        fused_row("K2 fused_al_sqp: simple car, minimum time on the non-uniform per-stage "
                  "dt grid (K2f; the non-uniform family, path E)", fusedE, rows_e[BATCH]),
        fused_row("K2 fused_al_sqp: simple car, Crank-Nicolson differences (K2b, the "
                  "-E^-1 fold of the Pallas defect; the Crank-Nicolson flagship, path F)",
                  rule_launches("midpoint_differences", "crank_nicolson_differences"),
                  rows_f[BATCH], line=552),
        fused_row("K2 fused_al_sqp: simple car on the shooting_rk4 grid (K2e, the tableau "
                  "walk of _shoot_phi; the B=1024 case shooting-rk4-flagship, on no main "
                  "path)", rule_launches(SHOOTING_PREFIX), case_rows["shooting-rk4-flagship"],
                  line=481),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


# The horizon-parallel solve against the plain sequential sweep, relative to
# the step's largest entry: float64 a few ulps (the same solution by another
# order of operations: 1.5e-15 on these inputs on the H100); float32 K1's
# tolerance (6.8e-7 on the H100).
PSCAN_RTOL = {"f64": 1e-9, "f32": 1e-4}


def pscan_phase(spec, warm, device, k1_row):
    """Phase 38: ``lqr_solve_pscan`` against the plain ``lqr_solve`` on K1's
    inputs (the flagship's, B=4096, N=30) on the card, in float64 and
    float32; both timed with CUDA events beside K1's device time."""
    import torch

    from mpc_local_planner_tpu_torch.solvers.riccati import lqr_solve
    from mpc_local_planner_tpu_torch.solvers.riccati_pscan import lqr_solve_pscan

    args32 = riccati_inputs(spec, warm, ensemble(spec, BATCH, device))
    kw = dict(nx=spec.nx, free_tau=spec.variable_dt)
    row = {"batch": BATCH, "N": spec.N}
    for name, args in (("f64", tuple(a.double() for a in args32)), ("f32", args32)):
        got, want = lqr_solve_pscan(*args, **kw), lqr_solve(*args, **kw)
        torch.cuda.synchronize()
        abs_err, rel_err = _max_rel_err(got, want)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        print(f"pscan {name} B={BATCH}: max_abs_err={abs_err:.3e} rel_err={rel_err:.3e} "
              f"(tol {PSCAN_RTOL[name]:g}) finite={finite}")
        if not finite or not rel_err <= PSCAN_RTOL[name]:
            _fail(f"lqr_solve_pscan disagrees with lqr_solve ({name})")
        row[f"rel_err_{name}"] = rel_err
    row["pscan_ms"] = _cuda_ms(lambda: lqr_solve_pscan(*args32, **kw), 5)
    row["plain_ms"] = _cuda_ms(lambda: lqr_solve(*args32, **kw), 5)
    row["k1_device_ms"], row["k1_ms"] = k1_row["device_ms"], k1_row["ms"]
    print(json.dumps({"pscan": row}))


def golden_phase(spec, final):
    """Phase 36: ``classify_feasibility`` on the first CALIBRATION_LANES lanes
    of path B's final state, A*-seeded from the current states (the
    oracle's seed), at the pipeline's tolerance, as bench.py's
    ``BENCH_CALIBRATE`` runs it: the float64 AL solve on the card (K1 in
    double), SLSQP on the host; the golden labels against the cold oracle's
    and the warm path's flags."""
    import numpy as np

    from mpc_local_planner_tpu_torch.benchmarks import classify_feasibility
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    scen, r, feas, seed = final
    n = CALIBRATION_LANES
    k1_before = riccati_cuda.lqr_solve_cuda.launches
    t0 = time.perf_counter()
    labels, details = classify_feasibility(spec, scen, max_instances=n, tol=CALIBRATION_TOL,
                                           seed_primal=seed, device=scen.x0.device)
    secs = time.perf_counter() - t0
    gold = np.array([lab == "feasible" for lab in labels])
    conv, oracle = r.converged[:n].cpu().numpy(), feas[:n].cpu().numpy()
    n_gold = max(int(gold.sum()), 1)
    cal = {
        "n": n, "tol": CALIBRATION_TOL,
        "golden_feasible_frac": float(gold.mean()),
        "oracle_feasible_frac_sub": float(oracle.mean()),
        "oracle_golden_agreement": float((gold == oracle).mean()),
        "oracle_missed_feasible": int((gold & ~oracle).sum()),
        "oracle_false_feasible": int((~gold & oracle).sum()),
        "conv_frac_sub": float(conv.mean()),
        "conv_on_feasible_golden": float((conv & gold).sum() / n_gold),
        "certified_by": [p["certified_by"] for p in details["per_instance"]],
        "k1_launches": riccati_cuda.lqr_solve_cuda.launches - k1_before,
        "classify_s": secs,
    }
    print(json.dumps({"golden_calibration": cal, "device": card_line()}))
    if len(labels) != n or not gold.any():
        _fail(f"the golden classifier certified no lane of {n}: {cal}")
    if cal["k1_launches"] == 0:
        _fail("the golden classifier's float64 AL solve did not run on the card")


def f64_tier_phase(spec, final):
    """Phase 37: ``make_f64_fallback`` over every straggler of path B's last
    warm result, the float64 solve on the card, its fresh seed the A* seed
    of the oracle: no converged flag may turn false, and every lane it does
    not rescue keeps its result bit for bit."""
    import torch

    from mpc_local_planner_tpu_torch.core.tree import tree_map
    from mpc_local_planner_tpu_torch.ops import riccati_cuda
    from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings
    from mpc_local_planner_tpu_torch.solvers.f64_fallback import make_f64_fallback

    scen, r, feas, seed = final
    s64 = SolverSettings.for_spec(spec, early_exit=True, tol_eq=CALIBRATION_TOL,
                                  tol_ineq=CALIBRATION_TOL)
    tier = make_f64_fallback(spec, s64, F64_SLOTS, device=scen.x0.device)
    k1_before = riccati_cuda.lqr_solve_cuda.launches
    t0 = time.perf_counter()
    out = tier(scen, r, fresh_primal=seed)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    conv0, conv1 = r.converged, out.converged
    kept = ~conv1 | conv0
    same = []
    tree_map(lambda a, b: same.append(bool(((a == b) | (a != a) & (b != b))[kept].all())),
             out, r)
    n_feas = max(int(feas.sum()), 1)
    row = {
        "stragglers": int((~conv0).sum()), "rescued": int((conv1 & ~conv0).sum()),
        "slots": F64_SLOTS, "converged_frac_before": float(conv0.float().mean()),
        "converged_frac_after": float(conv1.float().mean()),
        "conv_on_feasible_after": int((conv1 & feas).sum()) / n_feas,
        "k1_launches": riccati_cuda.lqr_solve_cuda.launches - k1_before,
        "fallback_s": secs,
    }
    print(json.dumps({"f64_tier": row, "device": card_line()}))
    if bool((conv0 & ~conv1).any()):
        _fail("the float64 tier turned a converged flag false")
    if not all(same):
        _fail("the float64 tier changed a lane it did not rescue")
    if row["stragglers"] and row["k1_launches"] == 0:
        _fail("the float64 tier's solve did not run on the card")


LM_BUDGET = (6, 10)  # (n_al, n_sqp): 60 LM iterations


def lm_phase():
    """Phase 39: ``solve_single_lm`` on LM_LANES flagship lanes on the card
    and on the first LM_CPU_LANES of them on the CPU, both in float64 from
    the straight-line seed: bench.py's gate on those lanes (conv flags, max
    |Δxs| on lanes converged on both within the bound of a 60-iteration
    budget)."""
    import torch

    from mpc_local_planner_tpu_torch.core.tree import tree_map
    from mpc_local_planner_tpu_torch.solvers import agreement
    from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings, default_init
    from mpc_local_planner_tpu_torch.solvers.lsq_lm import solve_single_lm

    spec = flagship()[0]
    n_al, n_sqp = LM_BUDGET
    st = SolverSettings.for_spec(spec, n_al=n_al, n_sqp=n_sqp, tol_eq=CALIBRATION_TOL,
                                 tol_ineq=CALIBRATION_TOL)
    scen = tree_map(lambda a: a.double() if a.is_floating_point() else a,
                    ensemble(spec, LM_LANES, torch.device("cuda", 0)))
    init, duals = default_init(spec, st, scen, dtype=torch.float64)
    t0 = time.perf_counter()
    card = solve_single_lm(spec, st, scen, init, duals)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    head = lambda t: tree_map(lambda a: a[:LM_CPU_LANES].cpu(), t)  # noqa: E731
    t0 = time.perf_counter()
    cpu = solve_single_lm(spec, st, head(scen), head(init), head(duals))
    cpu_s = time.perf_counter() - t0
    info, passed = agreement.gate(head(card), cpu, n_al * n_sqp)
    print(json.dumps({"lm": {"lanes": LM_LANES, "budget": [n_al, n_sqp],
                             "converged_frac": float(card.converged.float().mean()),
                             "card_s": card_s, "cpu_lanes": LM_CPU_LANES, "cpu_s": cpu_s,
                             **info}, "passed": passed, "device": card_line()}))
    if not passed or card.primal.xs.device.type != "cuda":
        _fail(f"Levenberg-Marquardt on the card disagrees with the CPU: {info}")


# --------------------------------------------------------------------------- #
# the Controller (phases 41-43)
# --------------------------------------------------------------------------- #
FLEET_STEPS = 9          # one cold step, then 8 warm ones
FLEET_ELAPSED_STEP = 4   # this step passes elapsed (per-lane shifts)
FLEET_REINIT_STEP = 6    # this step moves REINIT_LANES goals past the threshold
FLEET_ELAPSED = 0.25
REINIT_LANES = 512
REINIT_MOVE = 1.5        # metres along the goal's heading (threshold 1.0)
ROBOT_CYCLES = 30        # the single robot's closed loop, at most (21 to the goal on the H100)
ROBOT_PERIOD = 0.3       # seconds of driving per cycle (the cycles' elapsed)
ROBOT_SUBSTEPS = 6       # the simulated drive's Euler steps per cycle (the demo's)
ROBOT_GOAL = (2.4, 0.3, 0.0)
ROBOT_CIRCLES = [(1.0, 0.6, 0.2), (1.6, -0.35, 0.2), (0.5, -0.5, 0.15)]
# the surface phase's cold budget (its cycles check the surface, not the
# cold solve the single-robot phase already runs at the full preset)
SURFACE_COLD = {"iterations": 2, "inner_iterations": 3}


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts():
    """(K1, fused) launches since ``reset_counts``."""
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    return riccati_cuda.lqr_solve_cuda.launches, k2a.fused_solve_cuda.launches


def _load_libraries(spec, device):
    """Load K1's library and the fused kernel's group of ``spec`` before a
    timed path, as ``Controller.precompile`` does (each launch's first call
    would otherwise pay the library's load)."""
    import torch

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda, riccati_cuda

    if device.type == "cuda":
        riccati_cuda._load()
        fused_al_sqp_cuda._load(fused_al_sqp_cuda.group(spec, torch.float32))


def _load_k1(device):
    """Load K1's library before a timed path that launches no fused kernel."""
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    if device.type == "cuda":
        riccati_cuda._load()


def _recording(ctrl):
    """Record the inputs of each solve ``ctrl`` runs (``inputs[-1]``: the
    last step's (warm, scenario, init, duals))."""
    inputs = []
    build = ctrl._solver_fn

    def solver_fn(warm):
        fn = build(warm)

        def run(scenario, init, duals):
            inputs.append((warm, scenario, init, duals))
            return fn(scenario, init, duals)

        return run

    ctrl._solver_fn = solver_fn
    return inputs


def controller_fleet_phase(device, card, batch=BATCH):
    """Phase 41: ``Controller(cfg, batch=4096)`` on examples/demo_fleet.py's
    config (the flagship: simple car, disc r=0.2, 8 circle slots, N=30,
    minimum time, rescue_slots 1024) on ``random_ensemble`` seed 0: one cold
    step and 8 warm ones, feeding back the planned stage 1 and u0 of the
    converged lanes as the demo does; step 4 passes ``elapsed`` (per-lane
    shifts), step 6 moves 512 lanes' goals past
    ``force_reinit_new_goal_dist``. K1 must carry the cold step (240
    launches) and the fused kernel each warm step (the warm solve and the
    rescue: 2 launches); the last warm step's solve is held against the
    un-fused solve on the same inputs with bench.py's gate. Returns the
    line, the live Controller and its last scenario (phase 47 resumes it
    from a snapshot)."""
    import torch

    from mpc_local_planner_tpu_torch.benchmarks import random_ensemble
    from mpc_local_planner_tpu_torch.ocp.grid import initial_primal
    from mpc_local_planner_tpu_torch.ocp.spec import Scenario
    from mpc_local_planner_tpu_torch.planner import Controller, load_config
    from mpc_local_planner_tpu_torch.solvers import agreement
    from mpc_local_planner_tpu_torch.solvers.al_sqp import make_solver

    cfg = load_config({**FLEET_CONFIG, "solver": {**FLEET_CONFIG["solver"],
                                                  "rescue_slots": batch // 4}})
    ctrl = Controller(cfg, batch=batch, device=device)
    spec, cold, warm = ctrl.spec, ctrl.settings, ctrl.warm_settings
    scen = random_ensemble(spec, batch, torch.Generator().manual_seed(0), device=device)
    _load_libraries(spec, device)
    inputs = _recording(ctrl)
    steps = []
    reset_counts()
    t_path = time.perf_counter()
    for k in range(FLEET_STEPS):
        if k == FLEET_REINIT_STEP:
            xf = scen.xf.clone()
            heading = torch.stack([torch.cos(xf[:REINIT_LANES, 2]),
                                   torch.sin(xf[:REINIT_LANES, 2])], dim=-1)
            xf[:REINIT_LANES, :2] += REINIT_MOVE * heading
            scen = dataclasses.replace(scen, xf=xf)
        kw = {"elapsed": FLEET_ELAPSED} if k == FLEET_ELAPSED_STEP else {}
        shifts = None
        if kw:  # each lane's own stage count for the interval, as step computes it
            shifts = sorted({int(v) for v in torch.clamp(torch.round(
                FLEET_ELAPSED / ctrl._primal.dt.clamp(min=1e-6)), 1, spec.N // 2)})
        before = launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        res = ctrl.step(scen, **kw)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        now = launch_counts()
        row = {"step": k, "ms": ms, "k1": now[0] - before[0], "fused": now[1] - before[1],
               "converged_frac": float(res.solve.converged.float().mean())}
        if k == FLEET_REINIT_STEP:
            _, s_k, init_k, duals_k = inputs[-1]
            fresh = initial_primal(spec, s_k)
            lanes = slice(0, REINIT_LANES)
            # stage 0 is re-anchored to x0 on every lane
            reset = ((init_k.xs[lanes, 1:] == fresh.xs[lanes, 1:]).flatten(1).all(1)
                     & (init_k.xs[lanes, 0] == s_k.x0[lanes]).all(1)
                     & (init_k.us[lanes] == fresh.us[lanes]).flatten(1).all(1)
                     & (init_k.dt[lanes] == fresh.dt[lanes])
                     & (duals_k.lam_def[lanes] == 0).flatten(1).all(1)
                     & (duals_k.rho[lanes] == cold.rho0))
            row["reinit_lanes_reset"] = int(reset.sum())
        if shifts is not None:
            row["shift_steps"] = shifts
        steps.append(row)
        if not bool(torch.isfinite(res.u0).all()) or res.u0.shape != (batch, spec.nu):
            _fail(f"the fleet Controller's u0 is not finite of shape ({batch}, {spec.nu})")
        conv = res.solve.converged[:, None]
        scen = Scenario(x0=torch.where(conv, res.solve.primal.xs[:, 1], scen.x0), xf=scen.xf,
                        obstacles=scen.obstacles, via_points=scen.via_points,
                        via_mask=scen.via_mask, u_prev=torch.where(conv, res.u0, scen.u_prev))
    path_s = time.perf_counter() - t_path
    k1_total, fused_total = launch_counts()

    # the last warm step's solve against the un-fused solve on its inputs
    _, s_k, init_k, duals_k = inputs[-1]
    out_f = make_solver(spec, warm, device)(s_k, init_k, duals_k)
    out_u = make_solver(spec, dataclasses.replace(warm, fused="off"), device)(
        s_k, init_k, duals_k)
    gate, passed = agreement.gate(out_f, out_u, warm.n_al * warm.n_sqp)
    warm_ms = [r["ms"] for r in steps[1:]]
    trace = None
    if device.type == "cuda":  # one more warm step, under torch.profiler
        trace = trace_phase(lambda s, _r: ctrl.step(s), (scen, None), statistics.median(warm_ms))
    line = {
        "batch": batch, "N": spec.N, "cold": [cold.n_al, cold.n_sqp],
        "warm": [warm.n_al, warm.n_sqp], "rescue_slots": cfg.solver.rescue_slots,
        "cold_step_ms": steps[0]["ms"], "mean_warm_step_ms": statistics.mean(warm_ms),
        "median_warm_step_ms": statistics.median(warm_ms),
        "mean_warm_step_ms_after_the_first": statistics.mean(warm_ms[1:]),
        "k1_launches": k1_total, "fused_launches": fused_total,
        "converged_frac_by_step": [r["converged_frac"] for r in steps],
        "reinit_lanes_reset": steps[FLEET_REINIT_STEP]["reinit_lanes_reset"],
        "reinit_lanes": REINIT_LANES, "shift_steps_at_elapsed":
            steps[FLEET_ELAPSED_STEP]["shift_steps"], "steps": steps, "path_s": path_s,
        "gate": gate, "gate_passed": passed, "trace": trace, "device": card,
    }
    print(json.dumps({"controller_fleet": line}))
    want = [(cold.n_al * cold.n_sqp, 0)] + [(0, 2)] * (FLEET_STEPS - 1)
    got = [(r["k1"], r["fused"]) for r in steps]
    if got != want:
        _fail(f"the fleet Controller launched (K1, fused) {got} by step, expected {want}")
    if line["reinit_lanes_reset"] != REINIT_LANES:
        _fail(f"{line['reinit_lanes_reset']} of {REINIT_LANES} moved-goal lanes reset")
    if not passed:
        _fail(f"the fleet Controller's fused warm solve fails the gate: {gate}")
    if not steps[-1]["converged_frac"] >= 0.5:
        _fail(f"the fleet Controller's converged_frac {steps[-1]['converged_frac']} < 0.5")
    return line, ctrl, scen


def _drive(model, x, u_seq, period, substeps):
    """The simulated robot, as examples/demo_planner.py drives it:
    ``period`` seconds of Euler steps under the planned controls sampled by
    zero-order hold (a variable-dt plan's stages are shorter than the
    period), in float64 on the host. Returns the new state and the control
    applied last (the next cycle's u_prev)."""
    import torch

    h = period / substeps
    u_seq = type(u_seq)(times=u_seq.times.double().cpu(), values=u_seq.values.double().cpu())
    for s in range(substeps):
        u = u_seq.interpolate((s + 0.5) * h, mode="zoh")
        x = x + h * model.f(x, u)
    return torch.cat([x[:2], torch.remainder(x[2:] + math.pi, 2 * math.pi) - math.pi]), u


def controller_robot_phase(device, card, cycles=ROBOT_CYCLES):
    """Phase 42: ``Controller(cfg)`` unbatched on
    examples/cfg/carlike_minimum_time.yaml (N=50, two circles, 30 slots): a
    closed loop of at most ROBOT_CYCLES cycles, each from the simulated
    state with ``elapsed``, the 3 circles of ``ObstacleSet.from_lists``
    through ``Scenario.goal_only`` (padded to 30 slots), until
    ``is_goal_reached``; the robot drives the planned controls as
    examples/demo_planner.py does. Every warm step launches K1 once per SQP
    iteration (2×4 = 8) and the fused kernel never. The goal's pose is held
    to the config's tolerances (0.2 m, 0.1 rad), which a float32 minimum-time
    plan with a fixed terminal pose may miss by rounding alone; the phase
    prints the cycles to the goal (null when missed) and the closest
    approach, and fails when the robot came no closer than half its start
    distance."""
    import torch

    from mpc_local_planner_tpu_torch.core.so2 import angle_diff
    from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
    from mpc_local_planner_tpu_torch.ocp.spec import Scenario
    from mpc_local_planner_tpu_torch.planner import Controller, load_config

    ctrl = Controller(load_config(CARLIKE_MINIMUM_TIME), device=device)
    spec, warm = ctrl.spec, ctrl.warm_settings
    _load_libraries(spec, device)
    obs = ObstacleSet.from_lists(circles=ROBOT_CIRCLES, device=device)
    goal = torch.tensor(ROBOT_GOAL, dtype=torch.float64)
    x = torch.zeros(3, dtype=torch.float64)
    u_prev = torch.zeros(2, device=device)
    rows, reached, closest = [], None, None
    reset_counts()
    t_path = time.perf_counter()
    for cycle in range(cycles):
        scen = Scenario.goal_only(x, goal, nu=spec.nu, obstacle_set=obs, device=device)
        scen = dataclasses.replace(scen, u_prev=u_prev)
        before = launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        res = ctrl.step(scen, elapsed=ROBOT_PERIOD)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        now = launch_counts()
        rows.append({"cycle": cycle, "ms": ms, "k1": now[0] - before[0],
                     "fused": now[1] - before[1], "converged": bool(res.solve.converged),
                     "x": [round(v, 4) for v in x.tolist()]})
        if not bool(torch.isfinite(res.u0).all()) or res.u0.shape != (spec.nu,):
            _fail("the single-robot Controller's u0 is not finite of shape (2,)")
        x, applied = _drive(spec.model, x, res.u_seq, ROBOT_PERIOD, ROBOT_SUBSTEPS)
        u_prev = applied.to(device=device, dtype=u_prev.dtype)
        dist = float(torch.linalg.norm(x[:2] - goal[:2]))
        if closest is None or dist < closest[0]:
            closest = (dist, abs(float(angle_diff(x[2], goal[2]))), cycle + 1)
        if ctrl.is_goal_reached(x, goal):
            reached = cycle + 1
            break
    path_s = time.perf_counter() - t_path
    warm_rows = rows[1:]
    warm_ms = sorted(r["ms"] for r in warm_rows)
    line = {
        "N": spec.N, "slots": spec.obstacle_cap, "cold": [ctrl.settings.n_al, ctrl.settings.n_sqp],
        "warm": [warm.n_al, warm.n_sqp], "cycles_to_goal": reached, "cycles": len(rows),
        "final_state": x.tolist(), "goal": list(ROBOT_GOAL),
        "closest_xy_m_yaw_rad_cycle": list(closest),
        "cold_step_ms": rows[0]["ms"],
        "median_warm_step_ms": statistics.median(warm_ms) if warm_ms else None,
        "p90_warm_step_ms": warm_ms[int(0.9 * (len(warm_ms) - 1))] if warm_ms else None,
        "k1_launches_per_warm_step": sorted({r["k1"] for r in warm_rows}),
        "k1_launches": sum(r["k1"] for r in rows), "fused_launches": sum(r["fused"] for r in rows),
        "converged_cycles": sum(r["converged"] for r in rows), "path_s": path_s,
        "cycles_ms_converged_start": [[round(r["ms"], 2), r["converged"], r["x"]] for r in rows],
        "device": card,
    }
    if device.type == "cuda" and warm_ms:  # one more warm step, under torch.profiler
        line["trace"] = trace_phase(lambda s, _r: ctrl.step(s, elapsed=ROBOT_PERIOD),
                                    (scen, None), line["median_warm_step_ms"])
    print(json.dumps({"controller_robot": line}))
    if line["fused_launches"] != 0:
        _fail(f"the single-robot Controller launched the fused kernel {line['fused_launches']} "
              "times; it runs the un-fused solve")
    if rows[0]["k1"] != ctrl.settings.n_al * ctrl.settings.n_sqp or any(
            r["k1"] != warm.n_al * warm.n_sqp for r in warm_rows):
        _fail(f"the single-robot Controller's K1 launches by cycle: {[r['k1'] for r in rows]}")
    start = float(torch.linalg.norm(goal[:2]))
    if reached is None and not closest[0] < 0.5 * start:
        _fail(f"the single robot came no closer than {closest[0]:.3f} m to its goal "
              f"({start:.3f} m away at the start)")
    return line


def controller_surface_phase(device, card):
    """Phase 43: the rest of the Controller's surface, unbatched, a few
    cycles each on carlike_minimum_time's config (its cold budget cut to
    SURFACE_COLD): ``time_based_single_step`` grid adaptation from N=50
    (the sequence of N), ``calibrate_cycle_budget`` with ``max_cycle_ms``
    (the phase time and the capped n_al), ``precompile`` over a 3-value
    ladder, a ``solver.type: lsq_lm`` step and a step with
    ``f64_fallback_slots`` (no converged flag turns false)."""
    import torch

    from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
    from mpc_local_planner_tpu_torch.ocp.spec import Scenario
    from mpc_local_planner_tpu_torch.planner import Controller, load_config

    def controller(**updates):
        cfg = {ns: dict(v) for ns, v in CARLIKE_MINIMUM_TIME.items()}
        for ns, v in updates.items():
            cfg[ns] = {**cfg.get(ns, {}), **v}
        cfg["solver"] = {**cfg["solver"], **SURFACE_COLD, **updates.get("solver", {})}
        return Controller(load_config(cfg), device=device)

    obs = ObstacleSet.from_lists(circles=ROBOT_CIRCLES[:1], device=device)

    def scenario(x0, goal):
        return Scenario.goal_only(x0, goal, obstacle_set=obs, device=device)

    row = {"cold": [SURFACE_COLD["iterations"], SURFACE_COLD["inner_iterations"]]}
    t0 = time.perf_counter()
    # time-based grid adaptation: a near goal, the optimized dt far below the
    # band (0.27-0.33 s) from the cold step on
    adapt = {"grid": {"variable_grid": {**CARLIKE_MINIMUM_TIME["grid"]["variable_grid"],
                                        "grid_adaptation": {"enable": True,
                                                            "min_grid_size": 40,
                                                            "max_grid_size": 60}}}}
    ctrl = controller(**adapt)
    scen = scenario([0.0, 0.0, 0.0], [0.8, 0.1, 0.0])
    ns = []
    for _k in range(3):
        res = ctrl.step(scen, elapsed=ROBOT_PERIOD)
        ns.append(ctrl._spec.N)
        scen = dataclasses.replace(scen, x0=res.solve.primal.xs[1])
    row["adaptation_N"] = ns
    if len(set(ns)) < 2 or not all(abs(a - b) <= 1 for a, b in zip(ns, ns[1:])):
        _fail(f"time_based_single_step took the horizons {ns}")
    # precompile: cold and warm solves of 3 horizons
    t1 = time.perf_counter()
    row["precompiled"] = controller(**adapt).precompile(scenario([0.0, 0.0, 0.0], [1.2, 0.2, 0.0]),
                                                        n_values=[48, 50, 52])
    row["precompile_s"] = time.perf_counter() - t1
    if row["precompiled"] != 6:
        _fail(f"precompile over 3 horizons cached {row['precompiled']} solves, expected 6")
    # the wall-clock budget: one AL phase measured, the warm n_al capped
    ctrl = controller(solver={"max_cycle_ms": 100.0})
    scen = scenario([0.0, 0.0, 0.0], [1.2, 0.2, 0.0])
    ctrl.step(scen)
    row["phase_ms"] = ctrl.calibrate_cycle_budget(scen)
    row["capped_n_al"] = ctrl.warm_settings.n_al
    res = ctrl.step(scen, elapsed=ROBOT_PERIOD)
    if row["capped_n_al"] != max(1, min(2, int(100.0 / row["phase_ms"]))):
        _fail(f"calibrate_cycle_budget capped n_al at {row['capped_n_al']}")
    # Levenberg-Marquardt
    ctrl = controller(solver={"type": "lsq_lm"})
    before = launch_counts()
    res = ctrl.step(scen)
    row["lm_converged"] = bool(res.solve.converged)
    row["lm_k1_launches"] = launch_counts()[0] - before[0]
    if not bool(torch.isfinite(res.u0).all()) or res.u0.device != device:
        _fail("the lsq_lm Controller's u0 is not finite on the card")
    # the float64 tier on the step's stragglers
    ctrl = controller(solver={"f64_fallback_slots": 4})
    passes = []
    tier = ctrl._f64_pass

    def recorded(scenario, result, fresh_seed=None):
        out = tier(scenario, result, fresh_seed)
        passes.append((bool(result.converged), bool(out.converged)))
        return out

    ctrl._f64_pass = recorded
    res = ctrl.step(scenario([0.0, 0.0, 0.0], [2.4, 0.3, 0.0]))
    row["f64_converged_before_after"] = passes
    if any(b and not a for b, a in passes):
        _fail(f"the float64 tier turned a converged flag false: {passes}")
    row["surface_s"] = time.perf_counter() - t0
    row["device"] = card
    print(json.dumps({"controller_surface": row}))
    return row


# --------------------------------------------------------------------------- #
# serving and the planner shell (phases 44-45)
# --------------------------------------------------------------------------- #
SERVE_JOURNEYS = 16      # examples/demo_serving.py's E
SERVE_BLOCK = 4          # cycles a block (the demo's 32, cut for the smoke's time)
SERVE_TIMED_BLOCKS = 2   # after one settling block
SHELL_CYCLES = 60        # the planner shell's closed loop, at most
SHELL_SUBSTEPS = 6       # the demo's ZOH substeps a cycle
# examples/cfg/diff_drive_quadratic_form.yaml written out (no YAML reader on
# the card's machine; tests/test_torch_config.py holds the two equal)
DIFF_DRIVE_QUADRATIC_FORM = {
    "robot": {"type": "unicycle", "unicycle": {
        "max_vel_x": 0.4, "max_vel_x_backwards": 0.2, "max_vel_theta": 0.3}},
    "grid": {"grid_size_ref": 20, "dt_ref": 0.3,
             "collocation_method": "forward_differences",
             "variable_grid": {"enable": False}},
    "planning": {
        "objective": {"type": "quadratic_form", "quadratic_form": {
            "state_weights": [2.0, 2.0, 2.0], "control_weights": [1.0, 1.0],
            "integral_form": False}},
        "terminal_cost": {"type": "quadratic", "quadratic": {
            "final_state_weights": [10.0, 10.0, 10.0]}},
        "terminal_constraint": {"type": "none"},
    },
    "collision": {"min_obstacle_dist": 0.2, "obstacle_capacity": 30},
    "footprint_model": {"type": "circular", "radius": 0.2},
}


def serving_settings():
    """bench.py::serving_mode's stream: the flagship (N=30, 8 circle
    slots), the early-exit warm 8×4 preset, ``StreamSettings()``."""
    from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time
    from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings

    spec = config3_carlike_min_time(N=30, obstacle_cap=8)
    warm = SolverSettings(n_al=8, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
                          alphas=(1.0, 0.5, 0.22), early_exit=True)
    return spec, warm


def journey_stream(device):
    from mpc_local_planner_tpu_torch.benchmarks import random_ensemble
    from mpc_local_planner_tpu_torch.planner.serving import JourneyStream, StreamSettings

    spec, warm = serving_settings()
    return JourneyStream(spec, warm, settings=StreamSettings(), device=device,
                         redraw_fn=lambda gen, n: random_ensemble(spec, n, gen, device=device))


class SqpCount:
    """Counts the SQP iterations the un-fused solve runs (each launches K1
    once on the card), by wrapping ``al_sqp._sqp_iteration`` while open."""

    def __enter__(self):
        from mpc_local_planner_tpu_torch.solvers import al_sqp

        self.n, self._orig = 0, al_sqp._sqp_iteration

        def counted(*args, **kwargs):
            self.n += 1
            return self._orig(*args, **kwargs)

        al_sqp._sqp_iteration = counted
        return self

    def __exit__(self, *exc):
        from mpc_local_planner_tpu_torch.solvers import al_sqp

        al_sqp._sqp_iteration = self._orig


def serving_phase(device, card, checks=None):
    """Phase 44: ``JourneyStream`` as bench.py::serving_mode runs it (the
    flagship, warm 8×4 early-exit, ``StreamSettings()``) over E=16 journeys
    of ``random_ensemble`` seed 0: ``init`` (the cold 16×15 solve), one
    settling block of 4 cycles, two timed blocks of 4. Every solve is the
    un-fused one: K1 once per SQP iteration (counted apart from the
    launches), the fused kernel never. The amortized cycle is the median of
    the timed blocks; one more cycle runs under torch.profiler. The final
    state and the abandoned journeys go to the last phase's oracle and
    audit (``checks``)."""
    import torch

    from mpc_local_planner_tpu_torch.planner.serving import JourneyStream

    stream = journey_stream(device)
    _load_k1(device)
    run = stream.block_fn(SERVE_BLOCK)
    per_cycle = []
    cycle = stream.cycle

    def counted_cycle(state):
        before, n0 = launch_counts(), sqp.n
        out = cycle(state)
        now = launch_counts()
        per_cycle.append((now[0] - before[0], now[1] - before[1], sqp.n - n0))
        return out

    stream.cycle = counted_cycle
    reset_counts()
    t_path = time.perf_counter()
    with SqpCount() as sqp:
        t0 = time.perf_counter()
        state = stream.init(SERVE_JOURNEYS, torch.Generator().manual_seed(0))
        n_conv0 = int(torch.sum(state.result.converged))
        init_s = time.perf_counter() - t0
        init_k1, init_sqp = launch_counts()[0], sqp.n
        blocks, block_ms, ab_rows = [], [], []
        for b in range(1 + SERVE_TIMED_BLOCKS):
            _sync(device)
            t0 = time.perf_counter()
            state, stats = run(state)
            n_conv = int(torch.sum(stats.converged))  # host fetch waits for the block
            ms = (time.perf_counter() - t0) * 1e3 / SERVE_BLOCK
            if b:
                block_ms.append(ms)
            rows, n_ab = JourneyStream.collect_abandoned(stats)
            if n_ab:
                ab_rows.append(rows)
            blocks.append({"converged": n_conv, "reached": int(torch.sum(stats.reached)),
                           "abandoned": n_ab, "ms_per_cycle": ms})
        k1, fused = launch_counts()
        n_sqp = sqp.n
    path_s = time.perf_counter() - t_path
    stream.cycle = cycle
    timed = blocks[1:]
    cycle_ms = statistics.median(block_ms)
    trace = {"device_busy_frac": None}
    if device.type == "cuda":  # one more cycle, under torch.profiler
        trace = trace_phase(lambda st, _r: stream.cycle(st), (state, None), cycle_ms)
    line = {
        "journeys": SERVE_JOURNEYS, "N": stream.spec.N, "warm": [stream.warm.n_al,
                                                                  stream.warm.n_sqp],
        "early_exit": stream.warm.early_exit, "block_cycles": SERVE_BLOCK,
        "timed_blocks": SERVE_TIMED_BLOCKS,
        "serving_amortized_cycle_ms_n30_carlike": cycle_ms, "block_ms_per_cycle": block_ms,
        "init_cold_s": init_s, "init_converged": n_conv0,
        "init_k1_launches": init_k1, "init_sqp_iterations": init_sqp,
        "converged": sum(b["converged"] for b in timed),
        "reached": sum(b["reached"] for b in timed),
        "abandoned": sum(b["abandoned"] for b in timed),
        "lane_cycles": SERVE_JOURNEYS * SERVE_BLOCK * SERVE_TIMED_BLOCKS, "blocks": blocks,
        "k1_launches_per_cycle": [c[0] for c in per_cycle],
        "sqp_iterations_per_cycle": [c[2] for c in per_cycle],
        "k1_launches": k1, "sqp_iterations": n_sqp, "fused_launches": fused,
        "device_busy_frac": trace["device_busy_frac"], "trace": trace, "path_s": path_s,
        "device": card,
    }
    print(json.dumps({"serving": line}))
    if fused != 0:
        _fail(f"the serving stream launched the fused kernel {fused} times")
    if k1 != n_sqp or any(c[0] != c[2] for c in per_cycle) or init_k1 != init_sqp:
        _fail(f"the serving stream launched K1 {k1} times over {n_sqp} SQP iterations")
    if not bool(torch.isfinite(state.result.primal.xs).all()) or state.scen.x0.shape != (
            SERVE_JOURNEYS, 3):
        _fail("the serving stream's final state is not finite of E journeys")
    if line["converged"] == 0:
        _fail("no journey of the serving stream converged in the timed blocks")
    if checks is not None:
        path = f"{checks.dir.name}/serving_final.pt"
        rows = None
        if ab_rows:
            from mpc_local_planner_tpu_torch.core.tree import tree_map

            rows = tree_map(lambda *xs: torch.cat(xs), ab_rows[0], *ab_rows[1:])
        torch.save({"scen": state.scen, "result": state.result, "rows": rows}, path)
        checks.add_serving(path)
    return line


def serving_oracle_worker(path):
    """``chip_smoke.py --serving-oracle FILE``: the stream's sampled oracle
    (``sample_oracle``: the cold preset on the final journeys) and the
    false-abandon audit (``audit_abandoned``) of every journey it
    abandoned, in a process of its own."""
    import torch

    from mpc_local_planner_tpu_torch.planner.serving import StreamState
    from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.set_num_threads(1)
    job = torch.load(path, map_location="cuda:0", weights_only=False)
    device = torch.device("cuda", 0)
    stream = journey_stream(device)
    cold = SolverSettings.for_spec(stream.spec)
    state = StreamState(scen=job["scen"], result=job["result"], stuck=None, generator=None)
    reset_counts()
    t0 = time.perf_counter()
    feas, conv = stream.sample_oracle(state)
    n_feas = int(torch.sum(feas))
    oracle_parallel_s = time.perf_counter() - t0
    k1 = launch_counts()[0]
    rows = job["rows"]
    t0 = time.perf_counter()
    audit = stream.audit_abandoned(rows) if rows is not None else {
        "n_abandoned": 0, "false_abandon_oracle": 0}
    line = {"path": "serving", "journeys": SERVE_JOURNEYS,
            "feasible_frac_cold_oracle": n_feas / SERVE_JOURNEYS,
            "conv_on_feasible": int(torch.sum(feas & conv)) / max(n_feas, 1),
            "oracle_parallel_s": oracle_parallel_s, "k1_launches": k1, "audit": audit,
            "audit_s": time.perf_counter() - t0, "device": card_line()}
    print(json.dumps({"oracle": line}))
    if k1 != cold.n_al * cold.n_sqp:
        _fail(f"K1 launched {k1} times in the serving oracle, expected "
              f"{cold.n_al * cold.n_sqp}")
    print_peak_memory("serving oracle and audit")


def shell_phase(device, card):
    """Phase 45: ``LocalPlanner`` on examples/demo_planner.py's scenario
    (examples/cfg/diff_drive_quadratic_form.yaml: unicycle, N=20, the
    quadratic form, 30 point slots; the 60×80 costmap with its two lethal
    blocks; the cosine plan to (3, 1)) in a closed loop of at most 60 cycles,
    the robot driving each cycle's planned controls by the demo's six ZOH
    substeps, until ``is_goal_reached``. The obstacles come from the native
    costmap scan (built from native/costmap.cpp), the post-solve veto from
    its trajectory check. Every cycle launches K1 once per SQP iteration of
    its budget (cold after a reset, warm otherwise) and the fused kernel
    never. Fails when the native library is not available, or when the
    robot came no closer than half its start distance."""
    import numpy as np
    import torch

    from mpc_local_planner_tpu_torch import native
    from mpc_local_planner_tpu_torch.planner import LocalPlanner, load_config
    from mpc_local_planner_tpu_torch.planner.local_planner import Costmap

    if not native.available():
        _fail("the native costmap runtime is not available (no C++ compiler)")
    t0 = time.perf_counter()
    lib = str(native.build())
    native_build_s = time.perf_counter() - t0
    cfg = load_config(DIFF_DRIVE_QUADRATIC_FORM)
    lp = LocalPlanner(cfg, device=device)
    ctrl = lp.controller
    spec = ctrl.spec
    _load_k1(device)
    t = np.linspace(0, 1, 40)
    plan = np.stack([3.0 * t, 0.5 * (1 - np.cos(np.pi * t)), np.zeros_like(t)], axis=1)
    lp.set_plan(plan)
    data = np.zeros((60, 80), dtype=np.uint8)
    data[24:26, 19:22] = 254   # world ≈ (1.5, 1.0), near the path
    data[32:36, 55:58] = 254   # world ≈ (5.2, 1.8), off the path
    cm = Costmap(data=data, origin=(-0.5, -1.5), resolution=0.1)
    step_ms = []
    step = ctrl.step

    def timed_step(*args, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        out = step(*args, **kwargs)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    ctrl.step = timed_step
    goal = plan[-1]
    x, u_prev = np.zeros(3), np.zeros(2)
    rows, reached, closest, vetoes = [], None, None, 0
    h = cfg.grid.dt_ref / SHELL_SUBSTEPS
    cold_iters = ctrl.settings.n_al * ctrl.settings.n_sqp
    warm_iters = ctrl.warm_settings.n_al * ctrl.warm_settings.n_sqp
    reset_counts()
    t_path = time.perf_counter()
    for cycle in range(SHELL_CYCLES):
        cold = ctrl._primal is None
        before, n_step = launch_counts(), len(step_ms)
        _sync(device)
        t0 = time.perf_counter()
        twist, res = lp.compute_velocity_commands(x, u_prev, costmap=cm)
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        now = launch_counts()
        stepped = step_ms[n_step] if len(step_ms) > n_step else 0.0
        rows.append({"cycle": cycle, "ms": ms, "shell_ms": ms - stepped, "cold": cold,
                     "k1": now[0] - before[0], "fused": now[1] - before[1],
                     "vetoed": res is None})
        if not np.all(np.isfinite(twist)) or twist.shape != (3,):
            _fail("the planner shell's twist is not finite of shape (3,)")
        if res is None:
            vetoes += 1
            continue
        for s in range(SHELL_SUBSTEPS):
            u_prev = res.u_seq.interpolate((s + 0.5) * h, mode="zoh").cpu().numpy()
            x = x + h * spec.model.f(torch.from_numpy(x), torch.from_numpy(u_prev)).numpy()
        dist = float(np.linalg.norm(x[:2] - goal[:2]))
        if closest is None or dist < closest[0]:
            closest = (dist, cycle + 1)
        if lp.is_goal_reached(x):
            reached = cycle + 1
            break
    path_s = time.perf_counter() - t_path
    ctrl.step = step
    k1, fused = launch_counts()
    warm_rows = [r for r in rows if not r["cold"]]
    warm_ms = sorted(r["ms"] for r in warm_rows)
    start = float(np.linalg.norm(goal[:2]))
    line = {
        "N": spec.N, "slots": spec.obstacle_cap, "cold": [ctrl.settings.n_al, ctrl.settings.n_sqp],
        "warm": [ctrl.warm_settings.n_al, ctrl.warm_settings.n_sqp],
        "cycles_to_goal": reached, "cycles": len(rows), "vetoes": vetoes,
        "final_state": x.tolist(), "goal": goal.tolist(), "start_distance_m": start,
        "closest_m_cycle": list(closest) if closest else None,
        "cold_cycle_ms": rows[0]["ms"],
        "median_cycle_ms": statistics.median(warm_ms) if warm_ms else None,
        "p90_cycle_ms": warm_ms[int(0.9 * (len(warm_ms) - 1))] if warm_ms else None,
        "median_shell_host_ms": statistics.median(r["shell_ms"] for r in rows),
        "k1_launches_per_warm_cycle": sorted({r["k1"] for r in warm_rows}),
        "k1_launches": k1, "fused_launches": fused,
        "native": native.available(), "native_library": os.path.basename(lib),
        "native_build_s": native_build_s, "path_s": path_s,
        "cycles_ms_k1": [[round(r["ms"], 2), r["k1"]] for r in rows], "device": card,
    }
    print(json.dumps({"shell": line}))
    if fused != 0:
        _fail(f"the planner shell launched the fused kernel {fused} times")
    if any(r["k1"] != (cold_iters if r["cold"] else warm_iters) for r in rows):
        _fail(f"the planner shell's K1 launches by cycle: {[r['k1'] for r in rows]}")
    if reached is None and not (closest is not None and closest[0] < 0.5 * start):
        _fail(f"the planner shell's robot came no closer than {closest} m to its goal "
              f"({start:.3f} m away at the start)")
    return line


# --------------------------------------------------------------------------- #
# the parallel layer and the aux surface (phases 46-47)
# --------------------------------------------------------------------------- #
CLUSTER_RANKS = 2        # processes of the cluster on the one card (gloo)
CLUSTER_TIMEOUT_S = 300  # each rank's wait, a hang fails the phase
TASK_CYCLES = 10         # the closed-loop task's cycles, at most
# JAX tests/test_controllers_plants_tasks.py:118's Controller config (the
# unicycle at N=10, the quadratic form, no obstacle slot, 5×6 cold)
TASK_CONFIG = {
    "grid": {"grid_size_ref": 10, "dt_ref": 0.3},
    "planning": {"objective_type": "quadratic_form", "terminal_cost_type": "quadratic",
                 "final_state_weights": [10.0, 10.0, 10.0]},
    "collision": {"obstacle_capacity": 0},
    "solver": {"iterations": 5, "inner_iterations": 6},
}
TASK_GOAL = (1.0, 0.5, 0.4636476090008061)  # atan2(0.5, 1.0), JAX's test's
FEEDBACK_CYCLES = 100    # run_feedback_loop's cycles over BATCH plants
FEEDBACK_CPU_LANES = 64  # of them run again on the CPU
PROFILE_ITERS = 3


# dryrun_multichip's fused launches on a mesh of n shards: n (its 1×1
# flagship), n + 1 (the cross-shard check's sharded and unsharded solves),
# 3n (the per-shard rescue's solve and rescue a shard, and the per-block
# reference's rescues); its early-exit checks run un-fused, K1 once per SQP
# iteration
def dryrun_fused_launches(n):
    return 5 * n + 1


# the cluster's mean cost against the single process's: float32 per-lane
# costs summed in float64 in another order
SUMMARY_RTOL = 1e-6


def _trees_equal(a, b):
    """Every leaf of two results equal bit for bit."""
    import torch

    from mpc_local_planner_tpu_torch.core.tree import tree_map

    flags = []
    tree_map(lambda x, y: flags.append(torch.equal(x, y)) or x, a, b)
    return all(flags)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_argv(rank, world, port):
    return [sys.executable, "-m", "mpc_local_planner_tpu_torch.parallel.dryrun", "--rank",
            str(rank), "--world-size", str(world), "--coordinator", f"127.0.0.1:{port}",
            "--device", "cuda", "--batch", str(BATCH)]


def _rank_results(procs):
    """Wait for each rank process; its RESULT line's JSON and its backend."""
    import re

    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=CLUSTER_TIMEOUT_S)
            m = re.search(r"^RESULT rank=\d+ (\{.*\})$", text, re.M)
            if p.returncode != 0 or m is None:
                _fail(f"a rank of the cluster failed (rc {p.returncode}):\n{text[-4000:]}")
            out.append(json.loads(m.group(1)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _summary_agrees(got, want):
    return got["n_converged"] == want["n_converged"] and all(
        math.isclose(got[k], want[k], rel_tol=SUMMARY_RTOL)
        for k in ("mean_cost", "max_eq_norm", "max_ineq_viol"))


def parallel_phase(device, card, spec, warm_f, rescue_f, final):
    """Phase 46: the parallel layer (``parallel/``) on the card, from the
    fused flagship's final state (``final``: 4096 lanes, warm-started from
    their iterate): ``make_sharded_solver`` (warm 3×4 and the 4×4 rescue) on a
    1×1 mesh, bit-equal to ``make_solver`` then ``make_rescue`` unsharded, and
    on a 2×2 mesh of the one card (four shards of 1024 lanes, 256 rescue
    slots each), bit-equal to the per-block reference; ``dryrun_multichip``
    on that mesh (the solves its checks compare must leave converged and
    unconverged lanes; its fused launches ``dryrun_fused_launches``, its K1
    launches its early-exit SQP iterations, counted by ``SqpCount``); a
    cluster of two ``parallel.dryrun`` processes on the card (gloo, 2048
    lanes each of the flagship, seed 0, ``CHECK_SETTINGS``) whose identical
    RESULT lines equal ``ensemble_summary`` of the single-process solve of
    all 4096 lanes, and a one-rank NCCL group running the same all_reduce
    (both started first, beside the in-process checks); the mixed ensemble
    of the flagship and config #2 at 2048 lanes each, each group bit-equal
    to its own ``make_solver`` and launched once, counted under its library
    group. Returns the launches by path, config #2's apart."""
    import torch

    from mpc_local_planner_tpu_torch.benchmarks import random_ensemble
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda
    from mpc_local_planner_tpu_torch.parallel.dryrun import CHECK_SETTINGS, dryrun_multichip
    from mpc_local_planner_tpu_torch.parallel.ensembles import MixedEnsembleSolver
    from mpc_local_planner_tpu_torch.parallel.sharding import (
        ensemble_summary,
        make_mesh,
        make_sharded_solver,
    )
    from mpc_local_planner_tpu_torch.solvers.al_sqp import default_init, make_solver
    from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

    t_phase = time.perf_counter()
    port, nccl_port = _free_port(), _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # the one-rank group's bootstrap: localhost
    ranks = [subprocess.Popen(_rank_argv(r, CLUSTER_RANKS, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(CLUSTER_RANKS)]
    nccl = subprocess.Popen(_rank_argv(0, 1, nccl_port), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    line, k1, k2a = {"device": card}, {}, {}
    scen, r = final
    init, duals = r.primal, r.duals
    solve = make_solver(spec, warm_f, device)

    def run(tag, fn):
        reset_counts()
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        line[f"{tag}_s"] = time.perf_counter() - t0
        k1[tag], k2a[tag] = launch_counts()
        return out

    # the flagship through the sharded solver on a 1×1 mesh of the card
    mesh1 = make_mesh(1, 1, devices=[device])
    out1 = run("sharded_1x1", lambda: make_sharded_solver(
        spec, warm_f, mesh1, rescue_slots=RESCUE_SLOTS, rescue_settings=rescue_f)(
        scen, init, duals))
    ref1 = make_rescue(spec, warm_f, RESCUE_SLOTS, rescue_settings=rescue_f, device=device)(
        scen, solve(scen, init, duals))
    line["sharded_1x1_bit_equal"] = _trees_equal(out1.blocks[0], ref1)
    line["converged_frac"] = float(ref1.converged.float().mean())

    # four shards of 1024 lanes on the one card, 256 rescue slots each
    mesh4 = make_mesh(2, 2, devices=[device] * 4)
    per, slots = BATCH // 4, RESCUE_SLOTS // 4
    out4 = run("sharded_2x2", lambda: make_sharded_solver(
        spec, warm_f, mesh4, rescue_slots=slots, rescue_settings=rescue_f)(scen, init, duals))
    rescue4 = make_rescue(spec, warm_f, slots, rescue_settings=rescue_f, device=device)
    blocks_equal = []
    for i in range(4):
        blk = [_lanes(t, slice(i * per, (i + 1) * per)) for t in (scen, init, duals)]
        blocks_equal.append(_trees_equal(out4.blocks[i], rescue4(blk[0], solve(*blk))))
    line["sharded_2x2_blocks_bit_equal"] = blocks_equal
    line["sharded_2x2_converged_frac"] = float(
        torch.cat([b.converged for b in out4.blocks]).float().mean())

    # the dry run's three checks on that mesh (it raises on a mismatch)
    with SqpCount() as sqp:
        line["dryrun"] = run("dryrun", lambda: dryrun_multichip(mesh4, device))
    line["dryrun_sqp_iterations"] = sqp.n

    # the mixed ensemble: the flagship and config #2, 2048 lanes each
    spec2, _, warm2, _, _ = path_settings("config2")
    groups = [(spec, warm_f), (spec2, dataclasses.replace(warm2, fused="auto"))]
    mixed = MixedEnsembleSolver(groups, device=device)
    scens = [random_ensemble(s, BATCH // 2, torch.Generator().manual_seed(g + 1), device=device)
             for g, (s, _) in enumerate(groups)]
    states = [mixed.init_state(g, scens[g]) for g in range(2)]
    results = run("mixed_ensemble", lambda: mixed.solve_all(
        scens, [s[0] for s in states], [s[1] for s in states]))
    # each group's launches in that run, under its library group
    mixed_groups = [fused_al_sqp_cuda.group(s, torch.float32) for s, _ in groups]
    by_group = fused_al_sqp_cuda.fused_solve_cuda.launches_by_group
    mixed_total, mixed_by_group = k2a["mixed_ensemble"], [by_group[g] for g in mixed_groups]
    line["mixed_fused_launches_by_group"] = mixed_by_group
    k2a["mixed_ensemble"] = mixed_by_group[0]
    line["config2_fused_launches_by_path"] = {"mixed_ensemble": mixed_by_group[1]}
    line["mixed_groups_bit_equal"] = [
        _trees_equal(results[g], make_solver(s, st, device)(scens[g], *states[g]))
        for g, (s, st) in enumerate(groups)]
    line["mixed_summary"] = mixed.summary(results)

    # the cluster against the single process's solve of all 4096 lanes
    scen_c = random_ensemble(spec, BATCH, torch.Generator().manual_seed(0), device=device)
    single = ensemble_summary(make_solver(spec, CHECK_SETTINGS, device)(
        scen_c, *default_init(spec, CHECK_SETTINGS, scen_c)))._asdict()
    t0 = time.perf_counter()
    got = _rank_results(ranks)
    nccl_got = _rank_results([nccl])[0]
    line["cluster_wait_s"] = time.perf_counter() - t0
    line.update({"single_process_summary": single, "cluster_results": got,
                 "nccl_result": nccl_got})
    k1["cluster_ranks"] = sum(g["k1_launches"] for g in got)
    k2a["cluster_ranks"] = sum(g["fused_launches"] for g in got)
    k1["nccl_rank"], k2a["nccl_rank"] = nccl_got["k1_launches"], nccl_got["fused_launches"]
    line["k1_launches_by_path"], line["fused_launches_by_path"] = k1, k2a
    line["parallel_phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"parallel": line}))

    if not line["sharded_1x1_bit_equal"]:
        _fail("the 1x1 sharded flagship differs from make_solver + make_rescue")
    if not all(blocks_equal):
        _fail(f"the 2x2 sharded flagship differs from its per-block reference: {blocks_equal}")
    dry = line["dryrun"]
    if not all(0 < dry[k] < dry["checks_lanes"] for k in (
            "cross_shard_converged", "early_exit_converged")):
        _fail(f"the dry run's checks saw no mix of converged and unconverged lanes: {dry}")
    if not 0 < single["n_converged"] < BATCH:
        _fail(f"the cluster's ensemble converged {single['n_converged']} of {BATCH} lanes")
    if not all(line["mixed_groups_bit_equal"]):
        _fail(f"a mixed-ensemble group differs from its own solver: "
              f"{line['mixed_groups_bit_equal']}")
    if (k1["sharded_1x1"], k2a["sharded_1x1"]) != (0, 2) or (
            k1["sharded_2x2"], k2a["sharded_2x2"]) != (0, 8) or (
            k1["mixed_ensemble"], mixed_total) != (0, 2):
        _fail(f"the sharded and mixed solves launched (K1, fused) {k1}, {k2a}")
    if mixed_groups[0] == mixed_groups[1] or mixed_by_group != [1, 1]:
        _fail(f"the mixed ensemble's groups {mixed_groups} launched {mixed_by_group} times, "
              "expected once each")
    if (k1["dryrun"], k2a["dryrun"]) != (sqp.n, dryrun_fused_launches(4)) or sqp.n == 0:
        _fail(f"the dry run launched (K1, fused) ({k1['dryrun']}, {k2a['dryrun']}), expected "
              f"({sqp.n}, its early-exit SQP iterations; {dryrun_fused_launches(4)})")
    comparable = [{k: g[k] for k in single} for g in got]
    if any(c != comparable[0] for c in comparable) or any(
            g["backend"] != "gloo" or g["world_size"] != CLUSTER_RANKS for g in got):
        _fail(f"the cluster's ranks disagree: {got}")
    if not _summary_agrees(comparable[0], single):
        _fail(f"the cluster's summary {comparable[0]} differs from one process's {single}")
    if nccl_got["backend"] != "nccl" or not _summary_agrees(nccl_got, single):
        _fail(f"the one-rank NCCL group's result {nccl_got} (single process {single})")
    if any(g["fused_launches"] != 1 or g["k1_launches"] != 0 for g in got + [nccl_got]):
        _fail(f"a rank's solve launched (K1, fused) other than (0, 1): {got}, {nccl_got}")
    return line


def _lanes(tree, lanes):
    from mpc_local_planner_tpu_torch.core.tree import tree_map

    return tree_map(lambda a: a[lanes], tree)


class _CountedController:
    """A Controller whose steps record (cold, K1 launches, fused launches)."""

    def __init__(self, ctrl):
        self._ctrl, self.rows = ctrl, []

    def __getattr__(self, name):
        return getattr(self._ctrl, name)

    def step(self, scenario, **kw):
        cold = self._ctrl._primal is None
        before = launch_counts()
        res = self._ctrl.step(scenario, **kw)
        now = launch_counts()
        self.rows.append((cold, now[0] - before[0], now[1] - before[1]))
        return res


class PlanarDoubleIntegrator:
    """ẋ = (v, a) on two axes: state (px, py, vx, vy), control (ax, ay) (the
    aux phase's linear plant for ``run_feedback_loop``)."""

    control_dim = 2
    state_dim = 4

    def f(self, x, u):
        import torch

        return torch.cat([x[..., 2:], u], dim=-1)

    def linearize(self, x, u):
        import torch

        return (torch.func.jacfwd(self.f, argnums=0)(x, u),
                torch.func.jacfwd(self.f, argnums=1)(x, u))


def aux_phase(device, card, spec, warm_f, final, fleet_ctrl, fleet_scen):
    """Phase 47: the aux surface on the card. ``ClosedLoopControlTask`` with
    JAX test_controllers_plants_tasks.py:118's Controller config for at most
    TASK_CYCLES cycles (the distance to the goal shrinks, the log's shapes
    agree, K1 once per SQP iteration of each cycle's budget, 8 a warm cycle,
    the fused kernel never); ``run_feedback_loop`` of an LQR law
    (``LqrController.make``) over 4096 planar double integrators, the first
    64 again on the CPU; ``save_controller_state`` and
    ``load_controller_state`` of phase 41's fleet Controller into a fresh
    one, whose next warm step is bit-equal to the original's;
    ``profile_solver_phases`` at B=4096 on the flagship's final state;
    ``torch_trace`` around one fused solve in this process (the trace file's
    kernel events must name the fused kernel, and hold as many K1 and fused
    kernel events as the wrappers counted launches);
    ``convergence_report`` and ``active_constraints_report`` on the
    flagship's last result. Returns the launches by path."""
    import tempfile

    import numpy as np
    import torch

    from mpc_local_planner_tpu_torch.checkpoint import (
        load_controller_state,
        save_controller_state,
    )
    from mpc_local_planner_tpu_torch.controllers import LqrController
    from mpc_local_planner_tpu_torch.planner import Controller, load_config
    from mpc_local_planner_tpu_torch.plants import SimulatedPlant
    from mpc_local_planner_tpu_torch.profiling import (
        active_constraints_report,
        convergence_report,
        profile_solver_phases,
    )
    from mpc_local_planner_tpu_torch.solvers.al_sqp import make_solver
    from mpc_local_planner_tpu_torch.tasks.closed_loop import (
        ClosedLoopControlTask,
        run_feedback_loop,
    )

    t_phase = time.perf_counter()
    line, k1, k2a = {"device": card}, {}, {}
    scen, r = final

    # the closed-loop task on the port's unbatched Controller
    ctrl = Controller(load_config(TASK_CONFIG), device=device)
    counted = _CountedController(ctrl)
    _load_k1(device)
    plant = SimulatedPlant(model=ctrl.spec.model, method="rk4")
    reset_counts()
    t0 = time.perf_counter()
    log = ClosedLoopControlTask(counted, plant, sim_dt=ctrl.config.grid.dt_ref).perform(
        np.zeros(3), TASK_GOAL, n_cycles=TASK_CYCLES)
    line["task_s"] = time.perf_counter() - t0
    k1["closed_loop"], k2a["closed_loop"] = launch_counts()
    xs = log.states.values
    goal = torch.tensor(TASK_GOAL)
    dist = [float(torch.linalg.norm(x[:2] - goal[:2])) for x in (xs[0], xs[-1])]
    cold_it = ctrl.settings.n_al * ctrl.settings.n_sqp
    warm_it = ctrl.warm_settings.n_al * ctrl.warm_settings.n_sqp
    line["task"] = {"cycles": len(log.solve_ms), "goal_reached": log.goal_reached,
                    "distance_start_end_m": dist, "states_shape": list(xs.shape),
                    "controls_shape": list(log.controls.values.shape),
                    "solve_ms": [round(v, 2) for v in log.solve_ms.tolist()],
                    "cold_warm_iterations": [cold_it, warm_it],
                    "k1_fused_by_cycle": [[k, f] for _, k, f in counted.rows]}

    # an LQR law over 4096 planar double integrators, and 64 of them on the CPU
    model = PlanarDoubleIntegrator()
    q, rr = (2.0, 2.0, 1.0, 1.0), (1.0, 1.0)
    x0 = torch.randn((BATCH, 4), generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    lqr = LqrController.make(model, torch.zeros(4), torch.zeros(2), q_diag=q, r_diag=rr,
                             dt=0.1, se2_state=False, device=device)
    _sync(device)
    t0 = time.perf_counter()
    fx, fu = run_feedback_loop(lqr.control, SimulatedPlant(model=model), x0.to(device), 0.1,
                               FEEDBACK_CYCLES)
    _sync(device)
    line["feedback_loop_ms"] = (time.perf_counter() - t0) * 1e3
    lqr_cpu = LqrController.make(model, torch.zeros(4), torch.zeros(2), q_diag=q, r_diag=rr,
                                 dt=0.1, se2_state=False, device="cpu")
    cx, _ = run_feedback_loop(lqr_cpu.control, SimulatedPlant(model=model),
                              x0[:FEEDBACK_CPU_LANES], 0.1, FEEDBACK_CYCLES)
    line["feedback"] = {
        "plants": BATCH, "cycles": FEEDBACK_CYCLES, "shape": list(fx.shape),
        "max_abs_x0": float(x0.abs().max()), "max_abs_x_end": float(fx[-1].abs().max()),
        "gain_max_abs_err_vs_cpu": float((lqr.K.cpu() - lqr_cpu.K).abs().max()),
        "max_abs_err_vs_cpu": float((fx[:, :FEEDBACK_CPU_LANES].cpu() - cx).abs().max()),
        "finite": bool(torch.isfinite(fx).all() and torch.isfinite(fu).all())}

    # the fleet Controller's snapshot, resumed by a fresh Controller
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fleet.npz")
        t0 = time.perf_counter()
        save_controller_state(path, fleet_ctrl)
        twin = Controller(fleet_ctrl.config, batch=fleet_ctrl.batch, device=device)
        loaded = load_controller_state(path, twin)
        line["checkpoint_save_load_s"] = time.perf_counter() - t0
        line["checkpoint_bytes"] = os.path.getsize(path)
    reset_counts()
    a, b = fleet_ctrl.step(fleet_scen), twin.step(fleet_scen)
    _sync(device)
    k1["checkpoint_resume"], k2a["checkpoint_resume"] = launch_counts()
    line["checkpoint_resume_bit_equal"] = bool(
        loaded and torch.equal(a.u0, b.u0) and _trees_equal(a.solve, b.solve))

    # one SQP iteration's phases at B=4096
    reset_counts()
    line["profile_solver_phases_ms"] = profile_solver_phases(
        spec, dataclasses.replace(warm_f, fused="off"), scen, r.primal, r.duals,
        iters=PROFILE_ITERS)
    k1["profiling"], k2a["profiling"] = launch_counts()

    # torch_trace around one fused solve, in this process after phases 3-46
    trace = trace_fused_solve(spec, warm_f, scen, r, device)
    line["torch_trace"] = trace
    k1["torch_trace"], k2a["torch_trace"] = trace["k1_launches"], trace["fused_launches"]

    line["convergence_report"] = convergence_report(r)
    line["active_constraints_report"] = active_constraints_report(spec, r, scen)
    line["k1_launches_by_path"], line["fused_launches_by_path"] = k1, k2a
    line["aux_phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"aux": line}))

    task = line["task"]
    want = [[cold_it if cold else warm_it, 0] for cold, _, _ in counted.rows]
    if task["k1_fused_by_cycle"] != want or counted.rows[0][0] is not True or any(
            c for c, _, _ in counted.rows[1:]):
        _fail(f"the closed-loop task launched (K1, fused) {task['k1_fused_by_cycle']} by "
              f"cycle, expected {want}")
    if warm_it != 8 or not dist[1] < dist[0]:
        _fail(f"the closed-loop task: warm iterations {warm_it}, distance {dist}")
    if task["states_shape"] != [task["cycles"] + 1, 3] or task["controls_shape"] != [
            task["cycles"], 2]:
        _fail(f"the closed-loop log's shapes {task['states_shape']}, {task['controls_shape']}")
    fb = line["feedback"]
    if not (fb["finite"] and fb["max_abs_x_end"] < 0.05 * fb["max_abs_x0"]
            and fb["max_abs_err_vs_cpu"] <= 1e-9 * max(1.0, fb["max_abs_x0"])):
        _fail(f"run_feedback_loop: {fb}")
    if not line["checkpoint_resume_bit_equal"] or (
            k1["checkpoint_resume"], k2a["checkpoint_resume"]) != (0, 4):
        _fail(f"the resumed fleet Controller's warm step differs, or launched (K1, fused) "
              f"({k1['checkpoint_resume']}, {k2a['checkpoint_resume']}), expected (0, 4)")
    if (k1["profiling"], k2a["profiling"]) != (1 + PROFILE_ITERS, 0) or not all(
            v > 0 for v in line["profile_solver_phases_ms"].values()):
        _fail(f"profile_solver_phases: {line['profile_solver_phases_ms']}, launches "
              f"({k1['profiling']}, {k2a['profiling']})")
    if not trace["names_fused_kernel"] or (k1["torch_trace"], k2a["torch_trace"]) != (0, 1):
        _fail(f"the torch_trace file does not name the fused kernel, or its solve launched "
              f"(K1, fused) other than (0, 1): {trace}")
    if trace["k1_fused_kernel_events"] != [k1["torch_trace"], k2a["torch_trace"]]:
        _fail(f"the torch_trace file's (K1, fused) kernel events differ from the launches "
              f"counted: {trace}")
    if line["convergence_report"]["n_scenarios"] != BATCH:
        _fail(f"convergence_report: {line['convergence_report']}")
    return line


def solver_worker(name, path):
    """``chip_smoke.py --solver-phase NAME FILE``: phase 36 (golden), 37
    (f64_tier) or 39 (lm) in a process of its own; FILE holds path B's
    final state, whose oracle phases 36 and 37 run first (phase 36 prints
    its line)."""
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.set_num_threads(1)
    if name == "lm":
        lm_phase()
    else:
        job = torch.load(path, map_location="cuda:0", weights_only=False)
        feas, seed = oracle_phase(job, quiet=name != "golden")
        {"golden": golden_phase, "f64_tier": f64_tier_phase}[name](
            job["spec"], (*job["final"], feas, seed))
    print_peak_memory(f"solver phase {name}")


def cold_worker(tag, path):
    """``chip_smoke.py --cold TAG FILE``: a main path's cold start
    (``cold_phase``) in a process of its own."""
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.set_num_threads(1)
    cold_phase(tag, path)
    print_peak_memory(f"cold {tag}")


def oracle_worker(path):
    """``chip_smoke.py --oracle FILE``: a main path's cold oracle
    (``oracle_phase``) in a process of its own."""
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.set_num_threads(1)
    job = torch.load(path, map_location="cuda:0", weights_only=False)
    oracle_phase(job)
    print_peak_memory(f"oracle {job['tag']}")


def family_worker(name, save=None):
    """``chip_smoke.py --family-case NAME [FILE]``: one case of
    ``last_phase``, its warm inputs saved to FILE."""
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.set_num_threads(1)
    family_case(name, save)
    print_peak_memory(name)


def f64_worker(path):
    """``chip_smoke.py --f64-check FILE``: one of ``F64Checks``'s checks."""
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.set_num_threads(1)
    job = torch.load(path, map_location="cuda:0", weights_only=False)
    k2a_f64_phase(job["spec"], job["st"], _double(job["args"]), job["tag"], job["floor"])
    print_peak_memory(job["tag"])


def print_peak_memory(tag):
    """One job's peak resident memory on the host, for ``MAX_PROCS``."""
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # KiB on Linux
    print(f"{tag}: peak resident memory {peak:.2f} GiB")


def trace_fused_solve(spec, warm, scen, r, device):
    """``torch_trace`` around one fused warm solve of the flagship state
    (``scen``, ``r``): the trace file's kernel events, its events by
    category, its K1 and fused kernel events, and the launches
    (``reset_counts`` first)."""
    import collections
    import glob
    import tempfile

    from mpc_local_planner_tpu_torch.profiling import torch_trace
    from mpc_local_planner_tpu_torch.solvers.al_sqp import make_solver

    solve = make_solver(spec, warm, device)
    _load_libraries(spec, device)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        with torch_trace(tmp):
            solve(scen, r.primal, r.duals)
            _sync(device)
        k1, fused = launch_counts()
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        events, alignment = [], []
        for f in files:
            with open(f) as fh:
                trace = json.load(fh)
            events += trace.get("traceEvents", [])
            alignment.append(trace.get("torch_trace_alignment"))
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"files": [os.path.basename(f) for f in files], "kernel_events": len(kernels),
            "alignment": alignment,
            "events_by_category": dict(collections.Counter(str(e.get("cat")) for e in events)),
            "kernels": [k[:60] for k in kernels[:8]],
            "names_fused_kernel": any("k2a_kernel" in k for k in kernels),
            "k1_fused_kernel_events": [sum("riccati_sweep_kernel" in k for k in kernels),
                                       sum("k2a_kernel" in k for k in kernels)],
            "k1_launches": k1, "fused_launches": fused,
            "process_s": time.perf_counter() - T_START}


LATE_PHASES = (41, 42, 43, 44, 45, 46, 47)


def late_phases(selected):
    """``chip_smoke.py --phases 41,46,47``: build K1 and the flagship's and
    config #2's groups, then run the selected phases among 41-47 alone, in
    order (a few minutes each; the whole smoke runs them all after path F).
    Phase 47 resumes phase 41's fleet Controller, so selecting it runs 41
    too; phases 46-47 start from one fused warm solve of the flagship's
    ensemble from the straight-line seed in place of phase 8's final state;
    phase 44's oracle and audit run after the phases, a process each."""
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda, riccati_cuda
    from mpc_local_planner_tpu_torch.solvers.al_sqp import default_init, make_solver

    if not selected or not set(selected) <= set(LATE_PHASES):
        _fail(f"--phases takes a comma-separated list of {LATE_PHASES}, got {sorted(selected)}")
    selected = set(selected) | ({41} if 47 in selected else set())
    card = card_line()
    print(f"device: {card}")
    laps, t_lap = {}, [time.perf_counter()]

    def lap(tag):
        now = time.perf_counter()
        laps[tag] = now - t_lap[0]
        t_lap[0] = now

    riccati_cuda.build()
    spec, _, warm, rescue_set, _ = path_settings("flagship")
    fused_al_sqp_cuda.build([fused_al_sqp_cuda.group(s, torch.float32)
                             for s in (spec, config2())])
    lap("build")
    device, checks = torch.device("cuda", 0), F64Checks()
    if 41 in selected:
        _, fleet_ctrl, fleet_scen = controller_fleet_phase(device, card)
        lap("41_fleet")
    if 42 in selected:
        controller_robot_phase(device, card)
        lap("42_robot")
    if 43 in selected:
        controller_surface_phase(device, card)
        lap("43_surface")
    if 44 in selected:
        serving_phase(device, card, checks)
        lap("44_serving")
    if 45 in selected:
        shell_phase(device, card)
        lap("45_shell")
    warm_f = dataclasses.replace(warm, fused="auto")
    if selected & {46, 47}:
        scen = ensemble(spec, BATCH, device)
        final = (scen, make_solver(spec, warm_f, device)(
            scen, *default_init(spec, warm_f, scen)))
    if 46 in selected:
        parallel_phase(device, card, spec, warm_f,
                       dataclasses.replace(rescue_set, fused="auto"), final)
        lap("46_parallel")
    if 47 in selected:
        aux_phase(device, card, spec, warm_f, final, fleet_ctrl, fleet_scen)
        lap("47_aux")
    for _, argv in checks.oracles:
        subprocess.run(argv, check=True)
    if checks.oracles:
        lap("44_oracle")
    print(json.dumps({"phases_s": laps}))
    print(card)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phases"]:
        late_phases({int(p) for p in sys.argv[2].split(",")})
    elif sys.argv[1:2] == ["--family-case"]:
        family_worker(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--f64-check"]:
        f64_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--solver-phase"]:
        solver_worker(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--cold"]:
        cold_worker(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--oracle"]:
        oracle_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--serving-oracle"]:
        serving_oracle_worker(sys.argv[2])
    else:
        main()
