#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mpc_local_planner_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):
  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA versions
  2. build   — nvcc builds kernel K1 (csrc/riccati_sweep.cu) into _build/
  3. kernel  — K1 against its plain PyTorch version on the Riccati inputs of
               one real flagship SQP iteration (B=4096 and 1024, N=30), in
               float64 and float32; kernel, plain and bound times
  4. main    — the flagship warm fleet cycle, as bench.py::main drives it:
               config3 (N=30, 8 circle slots), 4096 lanes, cold 16×15 solve,
               2 settle + 8 timed warm cycles (3×4, 3 candidates) with the
               1024-slot 4×4 rescue (8 candidates), then the cold oracle; K1
               must carry every SQP iteration (760 launches)
  5. gate    — the warm solve with K1 against the same solve with the plain
               KKT solve, on 256 lanes of the live warm state
  6. trace   — one warm cycle under torch.profiler: device kernel time,
               K1's share, the device's busy share
  7. summary — the kernels line, the card line, then the result line

Needs a CUDA card; without one (or without the package beside it) it exits
non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

BATCH = 4096
RESCUE_SLOTS = 1024
GATE_LANES = 256
SETTLE_CYCLES = 2
TIMED_CYCLES = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# Errors are max |kernel − plain| over the step, relative to the step's
# largest entry. f64: the two versions do the same arithmetic in another
# order, so they agree to a few ulps (1e-15 measured on an H100).
K1_RTOL_F64 = 1e-9
# f32: the 30-stage backward recursion amplifies f32 rounding (6e-8); both
# versions sit about 1e-6 from the f64 answer on these inputs (H100).
K1_RTOL_F32 = 1e-4


def _fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def flagship(N=30, obstacle_cap=8):
    """The flagship problem and bench.py::main's solver settings."""
    from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time
    from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings

    spec = config3_carlike_min_time(N=N, obstacle_cap=obstacle_cap)
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


def ensemble(spec, batch, device, seed=0):
    import torch

    from mpc_local_planner_tpu_torch.benchmarks import random_ensemble

    gen = torch.Generator().manual_seed(seed)
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


def _max_rel_err(a, b):
    """max |a − b| over the step, relative to the step's largest entry."""
    import torch

    errs, scale = [], []
    for x, y in zip(a, b):
        errs.append(torch.max(torch.abs(x.double() - y.double())).item())
        scale.append(torch.max(torch.abs(y.double())).item())
    return max(errs), max(errs) / max(max(scale), 1e-30)


def kernel_phase(spec, warm, device):
    """K1 against the plain lqr_solve at the main path's two batch sizes, on
    the inputs of a warm-settings SQP iteration (reg = 1). The cold solve's
    first iteration (reg = 1e-6 at the seed) overflows float32 in both
    versions alike, which the solver's NaN quarantine absorbs."""
    import torch

    from mpc_local_planner_tpu_torch.ops import riccati_cuda
    from mpc_local_planner_tpu_torch.solvers.riccati import lqr_solve

    report = {}
    for batch in (BATCH, RESCUE_SLOTS):
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
                f"K1 {name} B={batch}: max_abs_err={abs_err:.3e} "
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
        row["plain_ms"] = _cuda_ms(lambda: lqr_solve(*args32, **kw), 5)
        print(
            f"K1 f32 B={batch}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({nbytes} B at {HBM_BYTES_PER_S:.3g} B/s)"
        )
        report[batch] = row
    return report


def main_path(spec, cold, warm, rescue_set, device, batch=BATCH, slots=RESCUE_SLOTS):
    """bench.py::main on the port. Returns (extra, settled state, seconds,
    the cycle)."""
    import torch

    from mpc_local_planner_tpu_torch.ocp.grid import initial_primal
    from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle
    from mpc_local_planner_tpu_torch.solvers.al_sqp import init_duals, make_solver
    from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    scen = ensemble(spec, batch, device)
    init = initial_primal(spec, scen)
    duals0 = init_duals(spec, cold, dtype=torch.float32, device=device, batch=(batch,))
    cold_solve = make_solver(spec, cold, device)
    rescue = make_rescue(spec, warm, slots, rescue_settings=rescue_set, device=device)
    cycle = make_fleet_cycle(spec, warm, duals0, rescue=rescue, device=device)

    secs = {}
    t0 = time.perf_counter()
    r = cold_solve(scen, init, duals0)
    sync()
    secs["cold_solve_s"] = time.perf_counter() - t0
    for _ in range(SETTLE_CYCLES):
        scen, r = cycle(scen, r)
    sync()
    settled = (scen, r)
    t0 = time.perf_counter()
    for _ in range(TIMED_CYCLES):
        scen, r = cycle(scen, r)
    n_conv = int(torch.sum(r.converged))  # host fetch ends the chain
    dt = (time.perf_counter() - t0) / TIMED_CYCLES
    t0 = time.perf_counter()
    oracle = cold_solve(scen, initial_primal(spec, scen), duals0)
    feas = oracle.converged
    sync()
    secs["oracle_s"] = time.perf_counter() - t0
    n_feas = int(torch.sum(feas))
    extra = {
        "batch": batch,
        "cycle_ms": dt * 1e3,
        "total_solves_per_s": batch / dt,
        "warm_iterations": warm.n_al * warm.n_sqp,
        "converged_frac": n_conv / batch,
        "feasible_frac_cold_oracle": n_feas / batch,
        "conv_on_feasible": int(torch.sum(r.converged & feas)) / max(n_feas, 1),
    }
    return extra, settled, secs, cycle


def gate_phase(spec, warm, settled, n=GATE_LANES):
    """bench.py's kernel-vs-reference gate: K1 against the plain KKT solve on
    the live warm state (the plain path is forced through settings.kkt)."""
    import torch

    from mpc_local_planner_tpu_torch.core.tree import tree_map
    from mpc_local_planner_tpu_torch.ocp.grid import warm_start_resample
    from mpc_local_planner_tpu_torch.solvers.al_sqp import make_solver, shift_duals

    scen, r = settled
    take = lambda t: tree_map(lambda a: a[:n], t)  # noqa: E731
    ok = r.converged
    x0n = torch.where(ok[:, None], r.primal.xs[:, 1, :], scen.x0)
    scen_g = dataclasses.replace(take(scen), x0=x0n[:n])
    init_g = take(warm_start_resample(r.primal, x0n, steps=1, spec=spec))
    dn_g = take(shift_duals(r.duals, warm, steps=1))
    dev = scen.x0.device
    out_k = make_solver(spec, warm, dev)(scen_g, init_g, dn_g)
    out_p = make_solver(spec, dataclasses.replace(warm, kkt="scan"), dev)(scen_g, init_g, dn_g)
    agree = float(torch.mean((out_k.converged == out_p.converged).float()))
    both = out_k.converged & out_p.converged
    diff = torch.where(both[:, None, None], torch.abs(out_k.primal.xs - out_p.primal.xs), 0.0)
    iters = warm.n_al * warm.n_sqp
    info = {
        "conv_agree_frac": agree,
        "converged_lanes_compared": int(torch.sum(both)),
        "max_dxs_on_converged": float(torch.max(diff)),
        "dxs_tol": 5e-3 if iters <= 6 else (5e-2 if iters <= 12 else 1e-1),
    }
    return info, (
        agree >= 0.995
        and info["converged_lanes_compared"] >= n // 4
        and info["max_dxs_on_converged"] <= info["dxs_tol"]
    )


def trace_phase(cycle, settled, cycle_ms):
    """One warm cycle (solve + rescue) from the settled state under
    torch.profiler: the device's kernel time per cycle, K1's part of it, and
    the device's busy share against the unprofiled cycle time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scen, r = settled
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cycle(scen, r)
        torch.cuda.synchronize()
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1 = [e for e in kernels if "riccati_sweep_kernel" in e.key]
    k1_ms = sum(e.self_device_time_total for e in k1) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "device_kernel_ms_per_cycle": device_ms,
        "kernel_launches_per_cycle": sum(e.count for e in kernels),
        "k1_ms_per_cycle": k1_ms,
        "k1_launches_per_cycle": sum(e.count for e in k1),
        "device_busy_frac": device_ms / cycle_ms,
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
    }


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from mpc_local_planner_tpu_torch.ops import riccati_cuda  # fails outside the repo

    # ---- 1. device ------------------------------------------------------ #
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)

    # ---- 2. build ------------------------------------------------------- #
    built = riccati_cuda.build()
    print(f"build: {built['path']} in {built['seconds']:.2f} s")
    for line in built["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 3. K1 against its plain version --------------------------------- #
    spec, cold, warm, rescue_set = flagship()
    k1 = kernel_phase(spec, warm, device)

    # ---- 4. main path --------------------------------------------------- #
    riccati_cuda.lqr_solve_cuda.launches = 0
    t0 = time.perf_counter()
    extra, settled, secs, cycle = main_path(spec, cold, warm, rescue_set, device)
    launches = riccati_cuda.lqr_solve_cuda.launches
    main_s = time.perf_counter() - t0
    expected = (
        2 * cold.n_al * cold.n_sqp
        + (SETTLE_CYCLES + TIMED_CYCLES)
        * (warm.n_al * warm.n_sqp + rescue_set.n_al * rescue_set.n_sqp)
    )
    print(json.dumps({**extra, "k1_launches": launches, "device": card, **secs,
                      "main_path_s": main_s}))
    if launches != expected:
        _fail(f"K1 launched {launches} times on the main path, expected {expected}")
    if not extra["converged_frac"] >= 0.5:
        _fail(f"converged_frac {extra['converged_frac']} below the 0.5 floor")

    # ---- 5. kernel-vs-plain gate on the live warm state -------------------- #
    gate, passed = gate_phase(spec, warm, settled)
    print(json.dumps({"k1_vs_plain_gate": gate, "passed": passed}))
    if not passed:
        _fail(f"K1-vs-plain gate failed: {gate}")

    # ---- 6. where one warm cycle's device time goes ---------------------- #
    print(json.dumps({"trace": trace_phase(cycle, settled, extra["cycle_ms"])}))

    # ---- 7. summary ----------------------------------------------------- #
    row = k1[BATCH]
    print(json.dumps({"kernels": [{
        "name": "K1 riccati_sweep",
        "route": "cuda",
        "source": "mpc_local_planner_tpu_torch/csrc/riccati_sweep.cu",
        "replaces": "mpc_local_planner_tpu/ops/riccati_pallas.py:37",
        "launches": launches,
        "max_abs_err": row["max_abs_err_f32"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
