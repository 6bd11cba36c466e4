#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``mpc_local_planner_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and swallowed):
  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA versions
  2. build   — nvcc builds kernels K1 (csrc/riccati_sweep.cu) and K2a
               (csrc/fused_al_sqp.cu) into _build/, in parallel
  3. kernel  — K1 against its plain PyTorch version on the Riccati inputs of
               one real flagship SQP iteration (B=4096 and 1024, N=30), in
               float64 and float32; kernel, plain and bound times
  4. main    — the flagship warm fleet cycle on the un-fused path
               (fused="off"), as bench.py::main drives it: config3 (N=30, 8
               circle slots), 4096 lanes, cold 16×15 solve, 2 settle + 8
               timed warm cycles (3×4, 3 candidates) with the 1024-slot 4×4
               rescue (8 candidates), then the cold oracle; K1 must carry
               every SQP iteration (760 launches)
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
               launches), K1 only for the oracle (240)
  9. gate    — the fused warm solve (K2a) against the un-fused one (AD
               derivatives + K1) on 256 lanes of the live warm state
 10. trace   — one fused warm cycle under torch.profiler
 11. summary — the kernels line, the card line, then the result line

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
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
# K2a against its plain version in float64 (solvers/agreement.py): conv
# flags identical on every lane; max relative |Δ| over xs, us, dt and the
# duals within 1e-8 on 99.5% of the lanes both converged; and on every lane
# at most 100 times the plain version's own change under a one-ulp change of
# its states (up or down). That last check runs at every prefix of the
# solve's schedule (1×1, 1×2, then whole AL phases), so a lane is held tight
# before its rounding can grow; a lane whose own change passes 1e-6 (a
# chaotic lane) is counted and left out of it, and at 1×1 no lane may be.


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


def main_path(spec, cold, warm, rescue_set, device, cold_start=None, batch=BATCH,
              slots=RESCUE_SLOTS):
    """bench.py::main on the port. ``cold_start`` = (scenarios, cold result)
    skips the cold solve. Returns (extra, settled state, seconds, the cycle,
    the cold start, K1's launch count after the timed cycles)."""
    import torch

    from mpc_local_planner_tpu_torch.ocp.grid import initial_primal
    from mpc_local_planner_tpu_torch.ops import riccati_cuda
    from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle
    from mpc_local_planner_tpu_torch.solvers.al_sqp import init_duals, make_solver
    from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    duals0 = init_duals(spec, cold, dtype=torch.float32, device=device, batch=(batch,))
    cold_solve = make_solver(spec, cold, device)
    rescue = make_rescue(spec, warm, slots, rescue_settings=rescue_set, device=device)
    cycle = make_fleet_cycle(spec, warm, duals0, rescue=rescue, device=device)

    secs = {}
    if cold_start is None:
        scen = ensemble(spec, batch, device)
        t0 = time.perf_counter()
        r = cold_solve(scen, initial_primal(spec, scen), duals0)
        sync()
        secs["cold_solve_s"] = time.perf_counter() - t0
        cold_start = (scen, r)
    scen, r = cold_start
    for _ in range(SETTLE_CYCLES):
        scen, r = cycle(scen, r)
    sync()
    settled = (scen, r)
    t0 = time.perf_counter()
    for _ in range(TIMED_CYCLES):
        scen, r = cycle(scen, r)
    n_conv = int(torch.sum(r.converged))  # host fetch ends the chain
    dt = (time.perf_counter() - t0) / TIMED_CYCLES
    k1_after_cycles = riccati_cuda.lqr_solve_cuda.launches
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
    return extra, settled, secs, cycle, cold_start, k1_after_cycles


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


def k2a_f64_phase(spec, st, args64, tag):
    """K2a against its plain version in float64 at every prefix of ``st``'s
    schedule (``agreement.f64_agreement``, every lane at 1×1); prints one
    line per prefix and the error of the lane that ends furthest apart at
    each prefix."""
    import torch

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.solvers import agreement

    scen, init, duals = args64
    perturbed = agreement.ulp_perturbed(init)
    rows = []
    for n_al, n_sqp in schedule_prefixes(st):
        sp = dataclasses.replace(st, n_al=n_al, n_sqp=n_sqp)
        last = (n_al, n_sqp) == (st.n_al, st.n_sqp)
        out_k = k2a.fused_solve_cuda(spec, sp, scen, init, duals)
        out_p = k2a.fused_solve_plain(spec, sp, scen, init, duals)
        outs_q = [k2a.fused_solve_plain(spec, sp, scen, q, duals) for q in perturbed]
        torch.cuda.synchronize()
        info, passed, err, sens = agreement.f64_agreement(
            out_k, out_p, outs_q, min_converged_frac=0.25 if last else 0.0,
            every_lane=(n_al, n_sqp) == (1, 1),
        )
        print(f"{tag} f64 at {n_al}x{n_sqp}: {json.dumps(info)} passed={passed}")
        if not passed:
            _fail(f"K2a disagrees with its plain version in float64 ({tag} at {n_al}x{n_sqp})")
        rows.append(((n_al, n_sqp), err, sens))
    worst = int(torch.argmax(rows[-1][1]))
    trail = ", ".join(f"{a}x{s} {float(e[worst]):.3e} ({float(q[worst]):.3e})"
                      for (a, s), e, q in rows)
    print(f"{tag} f64 lane {worst}, its error at each prefix (plain version's "
          f"one-ulp sensitivity): {trail}")


def k2a_phase(spec, warm, rescue_set, settled):
    """K2a against its plain version on the live warm state: the next warm
    solve's inputs at 4096 lanes (3×4, 3 candidates) and at 1024 lanes with
    the rescue's settings (4×4, 8 candidates), in float64 and float32."""
    from mpc_local_planner_tpu_torch.core.tree import tree_map
    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.solvers import agreement

    report = {}
    for batch, st in ((BATCH, warm), (RESCUE_SLOTS, rescue_set)):
        args32 = warm_inputs(spec, st, settled, batch)
        args64 = tuple(
            tree_map(lambda a: a.double() if a.is_floating_point() else a, t) for t in args32
        )
        tag = f"K2a B={batch} {st.n_al}x{st.n_sqp}"
        k2a_f64_phase(spec, st, args64, tag)
        out_k = k2a.fused_solve_cuda(spec, st, *args32)
        out_p = k2a.fused_solve_plain(spec, st, *args32)
        info, passed = agreement.gate(out_k, out_p, st.n_al * st.n_sqp)
        print(f"{tag} f32: {json.dumps(info)} passed={passed}")
        if not passed:
            _fail(f"K2a disagrees with its plain version in float32 ({tag})")
        ins, outs = k2a.kernel_io(spec, *args32)
        nbytes = sum(a.numel() * a.element_size() for a in ins + outs)
        flops = batch * k2a.k2a_flops(spec.N, spec.obstacle_cap, st.n_al, st.n_sqp, len(st.alphas))
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
        report[batch] = row
    return report


def trace_phase(cycle, settled, cycle_ms):
    """One warm cycle (solve + rescue) from the settled state under
    torch.profiler: the device's kernel time per cycle, K1's and K2a's parts
    of it, and the device's busy share against the unprofiled cycle time."""
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
    out = {
        "device_kernel_ms_per_cycle": device_ms,
        "kernel_launches_per_cycle": sum(e.count for e in kernels),
        "device_busy_frac": device_ms / cycle_ms,
    }
    for tag, key in (("k1", "riccati_sweep_kernel"), ("k2a", "k2a_kernel")):
        mine = [e for e in kernels if key in e.key]
        out[f"{tag}_ms_per_cycle"] = sum(e.self_device_time_total for e in mine) / 1e3
        out[f"{tag}_launches_per_cycle"] = sum(e.count for e in mine)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    out["top_kernels_ms"] = {e.key[:60]: e.self_device_time_total / 1e3 for e in top}
    return out


def build_phase():
    """Build K1 and K2a at once (one nvcc each); print times and ptxas'
    registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda, riccati_cuda

    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = list(pool.map(lambda m: m.build(), (riccati_cuda, fused_al_sqp_cuda)))
    for built in builds:
        print(f"build: {built['path']} in {built['seconds']:.2f} s")
        for line in built["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print(f"  ptxas: {line.strip()}")


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
    build_phase()

    # ---- 3. K1 against its plain version --------------------------------- #
    spec, cold, warm, rescue_set = flagship()
    k1 = kernel_phase(spec, warm, device)

    # ---- 4. main path, un-fused ------------------------------------------ #
    riccati_cuda.lqr_solve_cuda.launches = 0
    k2a.fused_solve_cuda.launches = 0
    t0 = time.perf_counter()
    extra, settled, secs, cycle, cold_start, _ = main_path(spec, cold, warm, rescue_set, device)
    launches = riccati_cuda.lqr_solve_cuda.launches
    main_s = time.perf_counter() - t0
    expected = (
        2 * cold.n_al * cold.n_sqp
        + (SETTLE_CYCLES + TIMED_CYCLES)
        * (warm.n_al * warm.n_sqp + rescue_set.n_al * rescue_set.n_sqp)
    )
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

    # ---- 7. K2a against its plain version --------------------------------- #
    warm_f = dataclasses.replace(warm, fused="auto")
    rescue_f = dataclasses.replace(rescue_set, fused="auto")
    k2a_rows = k2a_phase(spec, warm_f, rescue_f, settled)

    # ---- 8. main path, fused, from the same cold solve --------------------- #
    riccati_cuda.lqr_solve_cuda.launches = 0
    k2a.fused_solve_cuda.launches = 0
    t0 = time.perf_counter()
    extra_f, settled_f, secs_f, cycle_f, _, k1_in_cycles = main_path(
        spec, cold, warm_f, rescue_f, device, cold_start=cold_start
    )
    k2a_launches = k2a.fused_solve_cuda.launches
    k1_fused = riccati_cuda.lqr_solve_cuda.launches
    main_f_s = time.perf_counter() - t0
    print(json.dumps({**extra_f, "path": "fused", "k2a_launches": k2a_launches,
                      "k1_launches": k1_fused, "k1_launches_in_warm_cycles": k1_in_cycles,
                      "device": card, **secs_f, "main_path_s": main_f_s}))
    if k2a_launches != 2 * (SETTLE_CYCLES + TIMED_CYCLES):
        _fail(f"K2a launched {k2a_launches} times on the fused path, expected "
              f"{2 * (SETTLE_CYCLES + TIMED_CYCLES)}")
    if k1_in_cycles != 0 or k1_fused != cold.n_al * cold.n_sqp:
        _fail(f"K1 launched {k1_in_cycles} times in the fused warm cycles and {k1_fused} "
              f"in all, expected 0 and {cold.n_al * cold.n_sqp} (the oracle)")
    if not extra_f["converged_frac"] >= 0.5:
        _fail(f"fused converged_frac {extra_f['converged_frac']} below the 0.5 floor")

    # ---- 9. fused-vs-un-fused gate on the live warm state ------------------- #
    gate_f, passed = gate_phase(spec, warm, warm_f, settled_f)
    print(json.dumps({"k2a_vs_unfused_gate": gate_f, "passed": passed}))
    if not passed:
        _fail(f"fused-vs-un-fused gate failed: {gate_f}")

    # ---- 10. where one fused warm cycle's device time goes ----------------- #
    print(json.dumps({"trace_fused": trace_phase(cycle_f, settled_f, extra_f["cycle_ms"])}))

    # ---- 11. summary ---------------------------------------------------- #
    row, row2 = k1[BATCH], k2a_rows[BATCH]
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
    }, {
        "name": "K2a fused_al_sqp",
        "route": "cuda",
        "source": "mpc_local_planner_tpu_torch/csrc/fused_al_sqp.cu",
        "replaces": "mpc_local_planner_tpu/ops/fused_al_sqp_pallas.py:264",
        "launches": k2a_launches,
        "max_abs_err": row2["max_abs_err"],
        "ms": row2["ms"],
        "plain_ms": row2["plain_ms"],
        "bound_ms": row2["bound_ms"],
        "bound_by": row2["bound_by"],
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
