"""Solver phase profiling and diagnostics (port of
``mpc_local_planner_tpu.profiling``).

Per-phase wall times of the un-fused solver (one SQP iteration; the line
search's merits), a ``torch.profiler`` trace context whose written trace
keeps the card's records in a long-lived process, and the ensemble's
convergence and active-constraint counters. The timers synchronize the
device before and after: CUDA launches return before the work is done.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
import warnings
from typing import Dict

import numpy as np
import torch
from torch.profiler import ProfilerActivity

from mpc_local_planner_tpu_torch.ocp import constraints as C
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.problem import make_ocp_functions
from mpc_local_planner_tpu_torch.solvers import al_sqp as A


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_solver_phases(
    spec, settings, scenario, init, duals, iters: int = 3
) -> Dict[str, float]:
    """Per-phase wall times (ms) of one SQP iteration over a scenario batch,
    on the device the tensors lie on (each phase called once first).

    Phases: the full iteration (AD derivatives, the Riccati KKT solve, which
    is kernel K1 on the card, and the line search) and the line search's
    merit evaluated at 6 candidates.
    """
    funcs = make_ocp_functions(spec)
    kkt_system = A.default_kkt_system(spec, settings, scenario, init)
    lqr = A.kkt_backend(settings)
    decisions = A.Decisions()
    reg = torch.full(init.dt.shape[:1], settings.reg0, dtype=init.xs.dtype,
                     device=init.xs.device)
    cands = Primal(
        xs=init.xs.expand((6,) + init.xs.shape),
        us=init.us.expand((6,) + init.us.shape),
        dt=init.dt.expand((6,) + init.dt.shape),
    )

    def full_iteration():
        p2, _ = A._sqp_iteration(spec, funcs, settings, kkt_system, init, scenario, duals, reg,
                                 lqr, decisions)
        return p2.us

    def line_search_merits():
        return A._al_merit(funcs, cands, scenario, duals)

    device = init.xs.device
    out: Dict[str, float] = {}
    for name, fn in (("full_iteration", full_iteration),
                     ("line_search_merits", line_search_merits)):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        for _i in range(iters):
            fn()
        _sync(device)
        out[name] = (time.perf_counter() - t0) / iters * 1e3
    return out


# On a card in a long-lived process the profiler loses device records and
# places the rest off the host's clock (``trace_probe.py`` on an H100):
# - a session drops its first N kernel and copy records, in launch order,
#   as outside its window, N growing with the time since the process's
#   first session (4, 11 and all 22 kernels at 60, 150 and 300 s); a wait
#   before the work does not keep them (a 1 s wait kept none of the first 7
#   at 100 s);
# - its device records sit off their launch calls by up to milliseconds,
#   either way (-7.3 ms, +0.6 ms), so a window that closes with the traced
#   block cuts the kernels at its edges.
# ``torch_trace`` opens each session on the card with WARMUP_LAUNCHES
# launches of ``torch.cuda._sleep``'s one-thread kernel, whose records are
# the ones lost, idles TRACE_PAD_S around the traced block, and writes the
# block alone, its device records put back on the host's clock
# (``align_device_records``).
TRACE_PAD_S = 0.1
WARMUP_LAUNCHES = 1024
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


@contextlib.contextmanager
def torch_trace(log_dir: str, cpu: bool = True):
    """``torch.profiler`` context (the counterpart of ``xla_trace``): CPU
    activity unless ``cpu=False``, and the card's when one is present.
    Writes a TensorBoard / Chrome trace ``<host>_<pid>.<ms>.pt.trace.json``
    of the traced block into ``log_dir``, its device records aligned on the
    host's clock, and yields the profiler. ::

        with profiling.torch_trace("/tmp/torch-trace"):
            solver(scen, init, duals)

    On a card the session starts with WARMUP_LAUNCHES launches of a
    one-thread kernel and the device synchronized, with TRACE_PAD_S of idle
    time before and after the traced block. The profiler's own events
    (``key_averages()``) hold the warm-up; the written trace does not.
    Warns when a kernel launched in the block has no device record.
    """
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] if cpu else []
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    if not activities:
        raise ValueError("torch_trace(cpu=False) records the card's activity alone: no card")
    with torch.profiler.profile(activities=activities) as prof:
        if cuda:
            for _ in range(WARMUP_LAUNCHES):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        block = [time.time_ns()]
        yield prof
        if cuda:
            torch.cuda.synchronize()
        block.append(time.time_ns())
        if cuda:
            time.sleep(TRACE_PAD_S)
    _write_trace(prof, log_dir, block)


def align_device_records(events, block_us) -> Dict[str, float]:
    """Keep a Chrome trace's traced block and put its device records on the
    host's clock, in place.

    ``block_us`` = (start, end) on the events' time scale: host events
    wholly outside it go, and so do the device records (and flow arrows)
    whose launch call went. The device is idle when the block starts, so
    its first launch starts on the device within a launch latency (a few
    µs) of its call: the device records kept are shifted by the least lag
    from a launch call (a ``cuda_runtime`` or ``cuda_driver`` event) to its
    device record, which then is 0. Returns the shift (µs), the device
    records kept and dropped, the kernel launches of the block with no
    device record, and those before it (the warm-up's lost records)."""
    def host(e):
        return e.get("ph") == "X" and e.get("cat") not in DEVICE_CATEGORIES + ("Trace",)

    def outside(e):
        return e["ts"] + e.get("dur", 0.0) < block_us[0] or e["ts"] > block_us[1]

    def kernel_launch(e):
        return "LaunchKernel" in e.get("name", "")

    launches = [e for e in events if e.get("cat") in LAUNCH_CATEGORIES
                and "correlation" in e.get("args", {})]
    recorded = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in DEVICE_CATEGORIES}
    early = sum(1 for e in launches if e["ts"] < block_us[0] and kernel_launch(e)
                and e["args"]["correlation"] not in recorded)
    gone = {id(e) for e in events if host(e) and outside(e)}
    launch = {e["args"]["correlation"]: e for e in launches if id(e) not in gone}
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    ours = [e for e in device if e.get("args", {}).get("correlation") in launch]
    shift = min((e["ts"] - launch[e["args"]["correlation"]]["ts"] for e in ours), default=0.0)
    for e in device:
        e["ts"] -= shift
    for e in device:
        if e.get("args", {}).get("correlation") not in launch and (
                e.get("cat") != "gpu_user_annotation" or outside(e)):
            gone.add(id(e))
    for e in events:
        if e.get("cat") == "ac2g":
            if e.get("id") not in launch:
                gone.add(id(e))
            elif e.get("ph") == "f":
                e["ts"] -= shift
        elif e.get("cat") == "Trace":
            e["ts"], e["dur"] = block_us[0], block_us[1] - block_us[0]
    dropped = sum(1 for e in device if id(e) in gone)
    events[:] = [e for e in events if id(e) not in gone]
    kept = {e["args"]["correlation"] for e in ours}
    unrecorded = sum(1 for c, e in launch.items() if kernel_launch(e) and c not in kept)
    return {"shift_us": shift, "device_records": len(device) - dropped, "dropped": dropped,
            "launches_unrecorded": unrecorded, "warmup_unrecorded": early}


def _write_trace(prof, log_dir: str, block_ns):
    """Export a finished ``torch.profiler`` session into ``log_dir`` as
    ``torch_trace`` names it, cut to ``block_ns`` (host ``time.time_ns()``
    at the traced block's start and end) and its device records aligned
    (``align_device_records``, whose counts the trace keeps under
    ``torch_trace_alignment``)."""
    os.makedirs(log_dir, exist_ok=True)
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    events = trace.get("traceEvents", [])
    base = trace.get("baseTimeNanoseconds", 0)
    stats = align_device_records(events, tuple((t - base) / 1e3 for t in block_ns))
    trace["torch_trace_alignment"] = stats
    if stats["launches_unrecorded"]:
        warnings.warn(f"torch_trace: {stats['launches_unrecorded']} kernel launches of the "
                      f"traced block have no device record ({stats})")
    with open(path, "w") as fh:
        json.dump(trace, fh)


def active_constraints_report(spec, result, scenario) -> Dict[str, float]:
    """Per-class active-inequality counters at the returned iterate. A
    constraint counts as active when its value is within tol of the boundary
    or violated (g > −tol). Means are per scenario."""
    p = result.primal
    tol = 1e-3
    classes = {
        "obstacle": C.obstacle_inequalities(spec, p.xs, p.dt, scenario),
        "rate": C.control_rate_inequalities(spec, p.us, p.dt, scenario.u_prev),
        "box": C.control_box_inequalities(spec, p.us),
        "dt": C.dt_inequalities(spec, p.dt, p.xs.dtype),
        "ball": C.terminal_ball_inequality(spec, p.xs, scenario.xf),
    }
    batch_ndim = p.xs.dim() - 2  # leading scenario axes, if any
    out: Dict[str, float] = {}
    for name, g in classes.items():
        active = (g > -tol).cpu().numpy()
        per_scen = active.reshape(active.shape[:batch_ndim] + (-1,)).sum(-1)
        out[f"active_{name}_mean"] = float(per_scen.mean())
        out[f"active_{name}_max"] = int(per_scen.max()) if per_scen.size else 0
    return out


def convergence_report(result) -> Dict[str, float]:
    """Ensemble convergence and feasibility counters."""
    eq = result.eq_norm.detach().cpu().numpy().ravel()
    viol = result.ineq_viol.detach().cpu().numpy().ravel()
    conv = result.converged.detach().cpu().numpy().ravel()
    return {
        "n_scenarios": int(eq.size),
        "converged_frac": float(conv.mean()) if eq.size else 0.0,
        "eq_p50": float(np.percentile(eq, 50)) if eq.size else 0.0,
        "eq_p99": float(np.percentile(eq, 99)) if eq.size else 0.0,
        "viol_p50": float(np.percentile(viol, 50)) if viol.size else 0.0,
        "viol_p99": float(np.percentile(viol, 99)) if viol.size else 0.0,
        "diverged_frac": float(((eq > 0.5) | (viol > 0.5)).mean()) if eq.size else 0.0,
    }
