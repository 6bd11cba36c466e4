#!/usr/bin/env python3
"""Probes of ``torch.profiler``'s device records on one NVIDIA GPU: what
leaves a session of a long-lived process without its kernel records, and
what ``profiling.torch_trace`` does about it.

    python3 trace_probe.py [PROBE ...]
    (memory, memory-first, overflow, cuda-only and time by default; each
    probe in a fresh process, in the order given)

Every session traces the same small workload (``WORK_LAUNCHES``
elementwise kernels, a reduction and one copy to the host) and reads its
trace file: the events by category, the kernels among them, the work's
kernel launches with no kernel record (``lost``) and how many of them lead
the session (``lost_leading``: the first launches, in launch order), and
each kernel's start less its launch call's (``lag_us``: least, median,
largest; matched by correlation id). A bare session is a
``torch.profiler.profile`` that writes its trace with
``tensorboard_trace_handler`` (``torch_trace`` before its repair), CPU and
CUDA activity unless it says ``cpu: false``; a ``padded`` one waits
``PAD_S`` before and after the workload inside the window; a ``warmup`` one
launches ``WARMUP`` one-element additions first and synchronizes (their
records are left out of its counts); a ``torch_trace`` one is the
package's ``profiling.torch_trace`` (its device records aligned).

- memory: a session; the caching allocator then reserves all but
  ``SPARE_BYTES`` of the card's free memory and frees it to its cache
  (reserved, unused); a session, a padded one; ``empty_cache``; a session.
- memory-first: the same reservation before the first session, then a
  session; ``empty_cache``; a session.
- overflow: one CUDA-only session around ``OVERFLOW_LAUNCHES`` launches,
  then a session.
- cuda-only: three CUDA-only sessions (as ``chip_smoke.trace_phase`` once
  traced), then a session.
- time: a bare, a padded and a ``torch_trace`` session at each of
  ``TIME_POINTS_S`` seconds after the first.
- onset: a bare and a ``torch_trace`` session every ``ONSET_EVERY_S`` for
  ``ONSET_S`` seconds.
- teardown: as time at ``TEARDOWN_POINTS_S``, with ``TEARDOWN_CUPTI=1``
  set before torch is imported (CUPTI torn down after each session).
- big-cuda, big-cpu: one CUDA-only (big-cuda) or CPU+CUDA (big-cpu)
  session around ``BIG_LAUNCHES`` launches, as the smoke's traces of an
  un-fused step; then three sessions and a CUDA-only one.
- many-cuda: ``MANY`` CUDA-only sessions of ``MANY_LAUNCHES`` launches;
  then three sessions and a CUDA-only one.
- age, age-eager, age-warmup: a bare session and a CUDA-only one at each
  of ``AGE_POINTS_S`` seconds; age-eager with ``TEARDOWN_CUPTI=1`` and
  ``DISABLE_CUPTI_LAZY_REINIT=1`` (CUPTI re-initialized at each session),
  age-warmup with the warm-up in each session.
- clocks: at each of ``CLOCK_POINTS_S`` seconds a bare session and one
  padded by ``CLOCK_PAD_S``, each with the host's clock
  (``time.time_ns()``) read before the work: where the first launch call
  and the first kernel record sit against it (``first_launch_us``,
  ``first_kernel_us``); and the host's ``time_ns() - monotonic_ns()`` every
  ``CLOCK_EVERY_S`` (its spread, ``realtime_minus_monotonic_spread_ns``).

Each probe prints one JSON line; the script ends with the card line.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

WORK_LAUNCHES = 20
PAD_S = 0.25
WARMUP = 64
SPARE_BYTES = 256 << 20
OVERFLOW_LAUNCHES = 300_000
TIME_POINTS_S = (0, 60, 150, 300, 480)
ONSET_S, ONSET_EVERY_S = 120, 2.0
TEARDOWN_POINTS_S = (0, 150, 300)
BIG_LAUNCHES, MANY, MANY_LAUNCHES = 15_000, 30, 300
AGE_POINTS_S = (0, 1, 2, 100, 101, 200, 201, 300, 301)
CLOCK_POINTS_S, CLOCK_PAD_S, CLOCK_EVERY_S = (0, 100, 200, 300), 1.0, 10.0
PROBES = ("memory", "memory-first", "overflow", "cuda-only", "time")
MORE = ("onset", "teardown", "big-cuda", "big-cpu", "many-cuda", "age", "age-eager",
        "age-warmup", "clocks")
ENV = {"teardown": {"TEARDOWN_CUPTI": "1"},
       "age-eager": {"TEARDOWN_CUPTI": "1", "DISABLE_CUPTI_LAZY_REINIT": "1"}}


def work():
    import torch

    x = torch.ones(1 << 20, device="cuda")
    for _ in range(WORK_LAUNCHES):
        x.mul_(1.0001)
    return float(x.sum())  # a reduction and a copy to the host


def session(padded=False, cpu=True, package=False, warmup=False, pad_s=PAD_S, stamps=False):
    """One profiler session around ``work()`` (``package``: through
    ``profiling.torch_trace``); its trace file's counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from mpc_local_planner_tpu_torch import profiling

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    t_work = None
    with tempfile.TemporaryDirectory() as tmp:
        if package:
            with profiling.torch_trace(tmp, cpu=cpu):
                work()
        else:
            with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(tmp)):
                if padded:
                    time.sleep(pad_s)
                if warmup:
                    y = torch.zeros(1, device="cuda")
                    for _ in range(WARMUP):
                        y.add_(1)
                    torch.cuda.synchronize()
                    time.sleep(0.02)
                t_work = time.time_ns()
                work()
                torch.cuda.synchronize()
                if padded:
                    time.sleep(pad_s)
        trace = {}
        for f in glob.glob(os.path.join(tmp, "*.json")):
            with open(f) as fh:
                trace = json.load(fh)
    events = trace.get("traceEvents", [])
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    if warmup:  # the warm-up's launches (its fill and additions) and their kernels go
        skip = set(sorted(c for c, e in launch.items()
                          if "LaunchKernel" in e["name"])[:WARMUP + 1])
        events = [e for e in events if e.get("args", {}).get("correlation") not in skip]
        launch = {c: e for c, e in launch.items() if c not in skip}
    cats = collections.Counter(str(e.get("cat")) for e in events)
    kernels = {e["args"].get("correlation"): e for e in events if e.get("cat") == "kernel"}
    order = sorted(c for c, e in launch.items() if "LaunchKernel" in e["name"])
    lost = [c not in kernels for c in order]
    lags = sorted(k["ts"] - launch[c]["ts"] for c, k in kernels.items() if c in launch)
    out = {"padded": padded, "cpu": cpu, "torch_trace": package, "warmup": warmup,
           "kernel": cats.get("kernel", 0), "gpu_memcpy": cats.get("gpu_memcpy", 0),
           "cuda_runtime": cats.get("cuda_runtime", 0), "lost": sum(lost),
           "lost_leading": next((i for i, x in enumerate(lost) if not x), len(lost)),
           "lag_us": [round(lags[0], 1), round(lags[len(lags) // 2], 1), round(lags[-1], 1)]
           if lags else None}
    if stamps and t_work is not None and order:
        base = trace.get("baseTimeNanoseconds", 0) / 1e3 - t_work / 1e3
        out["first_launch_us"] = round(launch[order[0]]["ts"] + base, 1)
        first = [k["ts"] for k in kernels.values()]
        out["first_kernel_us"] = round(min(first) + base, 1) if first else None
    return out


def reserve_free_memory():
    """Fill the caching allocator with all but SPARE_BYTES of the card's
    free memory, then free the tensors: the blocks stay reserved."""
    import torch

    blocks, chunk = [], 1 << 30
    while chunk >= 1 << 20:
        free, _ = torch.cuda.mem_get_info()
        if free - chunk < SPARE_BYTES:
            chunk //= 2
            continue
        blocks.append(torch.empty(chunk, dtype=torch.uint8, device="cuda"))
    del blocks
    return memory()


def memory():
    import torch

    free, total = torch.cuda.mem_get_info()
    return {"free_mib": free >> 20, "total_mib": total >> 20,
            "reserved_mib": torch.cuda.memory_reserved() >> 20}


def _at(t0, at):
    time.sleep(max(0.0, t0 + at - time.perf_counter()))


def probe(name):
    import torch

    work()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = []
    if name == "memory":
        rows.append(("fresh", memory(), session()))
        rows.append(("reserved", reserve_free_memory(), session()))
        rows.append(("reserved", memory(), session(padded=True)))
        torch.cuda.empty_cache()
        rows.append(("empty_cache", memory(), session()))
    elif name == "memory-first":
        rows.append(("reserved", reserve_free_memory(), session()))
        torch.cuda.empty_cache()
        rows.append(("empty_cache", memory(), session()))
    elif name == "overflow":
        from torch.profiler import ProfilerActivity, profile

        x = torch.zeros(1, device="cuda")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(OVERFLOW_LAUNCHES):
                x.add_(1)
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")
        rows.append(("cuda_only_big", {"device_events": n}, None))
        rows.append(("after", memory(), session()))
    elif name == "cuda-only":
        for i in range(3):
            rows.append((f"cuda_only_{i}", {}, session(cpu=False)))
        rows.append(("after", memory(), session()))
    elif name in ("time", "teardown"):
        for at in TIME_POINTS_S if name == "time" else TEARDOWN_POINTS_S:
            _at(t0, at)
            rows.append((f"t={at}s", {}, session()))
            rows.append((f"t={at}s", {}, session(padded=True)))
            rows.append((f"t={at}s", {}, session(package=True)))
    elif name == "onset":
        while time.perf_counter() < t0 + ONSET_S:
            at = round(time.perf_counter() - t0, 1)
            rows.append((f"t={at}s", {}, session()))
            rows.append((f"t={at}s", {}, session(package=True)))
            time.sleep(ONSET_EVERY_S)
    elif name in ("big-cuda", "big-cpu", "many-cuda"):
        from torch.profiler import ProfilerActivity, profile

        x = torch.zeros(1, device="cuda")
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if name == "big-cpu" else [])
        for _ in range(MANY if name == "many-cuda" else 1):
            with profile(activities=acts) as prof:
                for _ in range(MANY_LAUNCHES if name == "many-cuda" else BIG_LAUNCHES):
                    x.add_(1)
                torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages() if e.device_type.name == "CUDA")
        rows.append((name, {"device_events_last": n}, None))
        for i in range(3):
            rows.append((f"after_{i}", {}, session()))
        rows.append(("after_cuda_only", {}, session(cpu=False)))
    elif name in ("age", "age-eager", "age-warmup"):
        for at in AGE_POINTS_S:
            _at(t0, at)
            rows.append((f"t={at}s", {}, session(warmup=name == "age-warmup")))
            rows.append((f"t={at}s", {}, session(cpu=False, warmup=name == "age-warmup")))
    elif name == "clocks":
        spread = []
        for at in CLOCK_POINTS_S:
            while time.perf_counter() < t0 + at:
                spread.append(time.time_ns() - time.monotonic_ns())
                time.sleep(min(CLOCK_EVERY_S, max(0.0, t0 + at - time.perf_counter())))
            rows.append((f"t={at}s", {}, session(stamps=True)))
            rows.append((f"t={at}s", {}, session(padded=True, pad_s=CLOCK_PAD_S, stamps=True)))
        rows.append(("host", {"realtime_minus_monotonic_spread_ns": max(spread) - min(spread)},
                     None))
    else:
        raise SystemExit(f"unknown probe {name!r}; one of {PROBES + MORE}")
    print(json.dumps({"probe": name, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "seconds": round(time.perf_counter() - t0, 2),
                      "rows": [{"at": a, **m, **(s or {})} for a, m, s in rows]}), flush=True)


def main(names):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("trace_probe: torch.cuda.is_available() is false: needs a CUDA card")
    for name in names or PROBES:
        env = dict(os.environ, **ENV.get(name, {}))
        subprocess.run([sys.executable, __file__, "--one", name], check=True, env=env)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        probe(sys.argv[2])
    else:
        main(sys.argv[1:])
