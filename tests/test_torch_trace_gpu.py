"""``profiling.torch_trace`` on the card keeps every kernel of its traced
block, session after session, for most of a minute (fault F6, ROADMAP §3).

In a long-lived process the profiler drops the first N kernel and copy
records of a session that records the host's activity too, N growing with
the process's age (7, 15 and 24 records 100, 200 and 300 s into a process,
none in its first seconds; ``trace_probe.py age`` on an H100), and places
the device records off their launch calls by up to milliseconds. So the
fault shows only after minutes: within this test's minute a bare session
loses nothing in most runs, and the whole smoke's phase 47, about 500 s
into its process, is the check that meets it. This test holds the repaired
``torch_trace`` (its warm-up, pads and alignment) to every kernel of the
block and to aligned records.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_trace_gpu.py

* every 0.5 s for 45 s, ``torch_trace`` around a few small kernels and a
  copy to the host writes a trace whose kernel records match the session's
  kernel launches one for one, the first of them starting at its launch
  call, within 0.01 µs (the device records aligned on the host's clock).
"""

import glob
import json
import os
import time

import pytest
import torch

from mpc_local_planner_tpu_torch import profiling

SECONDS, EVERY_S = 45.0, 0.5


def _work():
    x = torch.ones(1 << 20, device="cuda")
    for _ in range(20):
        x.mul_(1.0001)
    return float(x.sum())


@pytest.mark.gpu
def test_torch_trace_keeps_every_kernel_for_a_minute(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler's device records")
    _work()
    rows, t_end = [], time.perf_counter() + SECONDS
    while time.perf_counter() < t_end:
        log_dir = str(tmp_path / str(len(rows)))
        with profiling.torch_trace(log_dir):
            _work()
        (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        launch = {e["args"]["correlation"]: e for e in events if e.get("cat") == "cuda_runtime"
                  and "LaunchKernel" in e.get("name", "")}
        kernels = [e for e in events if e.get("cat") == "kernel"]
        lags = [k["ts"] - launch[k["args"]["correlation"]]["ts"] for k in kernels
                if k["args"].get("correlation") in launch]
        rows.append((len(launch), len(kernels), len(lags), min(lags, default=None)))
        time.sleep(EVERY_S)
    assert len(rows) > 20
    assert all(n >= 22 and n == k == m and abs(lag) < 0.01 for n, k, m, lag in rows), rows
