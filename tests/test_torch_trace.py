"""``profiling.torch_trace`` and ``align_device_records`` on the CPU.

* ``align_device_records`` shifts a synthetic Chrome trace's device records
  (and the flow arrows ending on them) by the least launch-to-record lag of
  the session, whether the device's clock runs early or late, drops the
  device records launched outside the session and counts the kernel
  launches that have no device record; the host's events keep their times.
  Cut to a block, it drops the host events outside it (a warm-up's
  launches, one of them with no device record, which it counts) and their
  device records and flows, and clips the profiler's span to the block.
* ``torch_trace`` on the CPU writes one ``*.pt.trace.json`` and yields the
  profiler; ``cpu=False`` there has nothing to record and raises.
"""

import json

import pytest
import torch

from mpc_local_planner_tpu_torch import profiling


def _trace(offset_us, lags=(5.0, 40.0, 90.0)):
    """Three kernel launches at 100, 200, 300 µs, their kernels ``lags``
    later on the device's clock, which runs ``offset_us`` late; a CPU op,
    a stream sync, a kernel launched before the session, and the flows."""
    events = [{"cat": "cpu_op", "name": "aten::mul", "ts": 90.0, "dur": 300.0}]
    for i, lag in enumerate(lags):
        t = 100.0 * (i + 1)
        events += [
            {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t, "dur": 4.0,
             "args": {"correlation": 10 + i}},
            {"cat": "kernel", "name": f"k{i}", "ts": t + lag + offset_us, "dur": 3.0,
             "args": {"correlation": 10 + i}},
            {"cat": "ac2g", "ph": "s", "id": 10 + i, "ts": t},
            {"cat": "ac2g", "ph": "f", "id": 10 + i, "ts": t + lag + offset_us},
        ]
    events += [
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 400.0, "dur": 2.0,
         "args": {"correlation": 20}},
        {"cat": "kernel", "name": "before", "ts": 50.0 + offset_us, "dur": 3.0,
         "args": {"correlation": 3}},
    ]
    return events


@pytest.mark.parametrize("offset_us", [0.0, 5300.0, -2435.0])
def test_torch_align_device_records_puts_the_device_on_the_host_clock(offset_us):
    events = _trace(offset_us)
    stats = profiling.align_device_records(events, block_us=(0.0, 1e4))
    assert stats == {"shift_us": 5.0 + offset_us, "device_records": 3, "dropped": 1,
                     "launches_unrecorded": 0, "warmup_unrecorded": 0}
    kernels = {e["name"]: e["ts"] for e in events if e.get("cat") == "kernel"}
    assert kernels == {"k0": 100.0, "k1": 235.0, "k2": 385.0}
    flows = sorted(e["ts"] for e in events if e.get("ph") == "f")
    assert flows == [100.0, 235.0, 385.0]
    assert [e["ts"] for e in events if e.get("cat") == "cpu_op"] == [90.0]
    assert [e["ts"] for e in events if e.get("cat") == "cuda_runtime"] == [100.0, 200.0, 300.0,
                                                                          400.0]


def test_torch_align_device_records_counts_launches_without_a_record():
    events = [e for e in _trace(0.0) if e.get("name") != "k1"]
    stats = profiling.align_device_records(events, block_us=(0.0, 1e4))
    assert stats["launches_unrecorded"] == 1 and stats["device_records"] == 2


def test_torch_align_device_records_cuts_the_trace_to_the_block():
    warmup = [
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10.0, "dur": 3.0,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "spin_kernel", "ts": 2000.0, "dur": 2.0,
         "args": {"correlation": 1}},
        {"cat": "ac2g", "ph": "f", "id": 1, "ts": 2000.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20.0, "dur": 3.0,
         "args": {"correlation": 2}},
        {"cat": "Trace", "ph": "X", "name": "PyTorch Profiler (0)", "ts": 0.0, "dur": 900.0},
        {"cat": "Trace", "ph": "M", "name": "process_name", "ts": 0.0},
    ]
    events = [dict(e, ph=e.get("ph", "X")) for e in warmup + _trace(0.0)]
    stats = profiling.align_device_records(events, block_us=(80.0, 500.0))
    assert stats == {"shift_us": 5.0, "device_records": 3, "dropped": 2,
                     "launches_unrecorded": 0, "warmup_unrecorded": 1}
    assert sorted(e["name"] for e in events if e.get("cat") == "kernel") == ["k0", "k1", "k2"]
    assert [e["ts"] for e in events if e.get("cat") == "cuda_runtime"] == [100.0, 200.0, 300.0,
                                                                          400.0]
    assert sorted(e["id"] for e in events if e.get("cat") == "ac2g") == [10, 10, 11, 11, 12, 12]
    span = [e for e in events if e.get("cat") == "Trace" and e["ph"] == "X"]
    assert [(e["ts"], e["dur"]) for e in span] == [(80.0, 420.0)]
    assert sum(e["ph"] == "M" for e in events) == 1


def test_torch_trace_on_the_cpu_writes_one_trace(tmp_path):
    with profiling.torch_trace(str(tmp_path)) as prof:
        torch.ones(8).mul(2.0).sum()
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::mul" in names
    assert any(e.key == "aten::mul" for e in prof.key_averages())
    with pytest.raises(ValueError):
        with profiling.torch_trace(str(tmp_path), cpu=False):
            pass
