"""Kernel K1's launch geometry (``ops/riccati_cuda.py`` ``launch_geometry``),
on the CPU: the lanes of a team, the scenarios of a block, the ring's chunk
and slots, the block's shared bytes and the workspace's values per scenario,
as ``csrc/riccati_sweep.cu``'s ``make_geometry`` computes them.

- The source's own design at N = 1, 30, 96, 120 and 257, float and double,
  pinned; where the ring starts (the horizon no longer fits it whole) and
  where the gain tape leaves shared memory for the workspace.
- Every horizon up to 300, for the design and the others ``fused_probe.py
  k1`` measures: the block's shared memory within the 227 KB a block can
  have, a scenario's within its budget, the ring's chunk and slots within
  their bounds, the workspace whole or absent.
- ``launch`` passes the library a workspace exactly where the geometry names
  one (a stand-in library that records the call: no card is needed).

The library's own numbers (``riccati_sweep_launch_geometry``) are held
against this function on the card, in ``tests/test_torch_k1_gpu.py``, and
at every load of the library (``riccati_cuda.bind``).
"""

import pytest
import torch

from mpc_local_planner_tpu_torch.ops import riccati_cuda

BLOCK_LIMIT = 232448  # 227 KB: the most shared memory an H100 block can have
DTYPES = [torch.float32, torch.float64]
# fused_probe.py K1_VARIANTS: (team, scenarios per block, chunk, slots, budget)
DESIGNS = [riccati_cuda.Design(*d) for d in (
    (8, 4, 4, 2, 6656), (8, 4, 4, 2, 6144), (4, 8, 4, 2, 6656), (8, 4, 6, 2, 8192),
    (8, 4, 8, 4, 18432), (8, 2, 8, 4, 18432), (8, 8, 8, 2, 10240), (4, 8, 8, 2, 10240),
)]

# (N, dtype): (team, scenarios per block, chunk, slots, shared bytes, workspace)
PINNED = {
    (1, torch.float32): (8, 4, 1, 1, 4096, 0),
    (1, torch.float64): (8, 4, 1, 1, 7040, 0),
    (30, torch.float32): (8, 4, 4, 2, 24896, 0),
    (30, torch.float64): (8, 4, 4, 2, 48576, 0),
    (96, torch.float32): (8, 4, 4, 2, 17216, 96 * 16),
    (96, torch.float64): (8, 4, 4, 2, 33216, 96 * 16),
    (120, torch.float32): (8, 4, 4, 2, 17216, 120 * 16),
    (120, torch.float64): (8, 4, 4, 2, 33216, 120 * 16),
    (257, torch.float32): (8, 4, 4, 2, 17216, 257 * 16),
    (257, torch.float64): (8, 4, 4, 2, 33216, 257 * 16),
}


def test_torch_k1_design_is_the_sources():
    assert riccati_cuda.DESIGN == riccati_cuda.Design(8, 4, 4, 2, 6656)
    assert riccati_cuda.DESIGN.defines() == (
        "K1_TEAM=8", "K1_SPB=4", "K1_CHUNK=4", "K1_SLOTS=2", "K1_SMEM_F32=6656")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("N", [1, 30, 96, 120, 257])
def test_torch_k1_launch_geometry_is_pinned(N, dtype):
    """The flagship's N = 30 holds its gain tape on chip in both types and
    runs the ring (two slots of four stages; the rollout refills it); from
    N = 96 the tape is in the workspace (16 values a stage)."""
    geo = riccati_cuda.launch_geometry(N, dtype)
    assert tuple(geo) == PINNED[(N, dtype)]
    assert geo.shared_bytes <= BLOCK_LIMIT


@pytest.mark.parametrize("dtype, ring_from, workspace_from",
                         [(torch.float32, 9, 38), (torch.float64, 9, 40)], ids=["f32", "f64"])
def test_torch_k1_ring_and_workspace_start_where_the_budget_ends(dtype, ring_from, workspace_from):
    """The ring holds the horizon whole up to N = 8 (two chunks of four); the
    tape stays in shared memory up to N = 37 in float and 39 in double."""
    for N in range(1, 300):
        geo = riccati_cuda.launch_geometry(N, dtype)
        assert (geo.chunk * geo.slots < N) == (N >= ring_from), N
        assert (geo.workspace > 0) == (N >= workspace_from), N


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("design", DESIGNS, ids=lambda d: "_".join(map(str, d)))
def test_torch_k1_launch_geometry_fits_a_block_at_every_horizon(design, dtype):
    es = 8 if dtype == torch.float64 else 4
    budget = min(design.smem_f32 // 4 * es,
                 (riccati_cuda.BLOCK_SMEM - riccati_cuda.BAR_BYTES) // design.spb)
    for N in range(1, 301):
        geo = riccati_cuda.launch_geometry(N, dtype, design)
        nq = -(-N // geo.chunk)
        assert (geo.team, geo.scenarios_per_block) == (design.team, design.spb)
        assert geo.shared_bytes <= BLOCK_LIMIT, N
        assert (geo.shared_bytes - riccati_cuda.BAR_BYTES) % (16 * design.spb) == 0, N
        assert 1 <= geo.chunk <= min(N, design.chunk), N
        assert min(nq, 2, design.slots) <= geo.slots <= min(nq, design.slots), N
        assert geo.workspace in (0, N * riccati_cuda.TAPE_STRIDE), N
        per = (geo.shared_bytes - riccati_cuda.BAR_BYTES) // design.spb
        fallback = geo.chunk == 1 and geo.workspace and geo.slots == min(nq, 2)
        assert per <= budget or fallback, N
        # a ring that holds the horizon whole, or at least two chunks of it
        assert geo.slots == nq or geo.slots >= min(2, design.slots), N


class _Recorder:
    """A stand-in K1 library: records the launch's arguments."""

    def __init__(self, design, rc=0):
        self.design, self.rc, self.calls = design, rc, []

    def riccati_sweep_f32(self, *args):
        self.calls.append(args)
        return self.rc

    riccati_sweep_f64 = riccati_sweep_f32

    def riccati_sweep_error_string(self, rc):
        return b"stand-in failure"


def _inputs(B, N, dtype):
    return tuple(torch.zeros(s, dtype=dtype) for s in riccati_cuda._expected_shapes(B, N))


@pytest.mark.parametrize("B, N, dtype", [(5, 30, torch.float32), (5, 96, torch.float32),
                                         (9, 257, torch.float64), (1, 1, torch.float64)])
def test_torch_k1_launch_passes_the_workspace_the_geometry_names(B, N, dtype):
    lib = _Recorder(riccati_cuda.DESIGN)
    args = _inputs(B, N, dtype)
    step = riccati_cuda.launch(lib, args, True, 1234)
    assert step.dxs.shape == (B, N + 1, 3) and step.dus.shape == (B, N, 2)
    assert step.dtau.shape == (B,) and step.dV.shape == (B,)
    (call,) = lib.calls
    assert call[:11] == tuple(a.data_ptr() for a in args)
    tape = call[15]
    geo = riccati_cuda.launch_geometry(N, dtype)
    assert (tape is None) == (geo.workspace == 0)
    assert call[16:] == (B, N, 1, 1234)


def test_torch_k1_launch_raises_on_a_refused_launch():
    lib = _Recorder(riccati_cuda.DESIGN, rc=9)
    with pytest.raises(RuntimeError, match="stand-in failure"):
        riccati_cuda.launch(lib, _inputs(3, 6, torch.float32), False, 0)
