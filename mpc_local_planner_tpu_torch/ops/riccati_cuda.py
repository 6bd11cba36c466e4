"""Kernel K1: the batched Riccati sweep as a hand-written CUDA kernel.

Replaces the TPU kernel ``mpc_local_planner_tpu/ops/riccati_pallas.py ::
_riccati_kernel`` (launched by ``lqr_solve_pallas``). The source is
``csrc/riccati_sweep.cu``: the backward sweep, the 2×2 Quu inverse, the gain
tape, the free-δτ stage and the forward rollout, for float and double, at
any N.

What bounds it on an H100 is bytes: per scenario it reads 114 values per
stage plus PN, pN and reg, and writes the step, 14,472 B per scenario at
N=30 in float — 59.3 MB for a batch of 4096, about 18 µs at 3.35 TB/s. So
each byte makes one trip, in flight ahead of the recursion: a block of
``scenarios_per_block`` consecutive scenarios has a producer warp that
copies their stage data into shared memory by TMA bulk copies (stage N−1
first, chunk by chunk of ``chunk`` stages, into a ring of ``slots`` chunks
with a full and an empty mbarrier each, the later chunks in flight while
the current one is worked on); a team of ``team`` lanes runs each
scenario's recursion, the stage's 6×8 products spread over the lanes by
column; the gain tape (14 values per stage) stays in shared memory, and the
step is staged there and written out in contiguous runs. ``launch_geometry``
computes the layout from (N, working type) within a budget per scenario:
where the ring cannot hold the horizon the rollout refills it with Fz, Gz
and rz, and where the budget cannot hold the tape it goes to a workspace
the wrapper allocates. The library reports the same numbers
(``riccati_sweep_launch_geometry``), checked at load. The design's five
macros (``Design``) were chosen by ``fused_probe.py k1`` on the card.

Inputs may start at any multiple of their element size: each span lands in
shared memory at its source's address modulo 16, the interior by a bulk
copy, the head and tail by 4- or 8-byte ``cp.async``.

Build: at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles
the source into a plain-C shared library under ``_build/`` (keyed by the
source's hash), loaded with ``ctypes``.

Dispatch (``lqr_solve_auto``): CPU tensors take the plain version
``solvers.riccati.lqr_solve``; CUDA tensors launch the kernel or raise. There
is no fallback.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from mpc_local_planner_tpu_torch.ops import nvcc_build
from mpc_local_planner_tpu_torch.solvers.riccati import LqrStep, lqr_solve

SOURCE = nvcc_build.CSRC / "riccati_sweep.cu"
NA, NU, NX = 6, 2, 3
TAPE = NU * NA + NU  # the gain tape per stage: K (2×6), kff (2)
TAPE_STRIDE = 16  # a stage's values in the tape, padded for 16-byte loads
WIDTHS = (NA * NA, NA * NU, NA, NA * NA, NA * NU, NU * NU, NA, NU)  # Fz … hu per stage
# a team's scratch values: the P update (36), Q's control columns and qu
# (20), p (8)
SCRATCH = NA * NA + (NU * (NA + NU) + NU + 2) + 8
BLOCK_SMEM = 232448  # the most dynamic shared memory of an H100 block (227 KB)
BAR_BYTES = 128  # each slot's full and empty barriers (8 slots at most), at the front


class Design(NamedTuple):
    """The macros a library is built with (``-DK1_TEAM=..`` and so on)."""

    team: int = 8        # lanes per scenario
    spb: int = 4         # scenarios per block
    chunk: int = 4       # stages per chunk of the ring
    slots: int = 2       # the ring's most chunks
    smem_f32: int = 6656  # shared bytes per scenario in float (double: twice)

    def defines(self) -> tuple:
        return (f"K1_TEAM={self.team}", f"K1_SPB={self.spb}", f"K1_CHUNK={self.chunk}",
                f"K1_SLOTS={self.slots}", f"K1_SMEM_F32={self.smem_f32}")


DESIGN = Design()


class LaunchGeometry(NamedTuple):
    """A launch's shape: the lanes of a team, the scenarios of a block, the
    ring's chunk (stages) and slots, the block's dynamic shared bytes and the
    workspace's values per scenario (0: the tape in shared memory)."""

    team: int
    scenarios_per_block: int
    chunk: int
    slots: int
    shared_bytes: int
    workspace: int


def _round16(x: int) -> int:
    return (x + 15) & ~15


def _odd16(x: int) -> int:
    x = _round16(x)
    return x if (x // 16) % 2 else x + 16


def _scenario_bytes(N: int, es: int, C: int, S: int, tape_ws: bool) -> int:
    fixed = _round16(SCRATCH * es) + _round16(C * (NU + NX) * es)
    if not tape_ws:
        fixed += _round16(N * TAPE_STRIDE * es)
    chunk = sum(_round16(C * w * es) + 16 for w in WIDTHS)
    return _odd16(fixed) + S * _odd16(chunk)


def launch_geometry(N: int, dtype, design: Design = DESIGN) -> LaunchGeometry:
    """K1's launch shape at N stages in ``dtype`` (``make_geometry`` of the
    source, computed here without the library): within the budget per
    scenario, the chunk of ``design.chunk`` stages and the most slots up to
    ``design.slots`` with the tape in shared memory; then fewer slots (two at
    least); then the tape in the workspace; then half the chunk."""
    es = 8 if dtype == torch.float64 else 4
    budget = min(design.smem_f32 // 4 * es, (BLOCK_SMEM - BAR_BYTES) // design.spb)
    C = min(N, design.chunk)
    while True:
        nq = -(-N // C)
        s_hi = min(nq, design.slots)
        s_lo = min(s_hi, 2)
        for tape_ws in (False, True):
            for S in range(s_hi, s_lo - 1, -1):
                per = _scenario_bytes(N, es, C, S, tape_ws)
                if per <= budget or (C == 1 and tape_ws and S == s_lo):
                    return LaunchGeometry(design.team, design.spb, C, S,
                                          BAR_BYTES + design.spb * per,
                                          N * TAPE_STRIDE if tape_ws else 0)
        C = (C + 1) // 2


_lib = None
# the horizons at which ``bind`` holds a library's geometry to launch_geometry
GEOMETRY_CHECK_NS = (1, 2, 7, 30, 31, 96, 120, 257, 1000)


def library_path() -> Path:
    return nvcc_build.library_path(SOURCE)


def build() -> dict:
    """Compile the kernel if its library is missing (``nvcc_build``)."""
    return nvcc_build.build_library(SOURCE, library_path())


def bind(path) -> ctypes.CDLL:
    """Load a built K1 library, declare its C entry points and hold its
    design and launch geometry to this module's; ``lib.design`` is its
    ``Design``."""
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.riccati_sweep_f32, lib.riccati_sweep_f64):
        fn.argtypes = [ptr] * 16 + [i32, i32, i32, ptr]
        fn.restype = i32
    lib.riccati_sweep_tape_per_stage.argtypes = []
    lib.riccati_sweep_tape_per_stage.restype = i32
    ints = ctypes.POINTER(i32)
    lib.riccati_sweep_design.argtypes = [ints]
    lib.riccati_sweep_design.restype = None
    lib.riccati_sweep_launch_geometry.argtypes = [i32, i32, ints]
    lib.riccati_sweep_launch_geometry.restype = None
    lib.riccati_sweep_occupancy.argtypes = [i32, i32, ints]
    lib.riccati_sweep_occupancy.restype = i32
    lib.riccati_sweep_error_string.argtypes = [i32]
    lib.riccati_sweep_error_string.restype = ctypes.c_char_p
    if lib.riccati_sweep_tape_per_stage() != TAPE_STRIDE:
        raise RuntimeError(f"K1 library {path} does not match its wrapper")
    out = (i32 * 5)()
    lib.riccati_sweep_design(out)
    lib.design = Design(*out)
    for N in GEOMETRY_CHECK_NS:
        for dtype in (torch.float32, torch.float64):
            got, want = library_geometry(lib, N, dtype), launch_geometry(N, dtype, lib.design)
            if got != want:
                raise RuntimeError(
                    f"K1 library {path} has the geometry {got} at N={N}, {dtype}; "
                    f"its wrapper computes {want}"
                )
    return lib


def library_geometry(lib, N: int, dtype) -> LaunchGeometry:
    """``riccati_sweep_launch_geometry`` of a bound library."""
    out = (ctypes.c_int * 6)()
    lib.riccati_sweep_launch_geometry(N, int(dtype == torch.float64), out)
    return LaunchGeometry(*out)


def occupancy(lib, N: int, dtype) -> int:
    """The blocks per SM of the launch at N stages in ``dtype`` (the CUDA
    occupancy calculator at its shared bytes)."""
    blocks = ctypes.c_int()
    rc = lib.riccati_sweep_occupancy(N, int(dtype == torch.float64), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"K1 occupancy failed: {lib.riccati_sweep_error_string(rc).decode()}")
    return blocks.value


def _load():
    global _lib
    if _lib is None:
        build()
        _lib = bind(library_path())
    return _lib


def _check(args, shapes):
    dev, dtype = args[0].device, args[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K1 takes float32 or float64, got {dtype}")
    for name, a, shape in zip(_ARG_NAMES, args, shapes):
        if a.device != dev:
            raise ValueError(f"K1: {name} is on {a.device}, Fz on {dev}")
        if a.dtype != dtype:
            raise TypeError(f"K1: {name} is {a.dtype}, Fz is {dtype}")
        if not a.is_contiguous():
            raise ValueError(f"K1: {name} is not contiguous")
        if tuple(a.shape) != shape:
            raise ValueError(f"K1: {name} has shape {tuple(a.shape)}, expected {shape}")
        if a.data_ptr() % a.element_size():
            raise ValueError(f"K1: {name} does not start at a multiple of its element size")


_ARG_NAMES = ("Fz", "Gz", "rz", "Hzz", "Hzu", "Huu", "hz", "hu", "PN", "pN", "reg")


def _expected_shapes(B, N):
    return (
        (B, N, NA, NA), (B, N, NA, NU), (B, N, NA), (B, N, NA, NA), (B, N, NA, NU),
        (B, N, NU, NU), (B, N, NA), (B, N, NU), (B, NA, NA), (B, NA), (B,),
    )


def launch(lib, args, free_tau: bool, stream: int) -> LqrStep:
    """Allocate the step and the workspace the geometry names, on the inputs'
    device, and run ``lib`` on them on ``stream`` (checked arguments)."""
    Fz = args[0]
    B, N = Fz.shape[0], Fz.shape[1]
    opts = dict(dtype=Fz.dtype, device=Fz.device)
    geo = launch_geometry(N, Fz.dtype, lib.design)
    dxs = torch.empty((B, N + 1, NX), **opts)
    dus = torch.empty((B, N, NU), **opts)
    dtau = torch.empty((B,), **opts)
    dv = torch.empty((B,), **opts)
    blocks = -(-B // geo.scenarios_per_block)
    tape = torch.empty((blocks * geo.scenarios_per_block * geo.workspace,), **opts)
    fn = lib.riccati_sweep_f32 if Fz.dtype == torch.float32 else lib.riccati_sweep_f64
    rc = fn(
        *(a.data_ptr() for a in args),
        dxs.data_ptr(), dus.data_ptr(), dtau.data_ptr(), dv.data_ptr(),
        tape.data_ptr() if geo.workspace else None,
        B, N, int(free_tau), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"K1 launch failed: {lib.riccati_sweep_error_string(rc).decode()} ({rc})"
        )
    return LqrStep(dxs=dxs, dus=dus, dtau=dtau, dV=dv)


def lqr_solve_cuda(
    Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN, reg, *, nx: int, free_tau: bool
) -> LqrStep:
    """Launch K1 on CUDA tensors with one leading batch axis (reg is (B,))."""
    args = (Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN, reg)
    if Fz.dim() != 4 or Fz.shape[-1] != NA or Gz.shape[-1] != NU or nx != NX:
        raise ValueError(
            f"K1 takes na={NA}, nu={NU}, nx={NX} with one batch axis; got "
            f"Fz {tuple(Fz.shape)}, Gz {tuple(Gz.shape)}, nx={nx}"
        )
    if Fz.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {Fz.device}")
    B, N = Fz.shape[0], Fz.shape[1]
    if B == 0:
        raise ValueError("K1 needs a non-empty batch")
    _check(args, _expected_shapes(B, N))
    lib = _load()
    with torch.cuda.device(Fz.device):
        step = launch(lib, args, free_tau, torch.cuda.current_stream(Fz.device).cuda_stream)
    lqr_solve_cuda.launches += 1
    return step


lqr_solve_cuda.launches = 0


def lqr_solve_auto(
    Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN, reg, *, nx: int, free_tau: bool
) -> LqrStep:
    """The KKT solve of the SQP: K1 for CUDA tensors, the plain version for
    CPU tensors."""
    args = (Fz, Gz, rz, Hzz, Hzu, Huu, hz, hu, PN, pN, reg)
    devices = {a.device for a in args}
    if len(devices) != 1:
        raise ValueError(f"lqr_solve_auto: inputs on several devices {devices}")
    if Fz.device.type == "cpu":
        return lqr_solve(*args, nx=nx, free_tau=free_tau)
    return lqr_solve_cuda(*args, nx=nx, free_tau=free_tau)
