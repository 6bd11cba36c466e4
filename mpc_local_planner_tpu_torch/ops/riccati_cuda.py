"""Kernel K1: the batched Riccati sweep as a hand-written CUDA kernel.

Replaces the TPU kernel ``mpc_local_planner_tpu/ops/riccati_pallas.py ::
_riccati_kernel`` (launched by ``lqr_solve_pallas``). The source is
``csrc/riccati_sweep.cu``: one thread per scenario runs the backward sweep,
the 2×2 Quu inverse, the gain tape, the free-δτ stage and the forward
rollout, for float and double.

What bounds it on an H100 is memory: per scenario it reads 114 values per
stage plus PN, pN and reg, and writes the step — 59.3 MB for a float batch of
4096 at N=30, about 18 µs at 3.35 TB/s. The first design is one thread per
scenario because it is the simplest that is right; its loads are strided
(13.8 KB between neighbouring threads), so it runs far from that bound.

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

import torch

from mpc_local_planner_tpu_torch.ops import nvcc_build
from mpc_local_planner_tpu_torch.solvers.riccati import LqrStep, lqr_solve

SOURCE = nvcc_build.CSRC / "riccati_sweep.cu"
NA, NU, NX = 6, 2, 3

_lib = None


def library_path() -> Path:
    return nvcc_build.library_path(SOURCE)


def build() -> dict:
    """Compile the kernel if its library is missing (``nvcc_build``)."""
    return nvcc_build.build_library(SOURCE, library_path())


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(library_path()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.riccati_sweep_f32, lib.riccati_sweep_f64):
            fn.argtypes = [ptr] * 15 + [i32, i32, i32, ptr]
            fn.restype = i32
        lib.riccati_sweep_max_n.argtypes = []
        lib.riccati_sweep_max_n.restype = i32
        lib.riccati_sweep_error_string.argtypes = [i32]
        lib.riccati_sweep_error_string.restype = ctypes.c_char_p
        _lib = lib
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


_ARG_NAMES = ("Fz", "Gz", "rz", "Hzz", "Hzu", "Huu", "hz", "hu", "PN", "pN", "reg")


def _expected_shapes(B, N):
    return (
        (B, N, NA, NA), (B, N, NA, NU), (B, N, NA), (B, N, NA, NA), (B, N, NA, NU),
        (B, N, NU, NU), (B, N, NA), (B, N, NU), (B, NA, NA), (B, NA), (B,),
    )


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
    if N > lib.riccati_sweep_max_n():
        raise ValueError(f"K1 takes N <= {lib.riccati_sweep_max_n()}, got {N}")
    opts = dict(dtype=Fz.dtype, device=Fz.device)
    dxs = torch.empty((B, N + 1, NX), **opts)
    dus = torch.empty((B, N, NU), **opts)
    dtau = torch.empty((B,), **opts)
    dv = torch.empty((B,), **opts)
    fn = lib.riccati_sweep_f32 if Fz.dtype == torch.float32 else lib.riccati_sweep_f64
    with torch.cuda.device(Fz.device):
        stream = torch.cuda.current_stream(Fz.device).cuda_stream
        rc = fn(
            *(a.data_ptr() for a in args),
            dxs.data_ptr(), dus.data_ptr(), dtau.data_ptr(), dv.data_ptr(),
            B, N, int(free_tau), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"K1 launch failed: {lib.riccati_sweep_error_string(rc).decode()} ({rc})"
        )
    lqr_solve_cuda.launches += 1
    return LqrStep(dxs=dxs, dus=dus, dtau=dtau, dV=dv)


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
