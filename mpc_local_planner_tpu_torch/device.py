"""Device selection, the f32 matmul precision pin, and cached constants.

Entry points run on CUDA unless the caller asks for the CPU; they never move
to the CPU on their own.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA card; raises when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pin_matmul_precision() -> None:
    """Full-f32 matmuls: TF32 keeps ~10 mantissa bits, too few to drive the
    Riccati recursion and the AL penalties to the 1e-4 feasibility
    tolerances (the JAX solver pins float32 matmul precision for the same
    reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@functools.lru_cache(maxsize=512)
def _const_cached(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A small constant tensor on ``like``'s device (cached: a host-to-device
    copy from pageable memory synchronizes the stream, so the solve loop must
    not make one per call)."""
    if isinstance(values, torch.Tensor):
        values = values.tolist()
    return _const_cached(
        tuple(values), like.dtype if dtype is None else dtype, like.device
    )
