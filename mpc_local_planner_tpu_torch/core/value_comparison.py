"""Approximate-value comparison helpers (port of
``mpc_local_planner_tpu.core.value_comparison``).

Parity: cbr:core/value_comparison.h — approximate equality and zero tests
with absolute and relative tolerances. Elementwise on tensors of any shape.
"""

from __future__ import annotations

import torch

from mpc_local_planner_tpu_torch.core.tree import tree_map


def approx_equal(a, b, atol: float = 1e-6, rtol: float = 0.0):
    """|a − b| ≤ atol + rtol·|b| elementwise (parity: approx_equal)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.abs(a - b) <= atol + rtol * torch.abs(b)


def approx_zero(a, atol: float = 1e-6):
    return torch.abs(torch.as_tensor(a)) <= atol


def essentially_equal(a, b, rtol: float = 1e-6):
    """Knuth-style relative comparison (parity: essentially_equal)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return torch.abs(a - b) <= rtol * torch.minimum(torch.abs(a), torch.abs(b))


def all_close(tree_a, tree_b, atol: float = 1e-6) -> bool:
    """Closeness over every leaf of two containers of tensors (host-side)."""
    flags = []
    tree_map(lambda x, y: flags.append(bool(torch.all(approx_equal(x, y, atol)))) or x,
             tree_a, tree_b)
    return all(flags)
