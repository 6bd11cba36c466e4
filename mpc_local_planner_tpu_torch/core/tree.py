"""Select and map helpers over the port's containers.

The containers (``Primal``, ``DualState``, ``SolveResult``, ``Scenario``,
``ObstacleSet``, the controllers and the plant's state) are frozen
dataclasses of tensors, possibly nested. These
helpers walk them field by field, the way ``jax.tree_util.tree_map`` walks a
JAX pytree.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def leaf_numpy(a) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def is_static(field: dataclasses.Field) -> bool:
    """A field marked ``metadata=dict(static=True)`` holds configuration (a
    Python value), not a tensor leaf: the helpers here leave it as it is."""
    return bool(field.metadata.get("static"))


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over dataclasses / tuples of tensors (static
    fields are kept from ``tree``)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(
            tree,
            **{
                f.name: tree_map(
                    fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest)
                )
                for f in dataclasses.fields(tree)
                if not is_static(f)
            },
        )
    if isinstance(tree, tuple):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    raise TypeError(f"tree_map: unsupported leaf type {type(tree).__name__}")


def where_tree(mask, a, b):
    """Per-leaf ``torch.where(mask, a, b)`` with the mask broadcast over each
    leaf's trailing (non-batch) dims.

    mask: bool tensor of shape ``batch``; every leaf of ``a`` and ``b`` has
    shape ``batch + trailing``.
    """

    def one(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
        return torch.where(m, x, y)

    return tree_map(one, a, b)
