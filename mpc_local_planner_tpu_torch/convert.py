"""Carry state between numpy arrays and the port's containers.

``from_numpy(cls, tree, device)`` builds a ``Scenario``, ``ObstacleSet``,
``Primal``, ``DualState`` or ``SolveResult`` from a mapping (or any object
with the same attribute names) whose leaves are array-likes;
``to_numpy(obj)`` returns the nested dict of numpy arrays. Field names,
shapes and dtypes are the JAX package's, so a JAX object handed over through
``np.asarray`` round-trips.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.solvers.al_sqp import DualState, SolveResult

# container fields that hold another container
_NESTED = {
    Scenario: {"obstacles": ObstacleSet},
    SolveResult: {"primal": Primal, "duals": DualState},
}


def _field(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def from_numpy(cls, tree, device):
    """Build ``cls`` from array leaves; dtypes are kept."""
    nested = _NESTED.get(cls, {})
    kwargs = {}
    for f in dataclasses.fields(cls):
        leaf = _field(tree, f.name)
        if f.name in nested:
            kwargs[f.name] = from_numpy(nested[f.name], leaf, device)
        else:
            arr = np.array(leaf)  # a writable copy: torch refuses read-only buffers
            kwargs[f.name] = torch.from_numpy(arr).to(device)
    return cls(**kwargs)


def to_numpy(obj) -> dict:
    """Nested dict of numpy arrays with the container's field names."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = to_numpy(v) if dataclasses.is_dataclass(v) else v.detach().cpu().numpy()
    return out
