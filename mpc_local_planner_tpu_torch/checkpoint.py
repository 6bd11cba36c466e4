"""Solver-state checkpoint and resume (port of
``mpc_local_planner_tpu.checkpoint``).

A Controller's warm-start state (primal, duals, the last goal and the per
lane ok and diverged flags) is saved to an ``.npz`` in the JAX package's
layout: ``primal_0..2`` are (xs, us, dt), ``duals_i`` the ``DualState``
fields in their order, then ``last_goal``, ``last_ok`` and
``last_diverged``, each in the JAX Controller's shapes (an unbatched
Controller keeps no lane axis in either package). So a snapshot taken by
either package loads into the other. Nothing else is saved, as in JAX:
the reinitialization counter, the stuck counter and the live horizon stay
out. Float leaves round-trip bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mpc_local_planner_tpu_torch.core.tree import leaf_numpy
from mpc_local_planner_tpu_torch.device import resolve_device
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.solvers.al_sqp import DualState


def _flatten(prefix: str, tree) -> dict:
    return {f"{prefix}{i}": leaf_numpy(getattr(tree, f.name))
            for i, f in enumerate(dataclasses.fields(tree))}


def _unflatten(cls, prefix: str, data, device):
    return cls(**{f.name: torch.from_numpy(np.array(data[f"{prefix}{i}"])).to(device)
                  for i, f in enumerate(dataclasses.fields(cls))})


def save_controller_state(path: str, controller) -> None:
    """Snapshot a Controller's warm-start state to an .npz file."""
    arrays = {}
    if controller._primal is not None:
        arrays.update(_flatten("primal_", controller._primal))
        arrays.update(_flatten("duals_", controller._duals))
        arrays["last_goal"] = leaf_numpy(controller._last_goal)
        if controller._last_ok is not None:
            arrays["last_ok"] = leaf_numpy(controller._last_ok)
            arrays["last_diverged"] = leaf_numpy(controller._last_diverged)
    np.savez_compressed(path, **arrays)


def load_controller_state(path: str, controller) -> bool:
    """Restore warm-start state saved by ``save_controller_state`` (of either
    package) onto the Controller's device.

    Returns False (and leaves the controller reset) for an empty snapshot.
    The spec and batch must match the ones the snapshot was taken with.
    """
    dev = controller.device

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    with np.load(path) as data:
        if "primal_0" not in data:
            controller.reset()
            return False
        controller._primal = _unflatten(Primal, "primal_", data, dev)
        controller._duals = _unflatten(DualState, "duals_", data, dev)
        controller._last_goal = tensor(data["last_goal"])
        if "last_ok" in data:
            controller._last_ok = tensor(data["last_ok"])
            controller._last_diverged = tensor(data["last_diverged"])
    return True


def save_solve_state(path: str, primal: Primal, duals: Optional[DualState] = None) -> None:
    """Standalone primal/dual snapshot (batched solver workflows)."""
    arrays = _flatten("primal_", primal)
    if duals is not None:
        arrays.update(_flatten("duals_", duals))
    np.savez_compressed(path, **arrays)


def load_solve_state(path: str, duals_template: Optional[DualState] = None, device=None):
    """(primal, duals) saved by ``save_solve_state``, on ``device`` (CUDA
    unless the caller passes ``"cpu"``). The duals are read when a template
    is given (any ``DualState``: the layout is fixed) and the snapshot has
    them, else None."""
    dev = resolve_device(device)
    with np.load(path) as data:
        primal = _unflatten(Primal, "primal_", data, dev)
        duals = None
        if duals_template is not None and "duals_0" in data:
            duals = _unflatten(DualState, "duals_", data, dev)
    return primal, duals
