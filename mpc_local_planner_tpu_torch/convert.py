"""Carry state between numpy arrays and the port's containers.

``from_numpy(cls, tree, device)`` builds a ``Scenario``, ``ObstacleSet``,
``Primal``, ``DualState`` or ``SolveResult``, a plant's ``PlantState``, a
``PidState`` or a controller (``LqrController``, ``SimpleStateController``,
``PidController``, ``DualModeController``: its gains and references) from a
mapping (or any object with the same attribute names) whose leaves are
array-likes; ``to_numpy(obj)`` returns the nested dict of numpy arrays.
Field names, shapes and dtypes are the JAX package's, so a JAX object handed
over through ``np.asarray`` round-trips. A static field (configuration: a
controller's ``se2_state``, a limit, a radius) is copied as a Python value.

``controller_state_to_numpy(controller)`` and
``controller_state_from_numpy(controller, state)`` carry a Controller's warm
state (primal, duals, last goal, ok and diverged flags, stuck counter, steps
since the last reinitialization and the live horizon N) the same way; the
reading side takes any object with the Controller's attribute names, so a
JAX Controller's state hands over to the port.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from mpc_local_planner_tpu_torch.controllers.dual_mode import DualModeController
from mpc_local_planner_tpu_torch.controllers.lqr import LqrController
from mpc_local_planner_tpu_torch.core.tree import is_static, leaf_numpy
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.solvers.al_sqp import DualState, SolveResult

# a Controller's warm state: the key of the numpy form, its attribute
_CONTROLLER_LEAVES = {
    "last_goal": "_last_goal",
    "last_ok": "_last_ok",
    "last_diverged": "_last_diverged",
    "stuck": "_stuck",
}

# container fields that hold another container
_NESTED = {
    Scenario: {"obstacles": ObstacleSet},
    SolveResult: {"primal": Primal, "duals": DualState},
    DualModeController: {"lqr": LqrController},
}


def _static(value):
    """A static field's value as a Python scalar (a JAX leaf may be a 0-d
    array)."""
    return value.item() if hasattr(value, "item") else value


def _field(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def from_numpy(cls, tree, device):
    """Build ``cls`` from array leaves; dtypes are kept."""
    nested = _NESTED.get(cls, {})
    kwargs = {}
    for f in dataclasses.fields(cls):
        leaf = _field(tree, f.name)
        if is_static(f):
            kwargs[f.name] = _static(leaf)
        elif f.name in nested:
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
        if is_static(f):
            out[f.name] = v
        else:
            out[f.name] = to_numpy(v) if dataclasses.is_dataclass(v) else v.detach().cpu().numpy()
    return out


def _tree_numpy(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return leaf_numpy(obj)


def controller_state_to_numpy(controller) -> dict:
    """A Controller's warm state as numpy arrays (None where it has none)."""
    state = {
        "primal": None if controller._primal is None else _tree_numpy(controller._primal),
        "duals": None if controller._duals is None else _tree_numpy(controller._duals),
        "steps_since_reinit": int(controller._steps_since_reinit),
        "N": int(controller._spec.N),
    }
    for key, attr in _CONTROLLER_LEAVES.items():
        v = getattr(controller, attr)
        state[key] = None if v is None else leaf_numpy(v)
    return state


def controller_state_from_numpy(controller, state: Mapping) -> None:
    """Set the port Controller ``controller``'s warm state from
    ``controller_state_to_numpy``'s form, on its device."""
    dev = controller.device

    def tensor(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(dev)

    controller._primal = None if state["primal"] is None else from_numpy(
        Primal, state["primal"], dev)
    controller._duals = None if state["duals"] is None else from_numpy(
        DualState, state["duals"], dev)
    for key, attr in _CONTROLLER_LEAVES.items():
        setattr(controller, attr, tensor(state[key]))
    controller._steps_since_reinit = int(state["steps_since_reinit"])
    controller._spec = dataclasses.replace(controller.spec, N=int(state["N"]))
