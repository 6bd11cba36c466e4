"""Device meshes and sharded batched solves (port of
``mpc_local_planner_tpu.parallel.sharding``).

The scenario ensemble is the data-parallel axis. A mesh is a 2-D array of
devices with the axis names ("dcn", "ici"): rows are DCN groups (processes
of a cluster), columns the devices within one. The leading lane axis of a
batch is split into contiguous blocks in the mesh's row-major order, one
block per entry, each on its entry's device (``shard_batch``). An entry may
repeat a device, so several shards can share one card (or the one CPU
device, which stands in for JAX's virtual CPU devices in the tests).

Per-scenario solves never communicate: the sharded solver runs ``make_solver``
(and, with ``rescue_slots``, ``make_rescue``) on each block alone, so a
shard's rescue compacts only its own stragglers, and the result stays
sharded. The only collectives are the ensemble reductions of
``ensemble_summary``, which all-reduce each shard's partials over an
initialized ``torch.distributed`` process group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings, make_solver


def _world() -> Tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A ("dcn", "ici") array of ``torch.device``; ``ranks`` gives the process
    that owns each entry (all 0 for a single-process mesh)."""

    axis_names = ("dcn", "ici")

    def __init__(self, devices: Sequence, shape: Tuple[int, int], ranks=None):
        arr = np.empty(len(devices), dtype=object)
        arr[:] = [torch.device(d) for d in devices]
        self.devices = arr.reshape(shape)
        self.ranks = (np.zeros(shape, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(shape))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def local_devices(self) -> list:
        """The entries this process owns, in row-major order."""
        return [d for d, r in zip(self.devices.ravel(), self.ranks.ravel()) if r == _world()[1]]


def make_mesh(n_dcn: int = 1, n_ici: Optional[int] = None, devices=None) -> Mesh:
    """Build a ("dcn", "ici") mesh over ``devices`` (default: every local CUDA
    card; raises without one). A list may repeat a device."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device is available; pass devices=[...] (e.g. cpu)")
    devices = list(devices)
    if n_ici is None:
        n_ici = len(devices) // n_dcn
    if n_dcn * n_ici != len(devices):
        raise ValueError(f"mesh {n_dcn}x{n_ici} != {len(devices)} devices")
    return Mesh(devices, (n_dcn, n_ici))


def batch_spec() -> Tuple[str, str]:
    """The mesh axes the leading lane axis is split over, outermost first."""
    return ("dcn", "ici")


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    """A tree split along its leading lane axis: ``blocks[i]`` is the
    contiguous block on ``devices[i]`` (the mesh's local entries in row-major
    order)."""

    devices: Tuple[torch.device, ...]
    blocks: Tuple[Any, ...]


def shard_batch(tree, mesh: Mesh) -> ShardedBatch:
    """Split ``tree`` (leaves with a leading lane axis) into one contiguous
    block per local mesh entry, each moved to its entry's device. The lane
    count must divide evenly."""
    devices = tuple(mesh.local_devices())
    lanes = {a.shape[0] for a in _leaves(tree)}
    if len(lanes) != 1:
        raise ValueError(f"leaves disagree on the lane count: {sorted(lanes)}")
    (batch,) = lanes
    if batch % len(devices):
        raise ValueError(f"batch {batch} not divisible by {len(devices)} shards")
    per = batch // len(devices)
    blocks = tuple(
        tree_map(lambda a, i=i, d=d: a[i * per:(i + 1) * per].to(d).contiguous(), tree)
        for i, d in enumerate(devices)
    )
    return ShardedBatch(devices, blocks)


def gather(sharded: ShardedBatch, device=None):
    """The blocks concatenated along the lane axis on ``device`` (default the
    first block's): an explicit copy, for comparisons."""
    dev = sharded.devices[0] if device is None else torch.device(device)
    return tree_map(lambda *a: torch.cat([x.to(dev) for x in a], dim=0), *sharded.blocks)


def _leaves(tree) -> list:
    out = []
    tree_map(lambda a: out.append(a) or a, tree)
    return out


def make_sharded_solver(
    spec,
    settings: Optional[SolverSettings] = None,
    mesh: Optional[Mesh] = None,
    rescue_slots: int = 0,
    rescue_settings: Optional[SolverSettings] = None,
    device=None,
):
    """solve(scenario, init, duals) over a scenario batch.

    Without ``mesh`` it is ``make_solver`` on ``device`` (CUDA unless the
    caller passes ``"cpu"``) followed by ``make_rescue`` with
    ``rescue_slots`` over the whole batch. With a mesh the inputs are
    ``ShardedBatch``es of that mesh (plain trees are sharded first), each
    block is solved alone on its device (the fused kernel wherever
    ``fused_dispatch_ok`` admits) and, with ``rescue_slots`` > 0, rescued
    alone with ``rescue_slots`` slots: compaction never crosses a block. All
    blocks are launched before any result is read, and the result is a
    ``ShardedBatch`` (``gather`` copies it together).
    """
    settings = settings or SolverSettings.for_spec(spec)

    def pipeline(dev):
        solve = make_solver(spec, settings, dev)
        rescue = None
        if rescue_slots > 0:
            from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

            rescue = make_rescue(spec, settings, rescue_slots,
                                 rescue_settings=rescue_settings, device=dev)

        def run(scenario, init, duals):
            out = solve(scenario, init, duals)
            return out if rescue is None else rescue(scenario, out)

        return run

    if mesh is None:
        return pipeline(device)

    per_device = {d: pipeline(d) for d in dict.fromkeys(mesh.local_devices())}

    def solve_sharded(scenario, init, duals):
        args = [a if isinstance(a, ShardedBatch) else shard_batch(a, mesh)
                for a in (scenario, init, duals)]
        devices = args[0].devices
        blocks = tuple(per_device[d](*(a.blocks[i] for a in args))
                       for i, d in enumerate(devices))
        return ShardedBatch(devices, blocks)

    return solve_sharded


class EnsembleSummary(NamedTuple):
    n_converged: int
    mean_cost: float
    max_eq_norm: float
    max_ineq_viol: float


def ensemble_summary(result, group=None) -> EnsembleSummary:
    """Global ensemble statistics of a solve: the count converged, the mean
    cost, the largest eq_norm and the largest ineq_viol over every lane.

    ``result``: a ``SolveResult`` or a ``ShardedBatch`` of them. Each block
    gives its partials (the count converged, its lane count and its cost
    sum, in float64, and its two maxima); under an initialized process group
    they are all-reduced over ``group`` (SUM and MAX). The mean is the global
    cost sum over the global lane count, never a mean of means.
    """
    blocks = result.blocks if isinstance(result, ShardedBatch) else (result,)
    dist = torch.distributed
    reduce = dist.is_available() and dist.is_initialized()
    dev = torch.device("cpu")
    if reduce and dist.get_backend(group) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    n_lanes = sum(r.converged.numel() for r in blocks)
    sums = torch.tensor([0.0, float(n_lanes), 0.0], dtype=torch.float64, device=dev)
    maxs = torch.full((2,), -torch.inf, dtype=torch.float64, device=dev)
    for r in blocks:
        sums += torch.stack([
            r.converged.sum().double(), r.cost.new_zeros((), dtype=torch.float64),
            r.cost.double().sum()]).to(dev)
        maxs = torch.maximum(maxs, torch.stack([
            r.eq_norm.double().max(), r.ineq_viol.double().max()]).to(dev))
    if reduce:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(maxs, op=dist.ReduceOp.MAX, group=group)
    n_conv, n_lanes, cost_sum = sums.tolist()
    max_eq, max_viol = maxs.tolist()
    return EnsembleSummary(int(n_conv), cost_sum / n_lanes, max_eq, max_viol)
