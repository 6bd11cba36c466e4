"""Multi-process bring-up (port of ``mpc_local_planner_tpu.parallel.distributed``).

Each process of a cluster owns its local devices; ``initialize`` joins it to
a ``torch.distributed`` process group, after which ``global_mesh`` spans
every process's devices ("dcn" = across processes, "ici" = the devices
within one) and ``ensemble_summary`` all-reduces over the group. Each
process feeds its contiguous slice of the global batch
(``process_local_batch``) to the sharded solver over its own mesh entries.

Usage (one call per process, before any collective)::

    from mpc_local_planner_tpu_torch.parallel import distributed
    distributed.initialize("host0:29500", num_processes=4, process_id=RANK)
    mesh = distributed.global_mesh()

Nothing tells a program of its cluster here: the coordinator's address, the
world size and the rank are arguments, or PyTorch's launcher variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``) where an argument is left unset.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from mpc_local_planner_tpu_torch.parallel.sharding import Mesh, _world

# seconds a rank waits for the others to join before it raises
INIT_TIMEOUT_S = 60.0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> str:
    """Join this process to the process group at ``coordinator``
    ("HOST:PORT", a ``tcp://`` rendezvous) as rank ``process_id`` of
    ``num_processes``; returns the backend, which it also prints.

    ``backend`` None: NCCL when each rank on this host has a card of its own
    (the ranks on a host are ``LOCAL_WORLD_SIZE``, else all of them), gloo on
    the CPU and when ranks share a card (NCCL refuses two ranks on one GPU).
    A rank that cannot join within ``INIT_TIMEOUT_S`` raises; it never runs
    alone.
    """
    dist = torch.distributed
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    num_processes = _env_int("WORLD_SIZE") if num_processes is None else num_processes
    process_id = _env_int("RANK") if process_id is None else process_id
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator, the number of processes and "
                         "this process's rank (arguments or MASTER_ADDR/WORLD_SIZE/RANK)")
    local_world = _env_int("LOCAL_WORLD_SIZE") or num_processes
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id % local_world if local_rank is None else local_rank
    if backend is None:
        own_card = torch.cuda.is_available() and local_world <= torch.cuda.device_count()
        backend = "nccl" if own_card else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S),
    )
    print(f"distributed: rank {process_id} of {num_processes}, backend {backend}", flush=True)
    return backend


def global_mesh(ici_axis_size: Optional[int] = None, local_devices=None) -> Mesh:
    """The ("dcn", "ici") mesh over every process's devices.

    ``local_devices``: this process's devices (default: every local CUDA
    card); every process is taken to have as many. "ici" spans
    ``ici_axis_size`` of them (default: all of one process's), "dcn" the
    rest, so rows are processes by default. Without an initialized group it
    is the 1×L mesh of this process.
    """
    if local_devices is None:
        local_devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not local_devices:
            raise RuntimeError("no CUDA device is available; pass local_devices=[...]")
    local_devices = list(local_devices)
    world, _ = _world()
    if ici_axis_size is None:
        ici_axis_size = len(local_devices)
    n = world * len(local_devices)
    if n % ici_axis_size:
        raise ValueError(f"{n} devices not divisible by ici={ici_axis_size}")
    ranks = [r for r in range(world) for _ in local_devices]
    return Mesh(local_devices * world, (n // ici_axis_size, ici_axis_size), ranks)


def process_local_batch(global_batch: int) -> slice:
    """This process's contiguous slice ``[rank·B/P, (rank+1)·B/P)`` of a global
    scenario batch sharded over ("dcn", "ici") row-major."""
    p, rank = _world()
    if global_batch % p:
        raise ValueError(f"global batch {global_batch} not divisible by {p} processes")
    per = global_batch // p
    return slice(rank * per, (rank + 1) * per)
