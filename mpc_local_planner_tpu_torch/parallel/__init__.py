"""Parallelism: device meshes, sharded and mixed-model ensemble solves, the
multi-process cluster (port of ``mpc_local_planner_tpu.parallel``).

Scenarios shard over the mesh's entries; the only collectives are the
ensemble reductions (``ensemble_summary``) over a ``torch.distributed``
process group.
"""

from mpc_local_planner_tpu_torch.parallel.sharding import (
    ensemble_summary,
    make_mesh,
    make_sharded_solver,
    shard_batch,
)

__all__ = ["make_mesh", "shard_batch", "make_sharded_solver", "ensemble_summary"]
