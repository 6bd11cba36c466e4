"""Closed-form small-matrix linear algebra and the hand-written CUDA kernels
(port of ``mpc_local_planner_tpu.ops``): K1 ``riccati_cuda`` and the fused
AL-SQP kernel ``fused_al_sqp_cuda``, each built at its first launch.
"""

from mpc_local_planner_tpu_torch.ops.smallmat import (
    inv2,
    inv3,
    solve2,
    solve3,
    solve_psd,
)

__all__ = ["inv2", "inv3", "solve2", "solve3", "solve_psd"]
