"""Mixed-model scenario ensembles (port of
``mpc_local_planner_tpu.parallel.ensembles``; BASELINE config #5: "mixed
models").

Different robot models have different dynamics, so one batch cannot span
them: a mixed fleet is grouped by ``OcpSpec`` and each group is solved as
one batch of its own by ``make_solver`` (the fused kernel wherever
``fused_dispatch_ok`` admits the group).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from mpc_local_planner_tpu_torch.solvers.al_sqp import (
    SolverSettings,
    default_init,
    make_solver,
)


class MixedEnsembleSolver:
    """Solve scenario groups that differ in OcpSpec (model family, horizon…).

    groups: list of (spec, settings), one solver per entry, on ``device``
    (CUDA unless the caller passes ``"cpu"``).
    """

    def __init__(self, groups: Sequence[Tuple[object, SolverSettings]], device=None):
        self._groups = list(groups)
        self._solvers = [make_solver(spec, st, device) for spec, st in self._groups]

    @property
    def n_groups(self) -> int:
        return len(self._groups)

    def init_state(self, group: int, scenario, dtype=torch.float32):
        """(the straight-line primal, fresh duals) of a group's scenarios."""
        spec, st = self._groups[group]
        return default_init(spec, st, scenario, dtype=dtype)

    def solve_group(self, group: int, scenario, init, duals):
        return self._solvers[group](scenario, init, duals)

    def solve_all(self, scenarios: Sequence, inits: Sequence, duals: Sequence) -> List:
        """Launch every group's solve, then return the results (nothing is
        read back in between)."""
        return [
            self._solvers[g](scenarios[g], inits[g], duals[g]) for g in range(self.n_groups)
        ]

    def summary(self, results) -> Dict[str, float]:
        conv = torch.cat([r.converged.reshape(-1).cpu() for r in results])
        return {
            "n_scenarios": int(conv.numel()),
            "converged_frac": float(conv.double().mean()) if conv.numel() else 0.0,
        }
