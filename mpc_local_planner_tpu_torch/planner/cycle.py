"""Batched warm MPC cycle — the fleet steady-state step (port of
``mpc_local_planner_tpu.planner.cycle``).

Per-lane policy:
  converged lanes  → advance one stage (executed-control feedback), resample
                     the warm start, shift the stage duals (ρ restarts)
  sane-unconverged → CONTINUE from their current primal/duals
  diverged lanes   → reset fresh (NaN-safe: a non-finite eq_norm counts as
                     diverged, never as "sane")
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from mpc_local_planner_tpu_torch.core.tree import where_tree
from mpc_local_planner_tpu_torch.ocp.grid import initial_primal, warm_start_resample
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec
from mpc_local_planner_tpu_torch.solvers.al_sqp import (
    SolverSettings,
    make_solver,
    shift_duals,
)


def make_fleet_cycle(
    spec: OcpSpec,
    warm: SolverSettings,
    duals0,
    solve: Optional[Callable] = None,
    rescue: Optional[Callable] = None,
    fresh_init: Optional[Callable] = None,
    rho0_fail: float = 0.0,
    stuck_restart: int = 0,
    device=None,
):
    """Build ``cycle(scenario, result) -> (scenario, result)``.

    duals0: batched fresh duals (the diverged-lane reset state).
    solve: batched solve fn (default: ``make_solver(spec, warm, device)``).
    rescue: optional straggler pass ``rescue(scenario, result) -> result``.
    fresh_init: reset seed ``fresh_init(scenario) -> Primal`` (default: the
        straight-line seed).
    """
    if rho0_fail > 0 or stuck_restart > 0:
        raise NotImplementedError(
            "rho0_fail and stuck_restart are not ported yet (ROADMAP M10)"
        )
    if solve is None:
        solve = make_solver(spec, warm, device)
    if fresh_init is None:
        fresh_init = lambda s: initial_primal(spec, s)  # noqa: E731

    def cycle(scenario, r):
        # NaN-safe divergence test: `NaN > 0.5` is False, so a ">"-style
        # mask would silently continue blown-up lanes forever
        reset_mask = torch.logical_not((r.eq_norm <= 0.5) & (r.ineq_viol <= 0.5))
        ok = r.converged
        x0n = torch.where(ok[:, None], r.primal.xs[:, 1, :], scenario.x0)
        # executed-control feedback
        upn = torch.where(ok[:, None], r.primal.us[:, 0, :], scenario.u_prev)
        scenario = dataclasses.replace(scenario, x0=x0n, u_prev=upn)
        initn = where_tree(
            ok, warm_start_resample(r.primal, x0n, steps=1, spec=spec), r.primal
        )
        dn = where_tree(ok, shift_duals(r.duals, warm, steps=1), r.duals)
        initn = where_tree(reset_mask, fresh_init(scenario), initn)
        dn = where_tree(reset_mask, duals0, dn)
        r2 = solve(scenario, initn, dn)
        if rescue is not None:
            r2 = rescue(scenario, r2)
        return scenario, r2

    return cycle
