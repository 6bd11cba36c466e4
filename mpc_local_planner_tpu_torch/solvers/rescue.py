"""Straggler compaction: per-lane iteration-budget reallocation for batched
warm MPC cycles (port of ``mpc_local_planner_tpu.solvers.rescue``).

    result = warm_solve(scenario, init, duals)   # fixed budget, all B lanes
    result = rescue(scenario, result)            # extra budget, K << B slots

The rescue gathers the K slots' scenarios and iterates (unconverged lanes
first, in order), continues each straggler from its current primal/duals
(diverged lanes restart fresh), re-solves the compacted sub-batch and
scatters the results back. Everything is fixed-shape: no host round trip.
"""

from __future__ import annotations

from typing import Optional

import torch

from mpc_local_planner_tpu_torch.core.tree import tree_map, where_tree
from mpc_local_planner_tpu_torch.ocp.grid import initial_primal
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec
from mpc_local_planner_tpu_torch.solvers.al_sqp import (
    SolveResult,
    SolverSettings,
    init_duals,
    make_solver,
)


def _take(tree, idx):
    return tree_map(lambda a: a.index_select(0, idx), tree)


def _scatter(tree_dst, tree_src, idx, mask):
    """dst[idx[i]] <- src[i] where mask[i] (fixed-shape)."""

    def one(dst, src):
        m = mask.reshape(mask.shape + (1,) * (src.dim() - mask.dim()))
        upd = torch.where(m, src, dst.index_select(0, idx))
        return dst.index_copy(0, idx, upd)

    return tree_map(one, tree_dst, tree_src)


def make_rescue(
    spec: OcpSpec,
    settings: SolverSettings,
    slots: int,
    rescue_settings: Optional[SolverSettings] = None,
    divergence_threshold: float = 0.5,
    fresh_init=None,
    device=None,
):
    """Build rescue(scenario, result) -> SolveResult.

    slots: compacted sub-batch size. rescue_settings defaults to
    ``settings``. fresh_init(scenario_k, idx) -> Primal optionally overrides
    the restart seed for DIVERGED slots (default: the straight-line seed).
    """
    rs = rescue_settings or settings
    solve = make_solver(spec, rs, device)

    def rescue(scenario, result: SolveResult) -> SolveResult:
        unconv = torch.logical_not(result.converged)
        B = unconv.shape[0]
        k = min(slots, B)  # a slot budget beyond the batch is just the batch
        dev = unconv.device
        # stable compaction permutation via two cumsums: stragglers keep
        # their relative order in slots 0..k-1, converged lanes fill the rest
        ui = unconv.long()
        n_unc = ui.sum()
        pos = torch.where(
            unconv, torch.cumsum(ui, 0) - 1, n_unc + torch.cumsum(1 - ui, 0) - 1
        )
        order = torch.empty((B,), dtype=torch.long, device=dev)
        order[pos] = torch.arange(B, device=dev)
        idx = order[:k]
        live = unconv.index_select(0, idx)

        scen_k = _take(scenario, idx)
        primal_k = _take(result.primal, idx)
        duals_k = _take(result.duals, idx)
        ev = result.eq_norm.index_select(0, idx)
        iv = result.ineq_viol.index_select(0, idx)
        # NaN-safe (NaN norms count as diverged); the finite check covers the
        # whole iterate — us/dt can go NaN while xs stays finite
        finite = (
            torch.isfinite(primal_k.xs).flatten(1).all(dim=1)
            & torch.isfinite(primal_k.us).flatten(1).all(dim=1)
            & torch.isfinite(primal_k.dt)
        )
        diverged = torch.logical_not(
            (ev <= divergence_threshold) & (iv <= divergence_threshold) & finite
        )
        fresh_p = (
            initial_primal(spec, scen_k) if fresh_init is None else fresh_init(scen_k, idx)
        )
        fresh_d = init_duals(spec, rs, dtype=primal_k.xs.dtype, device=dev, batch=(k,))
        init_k = where_tree(diverged, fresh_p, primal_k)
        din_k = where_tree(diverged, fresh_d, duals_k)

        out_k = solve(scen_k, init_k, din_k)

        # rescued lanes take the new iterate unconditionally (they were
        # unconverged; the next cycle's divergence reset still guards it)
        return SolveResult(
            primal=_scatter(result.primal, out_k.primal, idx, live),
            duals=_scatter(result.duals, out_k.duals, idx, live),
            cost=_scatter(result.cost, out_k.cost, idx, live),
            eq_norm=_scatter(result.eq_norm, out_k.eq_norm, idx, live),
            ineq_viol=_scatter(result.ineq_viol, out_k.ineq_viol, idx, live),
            converged=_scatter(result.converged, out_k.converged, idx, live),
        )

    return rescue
