"""The float64 tier for persistent stragglers (port of
``mpc_local_planner_tpu.solvers.f64_fallback``).

IPOPT runs every solve in double precision, which is why it certifies nearly
every feasible instance given the budget. The fleet pipeline runs float32;
the lanes it (and the rescue) leaves unconverged re-solve in float64 at the
cold depth, and are merged back where the float64 solve converged. The JAX
package ships the chunks to the host CPU (the TPU has no float64); here the
float64 solve runs on the device the tier is given (CUDA unless the caller
asks for the CPU): the un-fused solve, whose KKT solve is kernel K1 in
double on the card.

Chunks are padded to ``slots`` lanes by repeating the chunk's first
straggler; only the chunk's own lanes are merged back.
"""

from __future__ import annotations

import torch

from mpc_local_planner_tpu_torch.core.tree import tree_map, where_tree
from mpc_local_planner_tpu_torch.device import resolve_device
from mpc_local_planner_tpu_torch.ocp.grid import initial_primal
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec
from mpc_local_planner_tpu_torch.solvers.al_sqp import (
    SolveResult,
    SolverSettings,
    init_duals,
    make_solver,
)


def _to(tree, dtype, device):
    return tree_map(
        lambda a: a.to(device=device, dtype=dtype) if a.is_floating_point() else a.to(device),
        tree,
    )


def make_f64_fallback(spec: OcpSpec, settings: SolverSettings, slots: int,
                      divergence_threshold: float = 0.5, device=None):
    """Build ``fallback(scenario, result, fresh_primal=None) -> SolveResult``.

    slots: the straggler chunk size; every straggler is taken, in
    ⌈n/slots⌉ chunks. settings: the float64 budget, typically the cold
    preset with ``early_exit=True`` and the pipeline's tolerance, so that a
    merged ``converged`` flag means what the flags it replaces mean.

    The tier takes every lane whose ``converged`` flag is false, whatever
    its violation. Two attempts per chunk: lanes whose float32 iterate is
    finite with eq_norm and ineq_viol ≤ ``divergence_threshold`` first
    continue from it in float64 (the rest start fresh at once); what the
    continuation leaves unconverged re-solves from the fresh seed,
    ``fresh_primal`` (a full-batch plan-seeded init) or the straight-line
    seed. A lane that neither attempt converges keeps its float32 result
    untouched.
    """
    if slots <= 0:
        raise ValueError(f"slots must be positive, got {slots}")
    dev = resolve_device(device)
    solve64 = make_solver(spec, settings, dev)

    def fallback(scenario, result: SolveResult, fresh_primal=None) -> SolveResult:
        conv = result.converged
        idx_all = torch.nonzero(~conv).flatten()
        if idx_all.numel() == 0:
            return result
        k = int(min(slots, conv.shape[0]))
        merged = result
        for start in range(0, idx_all.numel(), k):
            chunk = idx_all[start : start + k]
            pad = torch.full((k,), int(chunk[0]), dtype=torch.long, device=conv.device)
            pad[: chunk.numel()] = chunk

            def take(t):
                return _to(tree_map(lambda a: a.index_select(0, pad), t), torch.float64, dev)

            p = take(result.primal)
            finite = (
                torch.isfinite(p.xs).flatten(1).all(dim=1)
                & torch.isfinite(p.us).flatten(1).all(dim=1)
                & torch.isfinite(p.dt).reshape(k, -1).all(dim=1)
            )
            thr = divergence_threshold
            # NaN-safe: a NaN norm compares False, so it is not sane
            sane = finite & (take(result.eq_norm) <= thr) & (take(result.ineq_viol) <= thr)
            scen_k = take(scenario)
            fresh_p = (initial_primal(spec, scen_k) if fresh_primal is None
                       else take(fresh_primal))
            fresh_d = init_duals(spec, settings, dtype=torch.float64, device=dev, batch=(k,))
            out = solve64(scen_k, where_tree(sane, p, fresh_p),
                          where_tree(sane, take(result.duals), fresh_d))
            # second attempt: a basin-trapped straggler stays trapped under
            # continuation; a fresh solve from the seed may certify it
            if bool((~out.converged & sane).any()):
                out2 = solve64(scen_k, fresh_p, fresh_d)
                out = where_tree(~out.converged & out2.converged, out2, out)
            n = chunk.numel()
            keep = out.converged[:n].to(conv.device)
            if not bool(keep.any()):
                continue

            def scat(dst, src):
                src = src[:n].to(device=dst.device, dtype=dst.dtype)
                m = keep.reshape(keep.shape + (1,) * (src.dim() - 1))
                return dst.index_copy(0, chunk, torch.where(m, src, dst.index_select(0, chunk)))

            merged = tree_map(scat, merged, out)
        return merged

    return fallback
