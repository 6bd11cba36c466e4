"""How far two batched solves of one problem agree: a kernel against its
plain version, or one solve path against another. ``chip_smoke.py`` and the
card tests hold the kernels to these checks.

- ``gate``: bench.py's kernel-vs-reference gate, for float32 — conv flags
  agree on 99.5% of the lanes, a quarter of the lanes converged on both,
  and max |Δxs| on those within a tolerance set by the iteration budget.
- ``f64_agreement``: float64, lane by lane. Two versions of the same math in
  another order agree to rounding where the iterates are well conditioned.
  Where they are not (a lane that does not converge, steering far outside
  its box), rounding grows over the iterations. So every lane is held
  against the plain version's own sensitivity to rounding: the plain
  version run again from states one unit in the last place above and below
  (``ulp_perturbed``). A fault in the kernel (a wrong dual update, snapshot
  or selection) moves a lane far more than that. A lane whose sensitivity
  exceeds CHAOTIC has no answer to hold the kernel to (one ulp of input
  moves the plain version itself that far); such lanes are counted, and a
  check at a short prefix of the schedule, before any lane gets there,
  asks for none (``every_lane``).
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_local_planner_tpu_torch.ocp.grid import Primal

F64_RTOL = 1e-8  # on the lanes both versions converged
F64_LANE_FRAC = 0.995  # of those lanes, within F64_RTOL
# every lane: err(kernel, plain) <= ULP_FACTOR * max err(plain', plain) + ULP_FLOOR
ULP_FACTOR = 100.0
ULP_FLOOR = 1e-12
CHAOTIC = 1e-6  # sensitivity beyond which a lane's answer is undetermined


def _leaves(r):
    duals = [getattr(r.duals, f.name) for f in dataclasses.fields(r.duals)]
    return [r.primal.xs, r.primal.us, r.primal.dt] + duals


def lane_rel_err(a, b) -> torch.Tensor:
    """Per lane, max |a − b| / max(|b|, 1) over xs, us, dt and the duals of
    two ``SolveResult``s (float64, one value per lane)."""
    err = torch.zeros_like(b.primal.dt, dtype=torch.float64)
    for x, y in zip(_leaves(a), _leaves(b)):
        x, y = x.double().reshape(x.shape[0], -1), y.double().reshape(y.shape[0], -1)
        if y.shape[1]:
            rel = torch.abs(x - y) / torch.clamp(torch.abs(y), min=1.0)
            err = torch.maximum(err, rel.amax(dim=1))
    return err


def ulp_perturbed(init: Primal) -> tuple[Primal, Primal]:
    """The initial primal with its states moved by one unit in the last
    place, up and down. The controls stay: a control on its box bound is an
    exact tie of the AL hinge (weight ρ/4), and moving it off the tie changes
    the step by far more than rounding does."""
    eps = torch.finfo(init.xs.dtype).eps
    return tuple(dataclasses.replace(init, xs=init.xs * (1.0 + s * eps)) for s in (1.0, -1.0))


def gate(out_k, out_p, iters: int):
    """bench.py's gate on two solve results of ``iters`` SQP iterations:
    (info, passed)."""
    agree = float(torch.mean((out_k.converged == out_p.converged).float()))
    both = out_k.converged & out_p.converged
    diff = torch.where(both[:, None, None], torch.abs(out_k.primal.xs - out_p.primal.xs), 0.0)
    info = {
        "conv_agree_frac": agree,
        "converged_lanes_compared": int(torch.sum(both)),
        "max_dxs_on_converged": float(torch.max(diff)),
        "dxs_tol": 5e-3 if iters <= 6 else (5e-2 if iters <= 12 else 1e-1),
    }
    passed = (
        agree >= 0.995
        and info["converged_lanes_compared"] >= len(both) // 4
        and info["max_dxs_on_converged"] <= info["dxs_tol"]
    )
    return info, passed


def f64_agreement(out_k, out_p, outs_q, min_converged_frac: float = 0.25,
                  every_lane: bool = False):
    """Float64 agreement of ``out_k`` with ``out_p`` on the same inputs;
    ``outs_q`` are the plain version from the ``ulp_perturbed`` inputs, and
    a lane's rounding sensitivity is the larger of their errors. Passes when
    the conv flags are identical on every lane, at least
    ``min_converged_frac`` of the lanes converged on both, F64_LANE_FRAC of
    those lanes are within F64_RTOL, and on every lane whose sensitivity is
    at most CHAOTIC the kernel's error is at most ULP_FACTOR times that
    sensitivity plus ULP_FLOOR; ``every_lane`` also asks that no lane be
    beyond CHAOTIC. Returns (info, passed, per-lane errors, per-lane
    sensitivities)."""
    err = lane_rel_err(out_k, out_p)
    sens = torch.stack([lane_rel_err(q, out_p) for q in outs_q]).amax(dim=0)
    both = out_k.converged & out_p.converged
    n, n_both = len(err), int(torch.sum(both))
    beyond = err > F64_RTOL
    within = 1.0 - int(torch.sum(beyond & both)) / max(n_both, 1)
    chaotic = sens > CHAOTIC
    over = (err > ULP_FACTOR * sens + ULP_FLOOR) & ~chaotic
    info = {
        "conv_identical": bool(torch.equal(out_k.converged, out_p.converged)),
        "converged": n_both,
        "lanes": n,
        "within_frac_converged": within,
        "max_err_converged": float(torch.max(torch.where(both, err, 0.0))),
        "beyond_rtol": int(torch.sum(beyond)),
        "beyond_rtol_sensitivity": int(torch.sum(sens > F64_RTOL)),
        "max_err": float(torch.max(err)),
        "max_sensitivity": float(torch.max(sens)),
        "max_err_over_sensitivity": float(torch.max(torch.where(
            chaotic, 0.0, err / (sens + ULP_FLOOR)))),
        "lanes_over_ulp_bound": int(torch.sum(over)),
        "lanes_chaotic": int(torch.sum(chaotic)),
    }
    passed = (
        info["conv_identical"]
        and n_both >= min_converged_frac * n
        and within >= F64_LANE_FRAC
        and info["lanes_over_ulp_bound"] == 0
        and not (every_lane and info["lanes_chaotic"])
    )
    return info, passed, err, sens
