"""How far two batched solves of one problem agree: a kernel against its
plain version, or one solve path against another. ``chip_smoke.py`` and the
card tests hold the kernels to these checks.

- ``gate``: bench.py's kernel-vs-reference gate, for float32 — conv flags
  agree on 99.5% of the lanes, a quarter of the lanes converged on both,
  and max |Δxs| on those within a tolerance set by the iteration budget.
- ``f64_agreement``: float64, lane by lane. Two versions of the same math in
  another order agree to rounding where the iterates are well conditioned:
  99.5% of the lanes both converged are within F64_RTOL. Where they are not
  (a lane that does not converge, steering far outside its box), rounding
  grows over the iterations. So every lane is held against the plain
  version's own sensitivity to rounding: the plain version run again from
  states one unit in the last place above and below (``ulp_perturbed``),
  and with one unit in the last place on every entry of each iteration's
  KKT inputs (``kkt_roundings``: the kernel forms those inputs in another
  order, and where the Riccati sweep is ill-conditioned it amplifies their
  rounding far more than that of the states). A
  fault in the kernel (a wrong dual update, snapshot or selection) moves a
  lane far more than that. A lane whose sensitivity exceeds CHAOTIC has no
  answer to hold the kernel to (one ulp of input moves the plain version
  itself that far); such lanes are counted and left out, but for a check at
  the first prefix of the schedule (``every_lane``: one SQP iteration from
  the same inputs), which holds every lane: a lane there is held to
  ULP_FACTOR times its sensitivity but no more than EVERY_LANE_CAP, and a
  chaotic lane to the larger of EVERY_LANE_CAP and SPREAD_FACTOR times the
  largest move of the plain version under SPREAD_PATTERNS sign patterns of
  KKT-input rounding (``spread_runs``): a lane that one ulp moves by 2e-2
  after one iteration cannot be held to 1e-4, and is held to the spread of
  the rounding measured on it. Two rounding runs can miss a lane's chaos:
  at any prefix a lane over its bound is measured again under the
  SPREAD_PATTERNS patterns on that lane alone (``lane_spread``), and if
  the plain version's largest move there passes CHAOTIC the lane is
  chaotic, held to SPREAD_FACTOR times that move (on the card, lane 332 of
  the Crank–Nicolson flagship at 3×4: the kernel 3.3e3 away, the two runs
  6.8e-7, four of the 32 patterns 396-3290, the kernel built without
  FMA 8e-8); a check that finds more than RESPREAD_MAX_LANES such lanes
  fails.

  Three comparisons of the solver are decided by rounding. Near a
  solution the line search picks among candidates whose merits differ by a
  few ulps (the merit is flat to second order there), and the growth test
  compares violations that are the rounding of converged defects. And
  anywhere, a candidate's dt that lands within a few ulps of its bound is
  clipped onto it or not as the last ulp of the step falls (on the card an
  FMA put such a dt exactly on dt_min where the plain version lands four
  ulps above it); on the bound its dt-box row sits exactly at zero, which
  weighs it ρ/4 (the hinge's subgradient), and just inside at 0, so the
  next step differs. Two versions that sum in another order may take such
  a tie either way, and states one ulp apart need not flip it. So the plain
  version also runs with every near-tie taken the other way
  (``tie_breaks``: once toward the first candidate, growth and a dt on its
  bound, once toward the last candidate, no growth and a dt just inside).
  A lane that this moves has a tie shown: it is held to ULP_FACTOR times the
  larger of its two sensitivities (ρ left to the next rule) and its ρ to
  within one growth factor; a converged one is counted apart from the
  F64_RTOL share.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.solvers.al_sqp import Decisions

F64_RTOL = 1e-8  # on the lanes both versions converged with no tie shown
F64_LANE_FRAC = 0.995  # of those lanes, within F64_RTOL
# every lane: err(kernel, plain) <= ULP_FACTOR * max err(plain', plain) + ULP_FLOOR
ULP_FACTOR = 100.0
ULP_FLOOR = 1e-12
CHAOTIC = 1e-6  # sensitivity beyond which a lane's answer is undetermined
# every_lane: no lane's bound exceeds that of a lane at sensitivity CHAOTIC,
# but a chaotic lane's, which is SPREAD_FACTOR times its largest move under
# SPREAD_PATTERNS KKT-rounding patterns where that is larger (on the card
# the kernel's error on a lane beyond 1e-8 at the first two prefixes was at
# most 0.71 of that move)
EVERY_LANE_CAP = 1e-4  # ULP_FACTOR * CHAOTIC
SPREAD_PATTERNS = 32
SPREAD_FACTOR = 2.0
# lanes of one check that the second measurement (``lane_spread``) may show
# chaotic: more fail the check, so that a fault in the kernel cannot pass as
# chaos spread over many lanes (on an H100 one lane in 174 checks)
RESPREAD_MAX_LANES = 4
# near-ties: candidate merits within TIE_RTOL · max(|least|, 1) of the least
# (the merit sums about 25 rows over 30 stages; summed in another order its
# rounding is a few ulps, 1e-14 relative); growth-test violations within
# VIOL_TIE of the bound (rounding of defects of states a few metres large,
# eps 2.2e-16); a candidate's dt within TIE_RTOL · bound of a bound it is
# not on
TIE_RTOL = 1e-12
VIOL_TIE = 1e-13


class TieBreak(Decisions):
    """The solver's decisions with every near-tie taken one way: ``first``
    picks the first candidate (the largest α) among those within TIE_RTOL of
    the least merit, grows ρ when the growth test is within VIOL_TIE of its
    bound and puts a candidate's dt near a bound on it; otherwise the last
    candidate (α = 0 is last), no growth and such a dt one ulp inside."""

    def __init__(self, first: bool):
        self.first = first

    def pick(self, merits):
        least = torch.amin(merits, dim=0)
        tol = TIE_RTOL * torch.clamp(torch.abs(least), min=1.0)
        near = (merits <= least + tol) & torch.isfinite(merits)
        n = merits.shape[0]
        idx = torch.arange(n, device=merits.device)[:, None].expand_as(merits)
        if self.first:
            return torch.amin(torch.where(near, idx, n), dim=0)
        return torch.amax(torch.where(near, idx, -1), dim=0)

    def stalled(self, viol, bound):
        tie = torch.abs(viol - bound) <= VIOL_TIE
        return (viol > bound) | tie if self.first else (viol > bound) & ~tie

    def clip_dt(self, dt, lo, hi):
        out = super().clip_dt(dt, lo, hi)
        if lo == hi:  # a fixed dt has no row to tie
            return out
        for bound, inward in ((lo, math.inf), (hi, -math.inf)):
            b = torch.full_like(dt, bound)
            near = (dt != b) & (torch.abs(dt - b) <= TIE_RTOL * abs(bound))
            if self.first:
                out = torch.where(near, b, out)
            else:
                out = torch.where(near & (out == b), torch.nextafter(b, torch.full_like(b, inward)),
                                  out)
        return out


def tie_breaks():
    """The two ``TieBreak`` rules the plain version runs under for
    ``f64_agreement``'s ``outs_t``."""
    return TieBreak(first=True), TieBreak(first=False)


def _rel_errs(a, b) -> torch.Tensor:
    """(leaves, lanes): per lane, max |a − b| / max(|b|, 1) of each of xs,
    us, dt and the duals of two ``SolveResult``s, ρ last (float64)."""
    leaves = lambda r: [r.primal.xs, r.primal.us, r.primal.dt] + [  # noqa: E731
        getattr(r.duals, f.name) for f in dataclasses.fields(r.duals)
    ]
    rows = []
    for x, y in zip(leaves(a), leaves(b)):
        x, y = x.double().reshape(x.shape[0], -1), y.double().reshape(y.shape[0], -1)
        rel = torch.abs(x - y) / torch.clamp(torch.abs(y), min=1.0)
        rows.append(rel.amax(dim=1) if y.shape[1] else rel.new_zeros(y.shape[0]))
    return torch.stack(rows)


def ulp_perturbed(init: Primal) -> tuple[Primal, Primal]:
    """The initial primal with its states moved by one unit in the last
    place, up and down. The controls stay: a control on its box bound is an
    exact tie of the AL hinge (weight ρ/4), and moving it off the tie changes
    the step by far more than rounding does."""
    eps = torch.finfo(init.xs.dtype).eps
    return tuple(dataclasses.replace(init, xs=init.xs * (1.0 + s * eps)) for s in (1.0, -1.0))


class KktRounding:
    """Every entry of one SQP iteration's KKT inputs moved by one unit in the
    last place, up or down by a sign pattern drawn from ``seed``: the
    rounding by which two versions that form those inputs in another order
    differ."""

    def __init__(self, seed: int):
        self.seed = seed

    def __call__(self, kkt):
        gen = torch.Generator(device=kkt[0].device).manual_seed(self.seed)
        out = []
        for a in kkt:
            sign = torch.randint(0, 2, a.shape, generator=gen, device=a.device).to(a.dtype)
            out.append(a * (1.0 + (2.0 * sign - 1.0) * torch.finfo(a.dtype).eps))
        return tuple(out)


def kkt_roundings():
    """The two ``KktRounding`` patterns the plain version runs under for
    ``f64_agreement``'s ``outs_r``."""
    return KktRounding(0), KktRounding(1)


def spread_runs(plain, init: Primal):
    """The plain version under the KKT-rounding patterns beyond the two of
    ``kkt_roundings``, SPREAD_PATTERNS in all: ``f64_agreement``'s
    ``outs_spread`` at the first prefix."""
    return [plain(init, kkt_rounding=KktRounding(seed)) for seed in range(2, SPREAD_PATTERNS)]


def lane_spread(plain, scenario, init: Primal, duals):
    """``f64_agreement``'s ``respread``: ``respread(lanes)`` runs
    ``plain(scenario, init, duals, kkt_rounding=...)`` on those lanes alone
    under the SPREAD_PATTERNS KKT-rounding patterns."""
    def respread(lanes):
        sub = lambda t: tree_map(lambda a: a[lanes], t)  # noqa: E731
        s, i, d = sub(scenario), sub(init), sub(duals)
        return [plain(s, i, d, kkt_rounding=KktRounding(seed)) for seed in range(SPREAD_PATTERNS)]

    return respread


def plain_runs(plain, init: Primal):
    """The plain version's runs that ``f64_agreement`` holds a kernel's lane
    against, from ``plain(init, decisions=None, kkt_rounding=None)``: from
    the ``ulp_perturbed`` states, under the ``kkt_roundings`` and under the
    ``tie_breaks``. Returns (outs_q, outs_r, outs_t)."""
    return (
        [plain(q) for q in ulp_perturbed(init)],
        [plain(init, kkt_rounding=r) for r in kkt_roundings()],
        [plain(init, decisions=d) for d in tie_breaks()],
    )


def gate(out_k, out_p, iters: int, min_converged_frac: float = 0.25):
    """bench.py's gate on two solve results of ``iters`` SQP iterations,
    with at least ``min_converged_frac`` of the lanes converged on both:
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
        and info["converged_lanes_compared"] >= min_converged_frac * len(both)
        and info["max_dxs_on_converged"] <= info["dxs_tol"]
    )
    return info, passed


def f64_agreement(out_k, out_p, outs_q, outs_t, rho_growth: float,
                  min_converged_frac: float = 0.25, every_lane: bool = False, outs_r=(),
                  outs_spread=(), respread=None):
    """Float64 agreement of ``out_k`` with ``out_p`` on the same inputs;
    ``outs_q`` are the plain version from the ``ulp_perturbed`` inputs,
    ``outs_r`` under the ``kkt_roundings`` and ``outs_t`` under the
    ``tie_breaks`` rules (``plain_runs``). A lane's one-ulp sensitivity is
    the plain version's largest move under ``outs_q`` and ``outs_r``.
    Passes when the conv flags are
    identical on every lane; at least ``min_converged_frac`` of the lanes
    converged on both; F64_LANE_FRAC of those with no tie shown are within
    F64_RTOL; on every lane whose one-ulp sensitivity is at most CHAOTIC the
    kernel's error is at most ULP_FACTOR times that sensitivity plus
    ULP_FLOOR, or, on a lane with a tie shown, at most ULP_FACTOR times the
    larger of the one-ulp and the tie sensitivity plus ULP_FLOOR with ρ
    within one growth factor (a tie shown: the tie runs move the lane);
    with ``every_lane`` none is left out: no lane's bound exceeds
    EVERY_LANE_CAP, but a lane beyond CHAOTIC is held
    to SPREAD_FACTOR times its largest move under ``outs_q``, ``outs_r``
    and ``outs_spread`` (``spread_runs``) where that is larger. A lane over
    its bound is measured again with ``respread(lanes)`` (``lane_spread``),
    where given: if the plain version's largest move there passes CHAOTIC,
    the lane is chaotic and held to SPREAD_FACTOR times that move; more
    than RESPREAD_MAX_LANES such lanes fail the check. A NaN
    error fails its lane. Returns (info,
    passed, per-lane errors, per-lane one-ulp sensitivities)."""
    both = out_k.converged & out_p.converged
    errs = _rel_errs(out_k, out_p)
    err, err_v = errs.amax(dim=0), errs[:-1].amax(dim=0)  # with and without ρ
    moves = lambda outs: torch.stack([_rel_errs(q, out_p).amax(dim=0) for q in outs])  # noqa: E731
    sens = (torch.cat([moves(outs_q), moves(outs_r)]) if outs_r else moves(outs_q)).amax(dim=0)
    spread = torch.maximum(sens, moves(outs_spread).amax(dim=0)) if outs_spread else sens
    sens_tie = torch.stack([_rel_errs(t, out_p)[:-1].amax(dim=0) for t in outs_t]).amax(dim=0)
    chaotic = sens > CHAOTIC
    tied = sens_tie > 0.0
    untied = both & ~tied
    rho_steps = torch.abs(torch.log(out_k.duals.rho.double() / out_p.duals.rho.double()))
    rho_steps = rho_steps / math.log(rho_growth)
    ref = torch.where(tied, torch.maximum(sens, sens_tie), sens)
    bound = ULP_FACTOR * ref + ULP_FLOOR
    if every_lane:
        bound = torch.clamp(bound, max=EVERY_LANE_CAP)
        chaotic_bound = SPREAD_FACTOR * torch.maximum(spread, ref)
        bound = torch.where(chaotic, torch.clamp(chaotic_bound, min=EVERY_LANE_CAP), bound)
    within = torch.where(tied, (err_v <= bound) & (rho_steps <= 1.0 + 1e-9), err <= bound)
    held = ~chaotic | every_lane
    over = ~within & held
    respread_lanes = torch.zeros_like(chaotic)
    if respread is not None and bool(over.any()):
        lanes = torch.nonzero(over).flatten()
        sub = tree_map(lambda a: a[lanes], out_p)
        move = torch.stack([_rel_errs(q, sub).amax(dim=0) for q in respread(lanes)]).amax(dim=0)
        respread_lanes[lanes] = move > CHAOTIC
        spread = spread.clone()
        spread[lanes] = torch.maximum(spread[lanes], move)
        bound = torch.where(respread_lanes,
                            torch.maximum(bound, SPREAD_FACTOR * torch.maximum(spread, ref)), bound)
        within = torch.where(respread_lanes, err <= bound, within)
        chaotic = chaotic | respread_lanes
        over = ~within & held
    n, n_both, n_untied = len(err), int(torch.sum(both)), int(torch.sum(untied))
    beyond = ~(err <= F64_RTOL)
    frac = 1.0 - int(torch.sum(untied & beyond)) / max(n_untied, 1)
    ratio = torch.where(tied, err_v, err) / (ref + ULP_FLOOR)
    info = {
        "conv_identical": bool(torch.equal(out_k.converged, out_p.converged)),
        "converged": n_both,
        "lanes": n,
        "within_frac_converged": frac,
        "max_err_converged": float(torch.max(torch.where(untied, err, 0.0))),
        "converged_tied": int(torch.sum(both & tied)),
        "tied_beyond_rtol": int(torch.sum(tied & ~(err_v <= F64_RTOL))),
        "max_err_tied": float(torch.max(torch.where(tied, err_v, 0.0))),
        "tied_rho_differs": int(torch.sum(tied & (rho_steps > 0.0))),
        "beyond_rtol": int(torch.sum(beyond)),
        "beyond_rtol_sensitivity": int(torch.sum(sens > F64_RTOL)),
        "max_err": float(torch.max(err)),
        "max_sensitivity": float(torch.max(sens)),
        "max_err_over_sensitivity": float(torch.max(torch.where(held, ratio, 0.0))),
        "lanes_over_ulp_bound": int(torch.sum(over)),
        "lanes_chaotic": int(torch.sum(chaotic)),
        "max_chaotic_err_over_spread": float(torch.max(torch.where(chaotic, err / spread, 0.0))),
        "lanes_chaotic_by_respread": int(torch.sum(respread_lanes)),
    }
    passed = (
        info["conv_identical"]
        and n_both >= min_converged_frac * n
        and frac >= F64_LANE_FRAC
        and info["lanes_over_ulp_bound"] == 0
        and info["lanes_chaotic_by_respread"] <= RESPREAD_MAX_LANES
    )
    return info, passed, err, sens
