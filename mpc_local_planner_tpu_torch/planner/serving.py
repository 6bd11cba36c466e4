"""Rolling-journey serving runtime, the production control-loop component
(port of ``mpc_local_planner_tpu.planner.serving``).

The reference gets its production loop from move_base:
``src/mpc_local_planner_ros.cpp :: computeVelocityCommands`` is called at
``controller_frequency``, and a failure returns an error code that triggers
move_base's recovery behaviours and a replan. The batched equivalent is a
JOURNEY STREAM: E independent journeys (start → goal under an obstacle field)
advance through warm MPC cycles on the device; a journey retires when it
reaches its goal (the nav stack picks a new one) or after ``stuck_limit``
consecutive unconverged cycles (the abandon-and-replan analog of move_base's
recovery), and a retired lane draws a fresh journey, paying an early-exit
cold replant as a live system pays for a new goal.

Every solve of the stream is the un-fused batched ``solve`` (the serving
preset sets ``early_exit``, which the fused kernel does not take); on the
card its KKT solve is kernel K1. A cycle composes the shared fleet-cycle
body (``planner/cycle.py``) with the chained rescue; the cold replant runs
only on cycles where some lane retires, and a lane that does not retire
keeps its pre-replant result bit for bit. Cycle stats capture each abandoned
journey's scenario AT ABANDON TIME, so that an offline oracle can classify
whether the abandon was justified (``audit_abandoned``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from mpc_local_planner_tpu_torch.core.tree import tree_map, where_tree
from mpc_local_planner_tpu_torch.device import pin_matmul_precision, resolve_device
from mpc_local_planner_tpu_torch.ocp.grid import initial_primal
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec, Scenario
from mpc_local_planner_tpu_torch.solvers.al_sqp import (
    SolveResult,
    SolverSettings,
    _check_device,
    init_duals,
    solve,
)


@dataclasses.dataclass(frozen=True)
class StreamState:
    """Device-resident stream state (feeds the next cycle)."""

    scen: Scenario               # (E, ...) live journeys
    result: SolveResult          # last cycle's solve (the warm-start source)
    stuck: torch.Tensor          # (E,) int32 consecutive-unconverged counter
    generator: torch.Generator   # the redraws' random stream


class CycleStats(NamedTuple):
    """Per-cycle outputs (stacked along a new first axis by ``block_fn``)."""

    converged: torch.Tensor   # (E,) post-rescue convergence this cycle
    reached: torch.Tensor     # (E,) goal reached → retired
    abandoned: torch.Tensor   # (E,) stuck limit hit → retired unconverged
    abandoned_scen: Scenario  # (E, ...) the journey AT ABANDON TIME (x0 =
    #                           the stuck pose) where ``abandoned``; zeros
    #                           elsewhere: the offline false-abandon audit's data


@dataclasses.dataclass(frozen=True)
class StreamSettings:
    """Stream semantics.

    The goal tolerances mirror the controller's goal test
    (``MpcLocalPlannerROS::isGoalReached`` xy/yaw tolerances);
    ``stuck_limit`` is the abandon-and-replan threshold; ``chained_rescue``
    re-solves still-unconverged lanes once from their iterate (re-entering
    resets the regularization and line-search state; with early_exit the
    converged lanes freeze after one phase, so it costs mostly the
    stragglers' phases); ``cold_replant`` runs the early-exit cold solve on
    cycles where some lane retires.
    """

    goal_xy_tol: float = 0.2
    goal_yaw_tol: float = 0.2
    stuck_limit: int = 2
    chained_rescue: bool = True
    cold_replant: bool = True


class JourneyStream:
    """Rolling-journey serving loop over a fixed ensemble width E.

    ``redraw_fn(generator, E) -> Scenario`` draws fresh journeys on
    ``device`` (the bench passes ``benchmarks.random_ensemble``). ``warm``
    is the per-cycle budget (typically an early-exit serving preset);
    ``cold`` the (re)initialization budget, whose early-exit variant runs
    on redraw cycles. ``device``: CUDA unless the caller passes ``"cpu"``.
    """

    def __init__(
        self,
        spec: OcpSpec,
        warm: SolverSettings,
        cold: Optional[SolverSettings] = None,
        redraw_fn: Optional[Callable[[torch.Generator, int], Scenario]] = None,
        settings: StreamSettings = StreamSettings(),
        device=None,
    ):
        if redraw_fn is None:
            raise ValueError("JourneyStream needs a redraw_fn(generator, E) -> Scenario")
        self.spec = spec
        self.warm = warm
        self.cold = cold or SolverSettings.for_spec(spec)
        self.settings = settings
        self.device = resolve_device(device)
        pin_matmul_precision()
        self._redraw = redraw_fn
        self._warm_solve = self._solver(warm)
        self._cold_ee_solve = self._solver(dataclasses.replace(self.cold, early_exit=True))
        self._cold_solve = self._solver(self.cold)
        self._fleet_cycles = {}  # per-(E, dtype) composed warm-cycle bodies

    def _solver(self, settings):
        """The un-fused batched solve under ``settings`` on the stream's
        device (JAX ``vmap(solve_single)``): never the fused kernel."""
        spec, dev = self.spec, self.device

        def run(scenario, init, duals):
            _check_device(dev, scenario, init, duals)
            return solve(spec, settings, scenario, init, duals)

        return run

    def _fleet_cycle(self, E: int, dtype):
        """The shared advance/continue/reset body (``planner/cycle.py``)
        with the stream's chained rescue as its rescue hook."""
        key = (E, str(dtype))
        fn = self._fleet_cycles.get(key)
        if fn is None:
            from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle

            rescue = None
            if self.settings.chained_rescue:
                def rescue(s, r2):
                    # one chained re-solve; only still-unconverged lanes
                    # take its result, so a cycle that left none skips it
                    # (the result is the same bit for bit)
                    redo = torch.logical_not(r2.converged)
                    if not bool(redo.any()):
                        return r2
                    r3 = self._warm_solve(s, r2.primal, r2.duals)
                    return where_tree(redo, r3, r2)

            fn = make_fleet_cycle(
                self.spec, self.warm, self._duals0(E, dtype),
                solve=self._warm_solve, rescue=rescue, device=self.device,
            )
            self._fleet_cycles[key] = fn
        return fn

    # -- state bring-up ---------------------------------------------------- #
    def _duals0(self, E: int, dtype=torch.float32):
        return init_duals(self.spec, self.cold, dtype=dtype, device=self.device, batch=(E,))

    def init(self, E: int, generator: torch.Generator) -> StreamState:
        """Draw E journeys and cold-solve them (the full cold budget)."""
        scen = self._redraw(generator, E)
        result = self._cold_solve(
            scen, initial_primal(self.spec, scen), self._duals0(E, scen.x0.dtype)
        )
        return StreamState(
            scen=scen, result=result,
            stuck=torch.zeros((E,), dtype=torch.int32, device=self.device),
            generator=generator,
        )

    # -- one cycle ---------------------------------------------------------- #
    def cycle(self, state: StreamState) -> Tuple[StreamState, CycleStats]:
        spec, st = self.spec, self.settings
        E = state.scen.x0.shape[0]
        dtype = state.result.primal.xs.dtype
        duals0 = self._duals0(E, dtype)

        # warm-start policy: the SHARED fleet-cycle body (advance on
        # convergence with executed-control feedback, continue on
        # sane-unconverged, NaN-safe fresh reset on divergence) and the
        # stream's chained rescue
        s, r2 = self._fleet_cycle(E, dtype)(state.scen, state.result)

        conv_now = r2.converged
        # retirement decisions (the pre-redraw scenario is the audit record)
        dp = torch.linalg.norm(s.xf[:, :2] - s.x0[:, :2], dim=-1)
        da = torch.abs(
            torch.remainder(s.xf[:, 2] - s.x0[:, 2] + math.pi, 2 * math.pi) - math.pi
        )
        reached = (dp < st.goal_xy_tol) & (da < st.goal_yaw_tol)
        stuck = torch.where(conv_now, 0, state.stuck + 1).to(torch.int32)
        retire = reached | (stuck >= st.stuck_limit)
        gave_up = retire & ~reached
        # the abandoned journeys AT ABANDON TIME (x0 = the stuck pose)
        abandoned_scen = where_tree(gave_up, s, tree_map(torch.zeros_like, s))

        # a fresh draw every cycle, as the reference stream draws one
        fresh = self._redraw(state.generator, E)
        s = where_tree(retire, fresh, s)
        stuck = torch.where(retire, 0, stuck).to(torch.int32)

        if st.cold_replant and bool(retire.any()):
            # a serving system plans a fresh goal with the cold preset inside
            # its cycle (the reference's IPOPT does the same on goal
            # arrival): the early-exit cold solve, on cycles where some lane
            # retires only. Lanes that do not retire are fed their CURRENT
            # iterate, so they freeze after one phase, and the select below
            # returns their pre-replant result bit for bit.
            init_c = where_tree(retire, initial_primal(spec, s), r2.primal)
            duals_c = where_tree(retire, duals0, r2.duals)
            rc = self._cold_ee_solve(s, init_c, duals_c)
            r2 = where_tree(retire, rc, r2)

        new_state = StreamState(scen=s, result=r2, stuck=stuck, generator=state.generator)
        return new_state, CycleStats(
            converged=conv_now,
            reached=reached,
            abandoned=gave_up,
            abandoned_scen=abandoned_scen,
        )

    def sample_oracle(self, state: StreamState):
        """The sampled feasibility oracle: re-solve the CURRENT journeys cold
        at the generous budget from a fresh seed and return
        ``(feasible_mask, last_cycle_converged)``, so the caller can
        accumulate a serving-side conv_on_feasible over sampled cycles.
        Call BETWEEN timed blocks."""
        E = state.scen.x0.shape[0]
        r = self._cold_solve(
            state.scen, initial_primal(self.spec, state.scen),
            self._duals0(E, state.scen.x0.dtype),
        )
        return r.converged, state.result.converged

    # -- offline audit ------------------------------------------------------- #
    @staticmethod
    def collect_abandoned(stats: CycleStats):
        """Host-side: flatten a block's CycleStats (leading (cycles, E) axes)
        to the abandoned journeys' scenario rows, a Scenario of CPU tensors
        with leading axis n_abandoned. Returns (rows, n_abandoned)."""
        ab = stats.abandoned.reshape(-1).cpu()
        idx = torch.nonzero(ab).reshape(-1)

        def flat(a):
            a = a.cpu()
            # explicit leading dim: a trailing dim may be 0 (empty slot leaves)
            return a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:]))[idx]

        return tree_map(flat, stats.abandoned_scen), int(idx.numel())

    def audit_abandoned(self, rows, golden: bool = False, oracle: bool = True) -> dict:
        """False-abandon audit: classify every abandoned journey FROM ITS
        ABANDON STATE.

        ``oracle=True`` runs the generous cold-budget oracle on the captured
        scenarios on the stream's device; a journey the oracle solves from
        the stuck pose was abandoned while still solvable, a FALSE abandon.
        ``golden=True`` also runs the float64 golden classifier
        (``benchmarks.classify_feasibility`` on the CPU), whose feasibility
        denominator does not depend on the budget. Returns counts; host-side
        and slow: offline use.
        """
        n = int(rows.x0.shape[0])
        out = {"n_abandoned": n}
        if n == 0:
            out["false_abandon_oracle"] = 0
            return out
        if oracle:
            scen = tree_map(lambda a: a.to(self.device), rows)
            r = self._cold_solve(
                scen, initial_primal(self.spec, scen), self._duals0(n, scen.x0.dtype)
            )
            out["false_abandon_oracle"] = int(torch.sum(r.converged))
        if golden:
            from mpc_local_planner_tpu_torch.benchmarks import classify_feasibility

            labels, details = classify_feasibility(
                self.spec, tree_map(lambda a: a.cpu(), rows), max_instances=n, device="cpu"
            )
            out["false_abandon_golden"] = labels.count("feasible")
            out["golden_details"] = {
                k: v for k, v in details.items() if k != "per_instance"
            }
        return out

    # -- a block of cycles --------------------------------------------------- #
    def block_fn(self, n_cycles: int):
        """``run(state) -> (state, CycleStats stacked (n_cycles, E, ...))``:
        ``n_cycles`` cycles, one after the other."""

        def run(state: StreamState):
            stats = []
            for _ in range(n_cycles):
                state, s = self.cycle(state)
                stats.append(s)
            return state, tree_map(lambda *xs: torch.stack(xs), stats[0], *stats[1:])

        return run
