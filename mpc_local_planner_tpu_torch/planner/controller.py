"""MPC controller: configure / step / warm-start orchestration (port of
``mpc_local_planner_tpu.planner.controller``).

Parity: src/controller.cpp :: Controller (configure, step, the
force-reinit-on-new-goal policy) and cbr PredictiveController::step.

The Controller keeps its warm state (primal and duals per scenario) on its
device and re-anchors and shifts it each cycle. A batched Controller sends
its al_sqp solves through ``make_solver``: the warm solve, the straggler
rescue and the polish run as one launch each of the fused kernel wherever
``fused_dispatch_ok`` admits them, and the cold solve takes the un-fused
path, whose KKT solve is kernel K1. An unbatched Controller runs the
un-fused ``solve`` on one lane (K1 at B=1), as the JAX Controller runs plain
``solve_single``; it never launches the fused kernel. Each horizon N the
grid adaptation reaches gets callables of its own, cached by (N, warm).
Solver failures invalidate the warm start per lane.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from mpc_local_planner_tpu_torch.core.so2 import angle_diff
from mpc_local_planner_tpu_torch.core.time_series import TimeSeries, TimeSeriesSE2
from mpc_local_planner_tpu_torch.core.tree import where_tree
from mpc_local_planner_tpu_torch.device import const, pin_matmul_precision, resolve_device
from mpc_local_planner_tpu_torch.ocp.grid import (
    Primal,
    adapt_grid_nonuniform,
    adapt_grid_size,
    initial_primal,
    primal_from_plan,
    resize_duals,
    resize_primal,
    warm_start_resample,
    warm_start_shift,
)
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.planner.config import PlannerConfig
from mpc_local_planner_tpu_torch.solvers.al_sqp import (
    SolveResult,
    SolverSettings,
    _check_device,
    add_lane,
    drop_lane,
    init_duals,
    make_solver,
    shift_duals,
    solve,
)


@dataclasses.dataclass
class ControlResult:
    """Per-cycle output (parity: OptimalControlResult msg + cmd_vel twist).

    twist: (..., 3) = (vx, vy, omega) from getTwistFromControl(u0).
    """

    u0: torch.Tensor
    twist: torch.Tensor
    x_seq: TimeSeriesSE2
    u_seq: TimeSeries
    solve: SolveResult


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Controller:
    """Host-side orchestration around the batched solve.

    ``batch``: None for one robot (the scenario and the state carry no lane
    axis), else the number of lanes. ``device``: CUDA unless the caller
    passes ``"cpu"``; every tensor handed to ``step`` lies there.
    """

    def __init__(self, config: PlannerConfig, batch: Optional[int] = None,
                 dtype=torch.float32, device=None):
        self.config = config
        self.spec = config.to_ocp_spec()
        # solver backend dispatch (parity: the reference's solver plugin
        # choice — ipopt vs levenberg_marquardt_dense)
        if config.solver.type == "al_sqp":
            self._solve_lanes = solve
        elif config.solver.type == "lsq_lm":
            from mpc_local_planner_tpu_torch.solvers.lsq_lm import solve_single_lm

            self._solve_lanes = solve_single_lm
        else:
            raise ValueError(
                f"unknown solver.type {config.solver.type!r}; "
                "options: al_sqp, lsq_lm"
            )
        if config.solver.f64_fallback_slots > 0 and config.solver.type != "al_sqp":
            raise ValueError(
                "solver.f64_fallback_slots requires solver.type: al_sqp "
                "(the f64 escalation re-solves with the AL-SQP pipeline and "
                "continues from its dual structure)"
            )
        self.device = resolve_device(device)
        pin_matmul_precision()
        self.settings = config.solver_settings(self.spec)
        # warm-started cycles use a small iteration budget (parity: the
        # reference relies on warm starts + IPOPT iteration caps to hit the
        # control cycle)
        self.warm_settings = config.warm_solver_settings(self.spec)
        # max_cycle_ms calibration state (see calibrate_cycle_budget):
        # _warm_nal_cfg remembers the CONFIGURED warm cap so repeated
        # calibrations re-derive from it, not from an already-capped value
        self._phase_ms: Optional[float] = None
        self._warm_nal_cfg = self.warm_settings.n_al
        self.batch = batch          # None = unbatched single-robot mode
        self.dtype = dtype
        self._primal: Optional[Primal] = None
        self._duals = None
        self._last_goal: Optional[torch.Tensor] = None
        self._last_ok = None
        self._last_diverged = None
        self._stuck = None  # per-lane consecutive-failure counter
        self._steps_since_reinit = 0
        # grid adaptation (parity: grid.variable_grid.grid_adaptation.*): the
        # live spec tracks the current horizon N; each distinct N gets its
        # own cached solve callables
        self._spec = self.spec
        self._cache = {}
        self._f64_cache = {}  # per-N float64 fallback
        g = config.grid
        self._adapt = bool(g.grid_adaptation_enable)
        if self._adapt and batch is not None:
            raise ValueError(
                "grid_adaptation.enable is single-robot only: N is a "
                "compile-time shape shared by the whole batch, but adaptation "
                "is driven by each scenario's optimized dt"
            )
        if self._adapt and self.spec.nonuniform_dt and (
            g.grid_adaptation_mode != "redundant_controls"
        ):
            raise ValueError(
                "time-based grid_adaptation modes require grid.type: fd_grid "
                "— they steer one shared dt toward dt_ref (parity: "
                "FiniteDifferencesVariableGridSE2 is uniform-dt); for "
                "non_uniform_fd_grid use grid_adaptation.mode: "
                "redundant_controls"
            )
        if self._adapt and not self.spec.nonuniform_dt and (
            g.grid_adaptation_mode == "redundant_controls"
        ):
            raise ValueError(
                "grid_adaptation.mode: redundant_controls requires "
                "grid.type: non_uniform_fd_grid (it edits per-stage dt; "
                "parity: cbr NonUniformFiniteDifferencesVariableGrid)"
            )
        if self._adapt and not self.spec.variable_dt:
            raise ValueError(
                "grid_adaptation.enable requires variable_grid.enable: "
                "adaptation steers the optimized dt toward dt_ref by resizing "
                "N, which is meaningless with a fixed dt"
            )
        if self._adapt and not (
            g.grid_adaptation_min_grid_size
            <= self.spec.N
            <= g.grid_adaptation_max_grid_size
        ):
            raise ValueError(
                f"grid_size_ref={self.spec.N} outside grid_adaptation bounds "
                f"[{g.grid_adaptation_min_grid_size}, "
                f"{g.grid_adaptation_max_grid_size}]"
            )

    def _batched_al_sqp(self) -> bool:
        return self.batch is not None and self._solve_lanes is solve

    def _lanes_fn(self, spec, settings, pol=0, pol_settings=None):
        """solve(scenario, init, duals) on the Controller's own layout: the
        solver on the lanes as given (batched) or on one added lane
        (unbatched), each of ``pol`` polish passes kept where it converged."""
        solve_lanes, dev = self._solve_lanes, self.device

        def run(scenario, init, duals):
            _check_device(dev, scenario, init, duals)
            r = solve_lanes(spec, settings, scenario, init, duals)
            for _k in range(pol):
                r2 = solve_lanes(spec, pol_settings, scenario, r.primal, r.duals)
                r = where_tree(r2.converged, r2, r)
            return r

        if self.batch is not None:
            return run
        return lambda scenario, init, duals: drop_lane(
            run(add_lane(scenario), add_lane(init), add_lane(duals))
        )

    def _solver_fn(self, warm: bool):
        """The solve of the *current* spec (cached per (N, warm))."""
        settings = self.warm_settings if warm else self.settings
        if settings == self.settings:
            warm = False  # share the cache slot when the budgets coincide
        key = (self._spec.N, warm)
        fn = self._cache.get(key)
        if fn is None:
            spec = self._spec
            # post-solve polish (solver.polish_launches): al_sqp warm cycles
            # only — lsq_lm's soft-penalty iterate has no switch-stage
            # sharpening to gain, and the cold schedule already sits past
            # the warm budget's accuracy floor
            pol = (
                self.config.solver.polish_launches
                if self._solve_lanes is solve and warm
                else 0
            )
            pol_settings = self.warm_settings
            if self._batched_al_sqp():
                # batched al_sqp: through make_solver, so the fused kernel
                # takes every solve fused_dispatch_ok admits
                base = make_solver(spec, settings, self.device)
                slots = min(self.config.solver.rescue_slots, self.batch)
                rescue = None
                # rescue only on warm-budget cycles: its 4x4 continue budget
                # is sized for warm stragglers
                if slots > 0 and warm:
                    from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

                    rescue = make_rescue(
                        spec, settings, slots,
                        rescue_settings=self.config.solver.rescue_settings(settings),
                        device=self.device,
                    )
                pol_solve = (
                    base
                    if pol == 0 or settings == pol_settings
                    else make_solver(spec, pol_settings, self.device)
                )

                def fn(scenario, init, duals):
                    r = base(scenario, init, duals)
                    if rescue is not None:
                        r = rescue(scenario, r)
                    for _k in range(pol):
                        r2 = pol_solve(scenario, r.primal, r.duals)
                        # keep the polish only on lanes it left converged
                        # (monotone: a polish pass can never un-converge)
                        r = where_tree(r2.converged, r2, r)
                    return r
            else:
                fn = self._lanes_fn(spec, settings, pol, pol_settings)
            self._cache[key] = fn
        return fn

    def _f64_pass(self, scenario, result, fresh_seed=None):
        """Double-precision fallback (solver.f64_fallback_slots), on the
        Controller's device.

        Judges convergence at the WARM tolerance with the cold depth as a
        converge-or-exhausted cap, so a merged ``converged`` flag means
        exactly what the flags it replaces mean. The preset is the family's
        cold preset, as the JAX Controller builds it: the config's rho0 and
        rho_growth overrides do not reach it.
        """
        from mpc_local_planner_tpu_torch.solvers.f64_fallback import make_f64_fallback

        fb = self._f64_cache.get(self._spec.N)
        if fb is None:
            # depth = at least the family cold preset, regardless of how
            # shallow the configured cycle budget is (IPOPT semantics: the
            # escalation runs to convergence, not to the cycle cap)
            preset = SolverSettings.for_spec(self._spec)
            s = dataclasses.replace(
                preset,
                n_al=max(self.settings.n_al, preset.n_al),
                n_sqp=max(self.settings.n_sqp, preset.n_sqp),
                early_exit=True,
                tol_eq=self.warm_settings.tol_eq,
                tol_ineq=self.warm_settings.tol_ineq,
            )
            fb = make_f64_fallback(
                self._spec, s, self.config.solver.f64_fallback_slots, device=self.device
            )
            self._f64_cache[self._spec.N] = fb
        if self.batch is None:
            return drop_lane(fb(add_lane(scenario), add_lane(result), add_lane(fresh_seed)))
        return fb(scenario, result, fresh_seed)

    def calibrate_cycle_budget(self, scenario, phase_ms: Optional[float] = None) -> float:
        """Calibrate the wall-clock cycle budget (solver.max_cycle_ms).

        Parity: `solver.ipopt.max_cpu_time`, enforced at AL-PHASE
        granularity: this measures the wall time of one warm AL phase (an
        n_al=1 warm-budget solve on the prototype scenario, on the path the
        cycles run, the device synchronized around each run: the least of 3
        timed runs after one warm-up run) unless ``phase_ms`` is given, then
        caps the warm budget at n_al = floor(max_cycle_ms / phase_ms), at
        least 1, combined with early_exit (converge-or-budget). Returns the
        phase_ms used. step() calibrates on its first warm cycle. The
        cached warm solves are dropped (they hold the old schedule).
        """
        budget = self.config.solver.max_cycle_ms
        if budget <= 0:
            raise ValueError(
                "solver.max_cycle_ms is not set; nothing to calibrate"
            )
        if phase_ms is None:
            scenario = self._padded(scenario)
            one = dataclasses.replace(self.warm_settings, n_al=1, early_exit=False)
            if self._batched_al_sqp():
                probe = make_solver(self._spec, one, self.device)
            else:
                probe = self._lanes_fn(self._spec, one)
            init = initial_primal(self._spec, scenario)
            duals = self._fresh_duals()
            float(torch.sum(probe(scenario, init, duals).cost))  # warm-up
            times = []
            for _k in range(3):
                _synchronize(self.device)
                t0 = time.perf_counter()
                float(torch.sum(probe(scenario, init, duals).cost))
                _synchronize(self.device)
                times.append((time.perf_counter() - t0) * 1e3)
            phase_ms = min(times)
        self._phase_ms = float(phase_ms)
        allowed = max(1, int(budget / max(self._phase_ms, 1e-9)))
        new_nal = min(self._warm_nal_cfg, allowed)
        if new_nal != self.warm_settings.n_al:
            self.warm_settings = dataclasses.replace(self.warm_settings, n_al=new_nal)
            self._cache = {k: v for k, v in self._cache.items() if not k[1]}
        return self._phase_ms

    def _adapt_grid(self):
        """Horizon adaptation between cycles (host-side: each N has its own
        cached solve, _solver_fn).

        Parity: FiniteDifferencesVariableGridSE2's time-based modes (grow or
        shrink N when the optimized dt drifts out of the hysteresis band
        around dt_ref), and cbr's redundant-controls adaptation of the
        per-stage-dt grid; the warm start (primal + stage duals) is carried
        onto the edited grid.
        """
        g = self.config.grid
        if g.grid_adaptation_mode == "redundant_controls":
            self._primal, self._duals, new_N = adapt_grid_nonuniform(
                self._primal, self._duals,
                control_box=self._spec.control_box(),
                epsilon=g.grid_adaptation_redundant_controls_epsilon,
                dt_max=self._spec.dt_max,
                min_grid_size=g.grid_adaptation_min_grid_size,
                max_grid_size=g.grid_adaptation_max_grid_size,
            )
            if new_N != self._spec.N:
                self._spec = dataclasses.replace(self.spec, N=new_N)
            return
        new_N = adapt_grid_size(
            float(self._primal.dt),
            self._spec.N,
            dt_ref=self._spec.dt_ref,
            dt_hyst_ratio=g.grid_adaptation_dt_hyst_ratio,
            min_grid_size=g.grid_adaptation_min_grid_size,
            max_grid_size=g.grid_adaptation_max_grid_size,
            mode=g.grid_adaptation_mode,
        )
        if new_N != self._spec.N:
            self._primal = resize_primal(self._primal, new_N, spec=self._spec)
            self._duals = resize_duals(self._duals, new_N)
            self._spec = dataclasses.replace(self.spec, N=new_N)

    def reconfigure(self, updates) -> bool:
        """Retune parameters on a live controller (parity: the reference's
        dynamic_reconfigure surface on ``cfg/Controller.cfg``).

        ``updates`` is a nested YAML-style mapping merged over the current
        config (see config.reconfigure_config), or a full PlannerConfig.
        Returns True when the warm-start state survived the change: it is
        kept iff the problem shapes (horizon, model dims, obstacle / via
        capacities, dt-variable structure) are unchanged — weight or
        tolerance tuning keeps the fleet warm; structural changes reset it.
        The cached solves are dropped.
        """
        from mpc_local_planner_tpu_torch.planner.config import reconfigure_config

        new_cfg = (
            updates
            if isinstance(updates, PlannerConfig)
            else reconfigure_config(self.config, updates)
        )
        # snapshot warm state + the live (possibly adapted) horizon
        state = (
            self._primal, self._duals, self._last_goal,
            self._last_ok, self._last_diverged, self._steps_since_reinit,
            self._stuck,
        )
        phase_ms = self._phase_ms
        live_N, old_live = self._spec.N, self._spec

        # validate the new config on a THROWAWAY instance first: __init__
        # raises on bad combinations, and mutating self before that check
        # would leave a half-reconfigured live controller
        fresh = Controller(new_cfg, batch=self.batch, dtype=self.dtype, device=self.device)
        self.__dict__.update(fresh.__dict__)

        # the phase-time calibration is a property of the hardware: it
        # survives any retune, and the warm cap is re-derived from it
        if phase_ms is not None and self.config.solver.max_cycle_ms > 0:
            self.calibrate_cycle_budget(None, phase_ms=phase_ms)

        if state[0] is None:
            return False
        candidate = dataclasses.replace(self.spec, N=live_N)
        shape_keys = (
            "N", "nx", "nu", "obstacle_cap", "via_cap",
            "variable_dt", "nonuniform_dt",
        )
        same = all(
            getattr(candidate, k) == getattr(old_live, k) for k in shape_keys
        )
        ladder_ok = (not self._adapt) or (
            self.config.grid.grid_adaptation_min_grid_size
            <= live_N
            <= self.config.grid.grid_adaptation_max_grid_size
        )
        if not (same and ladder_ok and (self._adapt or live_N == self.spec.N)):
            return False
        (
            self._primal, self._duals, self._last_goal,
            self._last_ok, self._last_diverged, self._steps_since_reinit,
            stuck,
        ) = state
        # the stuck counter survives only if the feature is still enabled
        self._stuck = (
            stuck if self.config.solver.stuck_restart_cycles > 0 else None
        )
        self._spec = candidate
        return True

    def precompile(self, scenario: Scenario, n_values=None) -> int:
        """Pay, ahead of the first control cycle, what the cycles would
        otherwise pay at their first solve of each horizon the grid
        adaptation can reach: on CUDA the kernel libraries this Controller's
        solves launch are built and loaded (K1, and the fused kernel's group
        of the spec for a batched float32 al_sqp Controller), and each N's
        cold and warm solve runs once on ``scenario`` (a prototype of the
        cycles' scenario). Returns the number of cached solve callables,
        which is the JAX Controller's count of compiled programs for the
        same ``n_values``.
        """
        if self.device.type == "cuda":
            from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda, riccati_cuda

            riccati_cuda._load()
            if (self._batched_al_sqp() and self.dtype == torch.float32
                    and fused_al_sqp_cuda.fused_supported(self.spec)):
                fused_al_sqp_cuda._load(fused_al_sqp_cuda.group(self.spec, self.dtype))
        g = self.config.grid
        if n_values is None:
            if self._adapt:
                n_values = range(
                    g.grid_adaptation_min_grid_size,
                    g.grid_adaptation_max_grid_size + 1,
                )
            else:
                n_values = [self.spec.N]
        scenario = self._padded(scenario)
        spec0, primal0, duals0 = self._spec, self._primal, self._duals
        try:
            for n in n_values:
                self._spec = dataclasses.replace(self.spec, N=int(n))
                init = initial_primal(self._spec, scenario)
                duals = self._fresh_duals()
                for warm in (False, True):
                    r = self._solver_fn(warm=warm)(scenario, init, duals)
                float(torch.sum(r.cost))  # wait for the device
        finally:
            self._spec, self._primal, self._duals = spec0, primal0, duals0
        return len(self._cache)

    # -- warm-start policy ------------------------------------------------ #
    def reset(self):
        """Drop warm-start state (parity: Controller::reset on failure)."""
        self._primal = None
        self._duals = None
        self._last_goal = None
        self._last_ok = None
        self._last_diverged = None
        self._stuck = None
        self._steps_since_reinit = 0
        self._spec = self.spec

    def _fresh_duals(self):
        batch = () if self.batch is None else (self.batch,)
        return init_duals(self._spec, self.settings, dtype=self.dtype, device=self.device,
                          batch=batch)

    def _needs_reinit(self, goal) -> bool:
        """True when no warm state exists yet (full cold solve), or the
        periodic forced reinitialization is due (parity:
        force_reinit_num_steps — drop the warm start every K cycles to shed
        accumulated warm-start drift; 0 disables)."""
        if self._primal is None or self._last_goal is None:
            return True
        k = self.config.controller.force_reinit_num_steps
        return bool(k > 0 and self._steps_since_reinit >= k)

    def _goal_changed_mask(self, goal):
        """Per-scenario goal-change mask (parity: force_reinit_new_goal_dist /
        force_reinit_new_goal_angular). A 0-d bool tensor when unbatched."""
        c = self.config.controller
        dp = torch.linalg.norm(goal[..., :2] - self._last_goal[..., :2], dim=-1)
        da = torch.abs(angle_diff(goal[..., 2], self._last_goal[..., 2]))
        return (dp > c.force_reinit_new_goal_dist) | (da > c.force_reinit_new_goal_angular)

    def _padded(self, scenario):
        """Pad under-provisioned obstacle/via slots up to the spec's
        capacities (reference parity: containers hold up to capacity — e.g.
        Scenario.goal_only under an obstacle-enabled config); over-capacity
        raises."""
        if scenario.obstacles.total_slots() != self._spec.obstacle_cap:
            scenario = dataclasses.replace(
                scenario,
                obstacles=scenario.obstacles.padded_to(self._spec.obstacle_cap),
            )
        have = scenario.via_points.shape[-2]
        if have != self._spec.via_cap:
            if have > self._spec.via_cap:
                raise ValueError(
                    f"scenario has {have} via slots but the spec's via_cap "
                    f"is {self._spec.via_cap}"
                )
            batch = scenario.via_points.shape[:-2]
            extra = self._spec.via_cap - have
            scenario = dataclasses.replace(
                scenario,
                via_points=torch.cat(
                    [scenario.via_points, scenario.via_points.new_zeros(batch + (extra, 3))],
                    dim=-2,
                ),
                via_mask=torch.cat(
                    [scenario.via_mask, scenario.via_mask.new_zeros(batch + (extra,))],
                    dim=-1,
                ),
            )
        return scenario

    # -- the control cycle ------------------------------------------------ #
    def step(
        self,
        scenario: Scenario,
        plan: Optional[torch.Tensor] = None,
        shift_steps=1,  # int, or a per-lane integer tensor in batched mode
        elapsed: Optional[float] = None,
    ) -> ControlResult:
        """One MPC cycle: warm start → solve → extract first control.

        scenario: current x0/goal/obstacles/via points (batched iff
        ``batch`` was given). plan: optional (..., P, 3) transformed global
        plan used to seed the grid on (re)initialization (parity:
        generateInitialStateTrajectory). elapsed: wall time since the last
        cycle — the warm-start shift becomes round(elapsed / dt) stages
        (parity: the reference shifts its grid by the elapsed interval). In
        batched mode the shift count is computed PER LANE from that lane's
        own optimized dt (the mean of its stages on the non-uniform grid)
        and applied with the per-lane warm-start and dual-shift paths.
        """
        if elapsed is not None and self._primal is not None:
            if self.batch is None:
                dt_prev = float(torch.mean(self._primal.dt))  # mean over per-stage dt
                shift_steps = int(
                    min(max(round(elapsed / max(dt_prev, 1e-6)), 1), self._spec.N // 2)
                )
            else:
                dt_prev = self._primal.dt
                if self._spec.nonuniform_dt:
                    dt_prev = torch.mean(dt_prev, dim=-1)
                shift_steps = torch.clamp(
                    torch.round(elapsed / torch.clamp(dt_prev, min=1e-6)).to(torch.int32),
                    1,
                    self._spec.N // 2,
                )
        scenario = self._padded(scenario)
        goal = scenario.xf
        cold = self._needs_reinit(goal)
        if cold:
            self._spec = self.spec  # grid re-initializes at grid_size_ref
            if plan is not None and self.config.grid.warm_start:
                init = primal_from_plan(self._spec, plan, scenario.x0)
            else:
                init = initial_primal(self._spec, scenario)
            fresh_seed = init  # the f64 tier's diverged-lane restart seed
            duals = self._fresh_duals()
        else:
            if self._adapt:
                self._adapt_grid()
            # warm-start policy: converged scenarios advance (resample for
            # shrinking-horizon min-time, shift otherwise) with stage-shifted
            # duals; unconverged-but-sane ones CONTINUE from their current
            # iterate; diverged ones — and scenarios whose goal moved beyond
            # the force-reinit thresholds — reset fresh (per scenario)
            changed = self._goal_changed_mask(goal)
            ok = self._last_ok & ~changed
            diverged = self._last_diverged | changed
            # per-lane recovery replan (solver.stuck_restart_cycles): lanes
            # unconverged S consecutive cycles restart from the fresh
            # (plan-seeded when available) init
            S = self.config.solver.stuck_restart_cycles
            if S > 0 and self._stuck is not None:
                diverged = diverged | (self._stuck >= S)
            if self._spec.min_time and self._spec.variable_dt:
                advanced = warm_start_resample(
                    self._primal, scenario.x0, steps=shift_steps, spec=self._spec
                )
            else:
                advanced = warm_start_shift(
                    self._primal, scenario.x0, steps=shift_steps, spec=self._spec
                )
            adv_duals = shift_duals(self._duals, self.settings, steps=shift_steps)
            init = where_tree(ok, advanced, self._primal)
            duals = where_tree(ok, adv_duals, self._duals)
            # per-lane resets seed from the plan when one is given (the
            # restart IS the recovery replan)
            if plan is not None and self.config.grid.warm_start:
                fresh_p = primal_from_plan(self._spec, plan, scenario.x0)
            else:
                fresh_p = initial_primal(self._spec, scenario)
            init = where_tree(diverged, fresh_p, init)
            fresh_seed = fresh_p  # plan-seeded when a plan was given
            duals = where_tree(diverged, self._fresh_duals(), duals)
            # re-anchor stage 0 to the measured state on EVERY lane: the
            # solver treats x_0 as fixed data, and the continue branch would
            # otherwise iterate from last cycle's start state (parity: the
            # reference grid re-pins its first vertex to x0 each cycle)
            xs = init.xs.clone()
            xs[..., 0, :] = scenario.x0
            init = dataclasses.replace(init, xs=xs)

        if (
            not cold
            and self.config.solver.max_cycle_ms > 0
            and self._phase_ms is None
        ):
            # first warm cycle under a wall-clock budget: measure one AL
            # phase and cap the warm schedule (paid once; deployments call
            # calibrate_cycle_budget at bring-up instead)
            self.calibrate_cycle_budget(scenario)

        result = self._solver_fn(warm=not cold)(scenario, init, duals)
        if self.config.solver.f64_fallback_slots > 0:
            # IPOPT-parity escalation tier (solvers/f64_fallback.py), applied
            # BEFORE the warm-state update so the rescued iterates seed the
            # next cycle
            result = self._f64_pass(scenario, result, fresh_seed)

        self._steps_since_reinit = 0 if cold else self._steps_since_reinit + 1
        if self.config.solver.stuck_restart_cycles > 0:
            if cold or self._stuck is None:
                self._stuck = torch.zeros(result.converged.shape, dtype=torch.int32,
                                          device=self.device)
            else:
                # restarted lanes get a fresh patience window regardless of
                # this cycle's outcome (their iterate was rebased)
                self._stuck = torch.where(result.converged | diverged, 0, self._stuck + 1)
        self._primal, self._duals = result.primal, result.duals
        self._last_ok = result.converged
        # NaN-safe: eq_norm can be NaN on a blown-up lane, and `NaN > 0.5`
        # is False — written as NOT(both-small) so non-finite lanes reset
        # next cycle instead of continuing from garbage
        self._last_diverged = ~((result.eq_norm <= 0.5) & (result.ineq_viol <= 0.5))
        self._last_goal = goal

        u0 = result.primal.us[..., 0, :]
        # saturate the commanded control to the box (AL leaves O(tol)
        # violations); maximum/minimum, as jnp.clip computes it
        lo, hi = self.spec.control_box()
        u0 = torch.minimum(torch.maximum(u0, const(lo, u0)), const(hi, u0))
        twist = self.spec.model.twist_from_control(result.primal.xs[..., 0, :], u0)

        dt = result.primal.dt
        if self._spec.nonuniform_dt:
            # per-stage dt: stage times are the cumulative sum t_0 = 0, Σ dt_k
            times = torch.cat([torch.zeros_like(dt[..., :1]), torch.cumsum(dt, dim=-1)], dim=-1)
        else:
            times = (torch.arange(self._spec.N + 1, dtype=u0.dtype, device=u0.device)
                     * dt[..., None])
        x_seq = TimeSeriesSE2(times=times, values=result.primal.xs)
        u_seq = TimeSeries(times=times[..., :-1], values=result.primal.us)
        return ControlResult(u0=u0, twist=twist, x_seq=x_seq, u_seq=u_seq, solve=result)

    # -- goal test -------------------------------------------------------- #
    def is_goal_reached(self, x, goal) -> bool:
        """Parity: MpcLocalPlannerROS::isGoalReached (xy + yaw tolerances)."""
        c = self.config.controller
        x, goal = torch.as_tensor(x), torch.as_tensor(goal)
        dp = torch.linalg.norm(goal[..., :2] - x[..., :2], dim=-1)
        da = torch.abs(angle_diff(goal[..., 2], x[..., 2]))
        return bool(torch.all(dp < c.xy_goal_tolerance) and torch.all(da < c.yaw_goal_tolerance))
