"""Configuration system mirroring the reference's YAML parameter namespaces
(port of ``mpc_local_planner_tpu.planner.config``).

The `controller | robot | grid | planning | collision | solver |
footprint_model` namespaces of ``MpcLocalPlannerROS::initialize`` and
``Controller::configure``, as one frozen dataclass tree with the JAX
package's fields, defaults, validations and error messages. The example
YAMLs (``examples/cfg``) load 1:1 through ``load_config``;
``PlannerConfig.to_ocp_spec`` lowers the tree to the port's ``OcpSpec`` and
``SolverNs`` to its ``SolverSettings``. PyYAML is imported only to read a
string source: a dict needs nothing beyond the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from mpc_local_planner_tpu_torch.geometry.footprints import make_footprint
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec
from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings
from mpc_local_planner_tpu_torch.systems.models import RobotLimits, make_robot_dynamics


@dataclasses.dataclass(frozen=True)
class ControllerNs:
    """`controller` namespace (MpcLocalPlannerROS + Controller params)."""

    xy_goal_tolerance: float = 0.2
    yaw_goal_tolerance: float = 0.1
    global_plan_overwrite_orientation: bool = True
    global_plan_prune_distance: float = 1.0
    max_global_plan_lookahead_dist: float = 1.5
    global_plan_viapoint_sep: float = -1.0  # < 0 disables via points
    force_reinit_new_goal_dist: float = 1.0
    force_reinit_new_goal_angular: float = 1.5707963
    force_reinit_num_steps: int = 0
    prefer_x_feedback: bool = False
    publish_ocp_results: bool = False


@dataclasses.dataclass(frozen=True)
class RobotNs:
    """`robot` namespace: type + per-type kinematic/actuation limits."""

    type: str = "unicycle"
    max_vel_x: float = 0.4
    max_vel_x_backwards: float = 0.2
    max_vel_theta: float = 0.3
    acc_lim_x: float = 0.0
    dec_lim_x: float = 0.0
    acc_lim_theta: float = 0.0
    wheelbase: float = 1.0
    max_steering_angle: float = 1.5
    max_steering_rate: float = 0.0
    front_wheel_driving: bool = False

    def limits(self) -> RobotLimits:
        return RobotLimits(
            max_vel_x=self.max_vel_x,
            max_vel_x_backwards=self.max_vel_x_backwards,
            max_vel_theta=self.max_vel_theta,
            acc_lim_x=self.acc_lim_x,
            dec_lim_x=self.dec_lim_x,
            acc_lim_theta=self.acc_lim_theta,
            max_steering_angle=self.max_steering_angle,
            max_steering_rate=self.max_steering_rate,
        )

    def model(self):
        if self.type in ("simple_car", "simple_car_front_wheel_driving"):
            t = (
                "simple_car_front_wheel_driving"
                if (self.front_wheel_driving or self.type.endswith("front_wheel_driving"))
                else "simple_car"
            )
            return make_robot_dynamics(t, wheelbase=self.wheelbase)
        if self.type == "kinematic_bicycle_vel_input":
            return make_robot_dynamics(
                self.type, lf=self.wheelbase / 2.0, lr=self.wheelbase / 2.0
            )
        return make_robot_dynamics(self.type)


@dataclasses.dataclass(frozen=True)
class GridNs:
    """`grid` namespace (transcription grid)."""

    #: fd_grid → uniform dt (one shared dt, FiniteDifferencesVariableGridSE2);
    #: non_uniform_fd_grid → per-stage dt decision variables (parity:
    #: cbr NonUniformFiniteDifferencesVariableGrid); requires
    #: variable_grid.enable; solved by either solver.type (al_sqp treats
    #: each δdt_k as an extra control column in the Riccati sweep).
    type: str = "fd_grid"
    grid_size_ref: int = 20
    dt_ref: float = 0.3
    xf_fixed: Tuple[bool, bool, bool] = (False, False, False)
    warm_start: bool = True
    collocation_method: str = "forward_differences"
    cost_integration_method: str = "left_sum"
    variable_grid_enable: bool = False
    variable_grid_min_dt: float = 0.0
    variable_grid_max_dt: float = 10.0
    grid_adaptation_enable: bool = False
    grid_adaptation_max_grid_size: int = 50
    grid_adaptation_min_grid_size: int = 2
    # hysteresis band around dt_ref before N changes (parity:
    # grid.variable_grid.grid_adaptation.dt_hyst_ratio)
    grid_adaptation_dt_hyst_ratio: float = 0.1
    # adaptation strategy (parity: cbr GridAdaptStrategy):
    #   time_based_single_step         — grow/shrink N by 1 toward dt_ref
    #                                    (fd_grid only)
    #   time_based_aggressive_estimate — jump to N* = round(N·dt/dt_ref)
    #                                    (fd_grid only)
    #   redundant_controls             — merge intervals with near-identical
    #                                    neighboring controls, split across
    #                                    control jumps (non_uniform_fd_grid
    #                                    only; cbr NonUniformFiniteDifferences
    #                                    VariableGrid adaptation)
    grid_adaptation_mode: str = "time_based_single_step"
    # redundancy threshold on the per-interval control change (normalized by
    # the control box ranges) for redundant_controls mode; split fires at 2×
    grid_adaptation_redundant_controls_epsilon: float = 0.05

    def __post_init__(self):
        if self.type not in ("fd_grid", "non_uniform_fd_grid"):
            raise ValueError(
                f"unknown grid type {self.type!r}; "
                "options: fd_grid, non_uniform_fd_grid"
            )
        if self.grid_adaptation_mode not in (
            "time_based_single_step",
            "time_based_aggressive_estimate",
            "redundant_controls",
        ):
            raise ValueError(
                f"unknown grid_adaptation_mode {self.grid_adaptation_mode!r}; "
                "options: time_based_single_step, "
                "time_based_aggressive_estimate, redundant_controls"
            )


@dataclasses.dataclass(frozen=True)
class PlanningNs:
    """`planning` namespace (objective + terminal conditions)."""

    objective_type: str = "quadratic_form"
    state_weights: Tuple[float, ...] = (2.0, 2.0, 2.0)
    control_weights: Tuple[float, ...] = (1.0, 1.0)
    integral_form: bool = False
    hybrid_cost_minimum_time: float = 0.0
    via_points_position_weight: float = 1.0
    via_points_orientation_weight: float = 0.0
    via_points_ordered: bool = False
    terminal_cost_type: str = "none"          # none | quadratic
    final_state_weights: Tuple[float, ...] = (10.0, 10.0, 10.0)
    terminal_constraint_type: str = "none"    # none | ball
    ball_weight_matrix: Tuple[float, ...] = (1.0, 1.0, 1.0)
    ball_radius: float = 0.0


@dataclasses.dataclass(frozen=True)
class CollisionNs:
    """`collision` namespace."""

    min_obstacle_dist: float = 0.5
    include_costmap_obstacles: bool = True
    costmap_obstacles_behind_robot_dist: float = 1.5
    # number of leading planned states the post-solve costmap veto checks
    # (-1 = whole horizon). The reference checks only a short prefix
    # (isPoseTrajectoryFeasible "along first collision_check_no_poses
    # states") because only u0 is executed each cycle; vetoing on states
    # beyond the solver's own obstacle horizon (cutoff_dist) deadlocks the
    # cycle at the first wall the solver never saw.
    collision_check_no_poses: int = 5
    # interpolate an extra feasibility-check pose when consecutive planned
    # states differ by more than this heading angle (parity:
    # collision_check_min_resolution_angular)
    collision_check_min_resolution_angular: float = 3.141592653589793
    cutoff_dist: float = 2.5
    # lethal cells within this radius of the robot are included even when the
    # behind-the-robot filter would drop them (parity: force_inclusion_dist in
    # updateObstacleContainerWithCostmap; must be <= cutoff_dist to matter)
    force_inclusion_dist: float = 1.5
    enable_dynamic_obstacles: bool = False
    # padded slot budgets (shapes are static): costmap point cells, custom
    # circle obstacles, converter polygons
    obstacle_capacity: int = 50
    # custom circular obstacles (LocalPlanner extra_obstacles) need their own
    # static budget; 0 = feature off (passing extras without a budget drops
    # them — shapes cannot grow at runtime)
    circle_capacity: int = 0
    # costmap → obstacle representation (parity: costmap_converter plugin
    # selection):
    #   "points"   = lethal cells as point obstacles
    #   "polygons" = cluster + convex hull (CostmapToPolygonsDBSMCCH analog)
    #   "lines"    = cluster + dominant-line extraction
    #                (CostmapToLinesDBSRANSAC analog)
    #   "dynamic"  = cluster + frame-to-frame blob tracking with velocity
    #                estimation (CostmapToDynamicObstacles analog) — pair
    #                with enable_dynamic_obstacles so the solver predicts
    # Native C++ implementations are used when built; python fallbacks
    # otherwise.
    costmap_converter: str = "points"
    polygon_capacity: int = 12
    max_polygon_vertices: int = 12
    # static slot budgets for the line / dynamic converter modes
    line_capacity: int = 8
    dynamic_capacity: int = 8
    # line-converter fit parameters (parity: CostmapToLinesDBSRANSAC
    # ransac_inlier_distance / ransac_min_inliers)
    line_inlier_dist: float = 0.08
    line_min_inliers: int = 4
    # dynamic-converter tracker parameters (parity: CostmapToDynamicObstacles)
    tracker_gate_dist: float = 0.6
    tracker_vel_alpha: float = 0.5
    # frames an unmatched track coasts on its constant-velocity prediction
    # before being dropped (parity: the reference's Kalman tracks surviving
    # missed detections; 0 = drop immediately)
    tracker_max_missed: int = 2
    # foreground/background separation (parity: CostmapToDynamicObstacles
    # background subtraction + chained static converter): tracks slower than
    # this are background — their cells go through the static point path
    # (budgeted by obstacle_capacity) instead of becoming velocity circles.
    # Only tracks at/above this speed become dynamic circular obstacles.
    dynamic_min_speed: float = 0.1

    def __post_init__(self):
        if self.costmap_converter not in ("points", "polygons", "lines", "dynamic"):
            raise ValueError(
                f"unknown costmap_converter {self.costmap_converter!r}; "
                "options: points, polygons, lines, dynamic"
            )


@dataclasses.dataclass(frozen=True)
class SolverNs:
    """`solver` namespace → AL-SQP budget (replaces ipopt.* options)."""

    type: str = "al_sqp"
    iterations: int = 0        # 0 → problem-family preset
    inner_iterations: int = 0
    rho0: float = 0.0
    rho_growth: float = 0.0
    # feasibility tolerances for the converged flag (parity: ipopt.tol);
    # 0 → solver default (1e-4). Control-grade deployments typically use 1e-3.
    tol_eq: float = 0.0
    tol_ineq: float = 0.0
    # warm-cycle budget (0 → the warm preset, 2×4; see warm_settings); the
    # cold budget above applies on (re)initialization only
    warm_iterations: int = 0
    warm_inner_iterations: int = 0
    # converge-or-budget-exhausted outer loop (parity: ipopt.max_cpu_time /
    # max_iter — stop when converged, the budget is a CAP). Recommended for
    # unbatched controllers; batched fleets should prefer the rescue pass
    # below (the fused kernel runs its schedule to the end, so early_exit
    # solves take the un-fused path).
    early_exit: bool = False
    # straggler rescue (batched controllers only): after the fixed-budget
    # solve, compact the unconverged lanes into `rescue_slots` and re-solve
    # only those with a deeper continue budget (solvers/rescue.py). 0
    # disables. rescue_iterations default 4x4.
    rescue_slots: int = 0
    rescue_iterations: int = 0
    rescue_inner_iterations: int = 0
    # per-lane recovery replan (the move_base recovery-behavior analog): a
    # lane unconverged this many CONSECUTIVE cycles drops its warm state and
    # restarts from the fresh seed (plan-seeded when a plan is given) with
    # fresh duals; basin-trapped stragglers never escape by continuing. 0
    # disables.
    stuck_restart_cycles: int = 0
    # wall-clock cycle budget in ms (parity: `solver.ipopt.max_cpu_time`). 0
    # disables. Unlike IPOPT's mid-solve clock check, the granularity is ONE
    # AL PHASE: the warm n_al is capped at floor(max_cycle_ms /
    # measured_phase_ms), calibrated on the host
    # (Controller.calibrate_cycle_budget; step() calibrates on the first
    # warm cycle). Implies early_exit (converge-or-budget).
    max_cycle_ms: float = 0.0
    # post-solve polish (an accuracy knob): chain k extra warm-budget solves
    # from the returned iterate, keeping each re-solve only on lanes it left
    # converged; it sharpens the minimum-time switch stages that the warm
    # budget leaves rough. Cost ≈ k× the warm solve. 0 disables.
    polish_launches: int = 0
    # double-precision fallback (the last escalation tier): lanes still
    # unconverged after the solve (+ rescue) re-solve in float64 at the
    # cold depth and are merged back where float64 converged
    # (solvers/f64_fallback.py; on the Controller's device). Parity: IPOPT
    # runs in double. Value = straggler chunk size (every straggler is
    # taken, in chunks). Controller path only. 0 disables.
    f64_fallback_slots: int = 0

    def settings(self, spec: OcpSpec) -> SolverSettings:
        over: Dict[str, Any] = {}
        if self.iterations > 0:
            over["n_al"] = self.iterations
        if self.inner_iterations > 0:
            over["n_sqp"] = self.inner_iterations
        if self.rho0 > 0:
            over["rho0"] = self.rho0
        if self.rho_growth > 0:
            over["rho_growth"] = self.rho_growth
        if self.tol_eq > 0:
            over["tol_eq"] = self.tol_eq
        if self.tol_ineq > 0:
            over["tol_ineq"] = self.tol_ineq
        if self.early_exit:
            over["early_exit"] = True
        return SolverSettings.for_spec(spec, **over)

    def rescue_settings(self, base: SolverSettings) -> SolverSettings:
        """Deeper continue budget for the straggler rescue pass."""
        import dataclasses as _dc

        return _dc.replace(
            base,
            n_al=self.rescue_iterations or 4,
            n_sqp=self.rescue_inner_iterations or 4,
            # the straggler batch is small: the wider ladder pays there
            alphas=(1.0, 0.7, 0.5, 0.35, 0.22, 0.14, 0.08, 0.03),
        )

    def warm_settings(self, spec: OcpSpec) -> SolverSettings:
        """Per-cycle budget once a warm start exists.

        Default 2 AL phases × 4 SQP iterations with the 8-candidate line
        search (the JAX package's preset: on the carlike N=50 minimum-time
        closed loop 2×3 stalls short of the goal where 2×4 reaches it; the
        planner buys per-cycle convergence, where a fleet's continue policy
        absorbs non-convergence across cycles). ``lsq_lm`` keeps its
        penalty weights stiff on warm cycles instead.
        """
        base = self.settings(spec)
        import dataclasses as _dc

        if self.type == "lsq_lm":
            # LM soft penalties leave an O(1/w) feasibility bias: warm
            # cycles KEEP the weights stiff (from 1e4 up to 1e6) instead of
            # restarting them at a line-search-friendly rho0. LM iterations
            # are cheap (one Cholesky solve, no candidate ladder), so the
            # warm inner budget is deeper than the SQP default.
            return _dc.replace(
                base,
                n_al=self.warm_iterations or 2,
                n_sqp=self.warm_inner_iterations or 10,
                rho0=max(self.rho0, 1.0e4),
                rho_growth=self.rho_growth or 10.0,
                rho_max=max(base.rho_max, 1.0e6),
                tol_eq=self.tol_eq or 1e-3,
                tol_ineq=self.tol_ineq or 1e-3,
            )
        return _dc.replace(
            base,
            n_al=self.warm_iterations or 2,
            n_sqp=self.warm_inner_iterations or 4,
            # a wall-clock budget implies converge-or-budget semantics: the
            # capped n_al is a CAP, not a fixed cost (see max_cycle_ms)
            early_exit=self.early_exit or self.max_cycle_ms > 0,
            # warm-restart penalty: ρ restarts at this level every cycle
            # (shift_duals); warm iterates are near-feasible, so a stiffer
            # restart buys feasibility pressure (too stiff stalls the line
            # search)
            rho0=max(base.rho0, 120.0),
            reg0=1.0,
            alphas=(1.0, 0.7, 0.5, 0.35, 0.22, 0.14, 0.08, 0.03),
            tol_eq=self.tol_eq or 1e-3,
            tol_ineq=self.tol_ineq or 1e-3,
        )


@dataclasses.dataclass(frozen=True)
class FootprintNs:
    """`footprint_model` namespace."""

    type: str = "point"
    radius: float = 0.3
    line_start: Tuple[float, float] = (-0.3, 0.0)
    line_end: Tuple[float, float] = (0.3, 0.0)
    front_offset: float = 0.2
    front_radius: float = 0.2
    rear_offset: float = -0.2
    rear_radius: float = 0.2
    vertices: Tuple[Tuple[float, float], ...] = ()

    def footprint(self):
        t = self.type
        if t == "point":
            return make_footprint("point")
        if t == "circular":
            return make_footprint("circular", radius=self.radius)
        if t == "line":
            return make_footprint(
                "line", line_start=tuple(self.line_start), line_end=tuple(self.line_end)
            )
        if t == "two_circles":
            return make_footprint(
                "two_circles",
                front_offset=self.front_offset, front_radius=self.front_radius,
                rear_offset=self.rear_offset, rear_radius=self.rear_radius,
            )
        if t == "polygon":
            return make_footprint("polygon", vertices=tuple(self.vertices))
        raise ValueError(f"unknown footprint type {t!r}")


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    controller: ControllerNs = dataclasses.field(default_factory=ControllerNs)
    robot: RobotNs = dataclasses.field(default_factory=RobotNs)
    grid: GridNs = dataclasses.field(default_factory=GridNs)
    planning: PlanningNs = dataclasses.field(default_factory=PlanningNs)
    collision: CollisionNs = dataclasses.field(default_factory=CollisionNs)
    solver: SolverNs = dataclasses.field(default_factory=SolverNs)
    footprint_model: FootprintNs = dataclasses.field(default_factory=FootprintNs)
    via_capacity: int = 0  # padded via-point slots

    def to_ocp_spec(self) -> OcpSpec:
        """Lower the namespaces to the static OCP spec (parity:
        Controller::configureGrid + configureOcp)."""
        p, g, c = self.planning, self.grid, self.collision
        qf = tuple(p.final_state_weights) if p.terminal_cost_type == "quadratic" else None
        ball_r = p.ball_radius if p.terminal_constraint_type == "ball" else 0.0
        return OcpSpec(
            model=self.robot.model(),
            footprint=self.footprint_model.footprint(),
            N=g.grid_size_ref,
            collocation=g.collocation_method,
            cost_integration=g.cost_integration_method,
            objective=p.objective_type,
            q_diag=tuple(p.state_weights),
            r_diag=tuple(p.control_weights),
            integral_form=p.integral_form,
            hybrid_time_weight=p.hybrid_cost_minimum_time,
            qf_diag=qf,
            ball_weights=tuple(p.ball_weight_matrix),
            ball_radius=ball_r,
            xf_fixed=tuple(g.xf_fixed),
            dt_ref=g.dt_ref,
            dt_min=g.variable_grid_min_dt,
            dt_max=g.variable_grid_max_dt,
            variable_dt=g.variable_grid_enable or g.type == "non_uniform_fd_grid",
            nonuniform_dt=g.type == "non_uniform_fd_grid",
            limits=self.robot.limits(),
            min_obstacle_dist=c.min_obstacle_dist,
            obstacle_cap=c.obstacle_capacity
            + c.circle_capacity
            + (c.polygon_capacity if c.costmap_converter == "polygons" else 0)
            + (c.line_capacity if c.costmap_converter == "lines" else 0)
            + (c.dynamic_capacity if c.costmap_converter == "dynamic" else 0),
            via_cap=self.via_capacity,
            via_position_weight=p.via_points_position_weight,
            via_orientation_weight=p.via_points_orientation_weight,
            via_points_ordered=p.via_points_ordered,
            enable_dynamic_obstacles=c.enable_dynamic_obstacles,
        )

    def solver_settings(self, spec: Optional[OcpSpec] = None) -> SolverSettings:
        return self.solver.settings(spec if spec is not None else self.to_ocp_spec())

    def warm_solver_settings(self, spec: Optional[OcpSpec] = None) -> SolverSettings:
        return self.solver.warm_settings(
            spec if spec is not None else self.to_ocp_spec()
        )


def _build_ns(cls, d: Dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    clean = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown {cls.__name__} parameter {k!r}")
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        clean[k] = v
    return cls(**clean)


def _flatten_reference_style(ns: str, d: Dict[str, Any]) -> Dict[str, Any]:
    """Map reference YAML nesting onto the flat namespace dataclasses.

    Handles the reference's nested sub-namespaces, e.g.
      grid.variable_grid.{enable,min_dt,max_dt,grid_adaptation.*}
      planning.objective.{type,quadratic_form.*,minimum_time_via_points.*}
      planning.terminal_cost / terminal_constraint sub-trees
      robot.<type>.* per-type parameter blocks
    """
    out: Dict[str, Any] = {}
    if ns == "grid":
        for k, v in d.items():
            if k == "variable_grid" and isinstance(v, dict):
                for k2, v2 in v.items():
                    if k2 == "grid_adaptation" and isinstance(v2, dict):
                        for k3, v3 in v2.items():
                            out[f"grid_adaptation_{k3}"] = v3
                    else:
                        out[f"variable_grid_{k2}"] = v2
            else:
                out[k] = v
        return out
    if ns == "planning":
        for k, v in d.items():
            if k == "objective" and isinstance(v, dict):
                out["objective_type"] = v.get("type", "quadratic_form")
                qf = v.get("quadratic_form", {})
                for k2 in ("state_weights", "control_weights", "integral_form"):
                    if k2 in qf:
                        out[k2] = qf[k2]
                if "hybrid_cost_minimum_time" in qf:
                    out["hybrid_cost_minimum_time"] = qf["hybrid_cost_minimum_time"]
                vp = v.get("minimum_time_via_points", {})
                if "position_weight" in vp:
                    out["via_points_position_weight"] = vp["position_weight"]
                if "orientation_weight" in vp:
                    out["via_points_orientation_weight"] = vp["orientation_weight"]
                if "via_points_ordered" in vp:
                    out["via_points_ordered"] = vp["via_points_ordered"]
            elif k == "terminal_cost" and isinstance(v, dict):
                out["terminal_cost_type"] = v.get("type", "none")
                q = v.get("quadratic", {})
                if "final_state_weights" in q:
                    out["final_state_weights"] = q["final_state_weights"]
            elif k == "terminal_constraint" and isinstance(v, dict):
                out["terminal_constraint_type"] = v.get("type", "none")
                b = v.get("ball", {})
                if "weight_matrix" in b:
                    out["ball_weight_matrix"] = b["weight_matrix"]
                if "radius" in b:
                    out["ball_radius"] = b["radius"]
            else:
                out[k] = v
        return out
    if ns == "robot":
        rtype = d.get("type", "unicycle")
        out["type"] = rtype
        for k, v in d.items():
            if isinstance(v, dict):  # per-type block, e.g. robot.unicycle.*
                if k == rtype or k in (
                    "unicycle", "simple_car", "kinematic_bicycle_vel_input"
                ):
                    if k == rtype:
                        out.update(v)
            elif k != "type":
                out[k] = v
        return out
    return dict(d)


def reconfigure_config(config: PlannerConfig, updates: Dict[str, Any]) -> PlannerConfig:
    """New PlannerConfig with YAML-style nested ``updates`` merged over
    ``config`` (parity: the dynamic_reconfigure parameter surface — the
    reference lets a subset of `cfg/Controller.cfg` parameters be retuned on
    a live controller). Unknown namespaces/keys raise, like load_config.
    """
    ns_map = {
        "controller": ControllerNs,
        "robot": RobotNs,
        "grid": GridNs,
        "planning": PlanningNs,
        "collision": CollisionNs,
        "solver": SolverNs,
        "footprint_model": FootprintNs,
    }
    kwargs: Dict[str, Any] = {}
    for ns, value in updates.items():
        if ns == "via_capacity":
            kwargs[ns] = value
            continue
        if ns not in ns_map:
            raise KeyError(f"unknown config namespace {ns!r}")
        cls = ns_map[ns]
        flat = _flatten_reference_style(ns, value)
        fields = {f.name for f in dataclasses.fields(cls)}
        clean: Dict[str, Any] = {}
        for k, v in flat.items():
            if k not in fields:
                raise KeyError(f"unknown {cls.__name__} parameter {k!r}")
            if isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            clean[k] = v
        kwargs[ns] = dataclasses.replace(getattr(config, ns), **clean)
    return dataclasses.replace(config, **kwargs)


def load_config(source) -> PlannerConfig:
    """Build a PlannerConfig from a dict, YAML string, or YAML file path."""
    if isinstance(source, str):
        import os

        import yaml

        if os.path.exists(source):
            with open(source) as f:
                data = yaml.safe_load(f)
        else:
            data = yaml.safe_load(source)
    else:
        data = dict(source)
    data = dict(data or {})

    ns_map = {
        "controller": ControllerNs,
        "robot": RobotNs,
        "grid": GridNs,
        "planning": PlanningNs,
        "collision": CollisionNs,
        "solver": SolverNs,
        "footprint_model": FootprintNs,
    }
    kwargs: Dict[str, Any] = {}
    for ns, cls in ns_map.items():
        if ns in data:
            kwargs[ns] = _build_ns(cls, _flatten_reference_style(ns, data[ns]))
    for extra in ("via_capacity",):
        if extra in data:
            kwargs[extra] = data[extra]
    return PlannerConfig(**kwargs)
