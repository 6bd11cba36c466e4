"""Solver phase profiling and diagnostics (port of
``mpc_local_planner_tpu.profiling``).

Per-phase wall times of the un-fused solver (one SQP iteration; the line
search's merits), a ``torch.profiler`` trace context, and the ensemble's
convergence and active-constraint counters. The timers synchronize the
device before and after: CUDA launches return before the work is done.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from mpc_local_planner_tpu_torch.ocp import constraints as C
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.problem import make_ocp_functions
from mpc_local_planner_tpu_torch.solvers import al_sqp as A


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_solver_phases(
    spec, settings, scenario, init, duals, iters: int = 3
) -> Dict[str, float]:
    """Per-phase wall times (ms) of one SQP iteration over a scenario batch,
    on the device the tensors lie on (each phase called once first).

    Phases: the full iteration (AD derivatives, the Riccati KKT solve, which
    is kernel K1 on the card, and the line search) and the line search's
    merit evaluated at 6 candidates.
    """
    funcs = make_ocp_functions(spec)
    kkt_system = A.default_kkt_system(spec, settings, scenario, init)
    lqr = A.kkt_backend(settings)
    decisions = A.Decisions()
    reg = torch.full(init.dt.shape[:1], settings.reg0, dtype=init.xs.dtype,
                     device=init.xs.device)
    cands = Primal(
        xs=init.xs.expand((6,) + init.xs.shape),
        us=init.us.expand((6,) + init.us.shape),
        dt=init.dt.expand((6,) + init.dt.shape),
    )

    def full_iteration():
        p2, _ = A._sqp_iteration(spec, funcs, settings, kkt_system, init, scenario, duals, reg,
                                 lqr, decisions)
        return p2.us

    def line_search_merits():
        return A._al_merit(funcs, cands, scenario, duals)

    device = init.xs.device
    out: Dict[str, float] = {}
    for name, fn in (("full_iteration", full_iteration),
                     ("line_search_merits", line_search_merits)):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        for _i in range(iters):
            fn()
        _sync(device)
        out[name] = (time.perf_counter() - t0) / iters * 1e3
    return out


def torch_trace(log_dir: str):
    """``torch.profiler`` context writing a TensorBoard trace into ``log_dir``
    (the counterpart of ``xla_trace``): CPU activity, and CUDA activity when
    a card is present. ::

        with profiling.torch_trace("/tmp/torch-trace"):
            solver(scen, init, duals)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )


def active_constraints_report(spec, result, scenario) -> Dict[str, float]:
    """Per-class active-inequality counters at the returned iterate. A
    constraint counts as active when its value is within tol of the boundary
    or violated (g > −tol). Means are per scenario."""
    p = result.primal
    tol = 1e-3
    classes = {
        "obstacle": C.obstacle_inequalities(spec, p.xs, p.dt, scenario),
        "rate": C.control_rate_inequalities(spec, p.us, p.dt, scenario.u_prev),
        "box": C.control_box_inequalities(spec, p.us),
        "dt": C.dt_inequalities(spec, p.dt, p.xs.dtype),
        "ball": C.terminal_ball_inequality(spec, p.xs, scenario.xf),
    }
    batch_ndim = p.xs.dim() - 2  # leading scenario axes, if any
    out: Dict[str, float] = {}
    for name, g in classes.items():
        active = (g > -tol).cpu().numpy()
        per_scen = active.reshape(active.shape[:batch_ndim] + (-1,)).sum(-1)
        out[f"active_{name}_mean"] = float(per_scen.mean())
        out[f"active_{name}_max"] = int(per_scen.max()) if per_scen.size else 0
    return out


def convergence_report(result) -> Dict[str, float]:
    """Ensemble convergence and feasibility counters."""
    eq = result.eq_norm.detach().cpu().numpy().ravel()
    viol = result.ineq_viol.detach().cpu().numpy().ravel()
    conv = result.converged.detach().cpu().numpy().ravel()
    return {
        "n_scenarios": int(eq.size),
        "converged_frac": float(conv.mean()) if eq.size else 0.0,
        "eq_p50": float(np.percentile(eq, 50)) if eq.size else 0.0,
        "eq_p99": float(np.percentile(eq, 99)) if eq.size else 0.0,
        "viol_p50": float(np.percentile(viol, 50)) if viol.size else 0.0,
        "viol_p99": float(np.percentile(viol, 99)) if viol.size else 0.0,
        "diverged_frac": float(((eq > 0.5) | (viol > 0.5)).mean()) if eq.size else 0.0,
    }
