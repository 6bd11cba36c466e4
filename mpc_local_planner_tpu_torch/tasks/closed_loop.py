"""Closed-loop control task: plant + controller simulation with recording
(port of ``mpc_local_planner_tpu.tasks.closed_loop``).

Parity: cbr:tasks/closed_loop_control_task.h ::
ClosedLoopControlTask::performTask — loop { plant.output → controller.step →
plant.control } while recording the x/u TimeSeries and the solve times.
``perform`` runs the loop on the host around the port's ``Controller`` (which
keeps its warm state on its device); ``run_feedback_loop`` runs a pure
control law over a batch of plants, the batch being the leading axes of
``x0``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from mpc_local_planner_tpu_torch.core.time_series import TimeSeries, TimeSeriesSE2
from mpc_local_planner_tpu_torch.geometry.obstacles import ObstacleSet
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.plants.simulated_plant import SimulatedPlant


@dataclasses.dataclass
class ClosedLoopLog:
    """Recorded signals (parity: corbo TimeSeries signals + cpu_time stats)."""

    states: TimeSeriesSE2
    controls: TimeSeries
    solve_ms: np.ndarray
    goal_reached: bool


class ClosedLoopControlTask:
    """MPC controller + simulated plant closed loop. The plant's state is
    float32 on the controller's device, as the scenario it feeds."""

    def __init__(self, controller, plant: SimulatedPlant, sim_dt: float):
        self.controller = controller
        self.plant = plant
        self.sim_dt = sim_dt

    def perform(
        self,
        x0,
        goal,
        n_cycles: int = 60,
        generator: Optional[torch.Generator] = None,
        scenario_fn: Optional[Callable] = None,
    ) -> ClosedLoopLog:
        """Run until the goal test passes or n_cycles elapse. ``generator``
        draws the plant's noise (none without it); ``scenario_fn(y, goal)``
        builds each cycle's scenario (default: the goal alone, no obstacle,
        the last applied control as u_prev)."""
        spec = self.controller.spec
        dev = self.controller.device
        f32 = torch.float32
        state = self.plant.init_state(torch.as_tensor(x0, dtype=f32).to(dev))
        goal = torch.as_tensor(goal, dtype=f32).to(dev)
        xs, us, times_ms = [state.x.cpu().numpy()], [], []
        reached = False
        for _cycle in range(n_cycles):
            y = self.plant.output(state, generator)
            if scenario_fn is not None:
                scen = scenario_fn(y, goal)
            else:
                scen = Scenario(
                    x0=y,
                    xf=goal,
                    obstacles=ObstacleSet.empty(spec.obstacle_cap, 0, 0, 0, dtype=f32,
                                                device=dev),
                    via_points=torch.zeros((spec.via_cap, 3), dtype=f32, device=dev),
                    via_mask=torch.zeros((spec.via_cap,), dtype=torch.bool, device=dev),
                    u_prev=torch.as_tensor(us[-1], dtype=f32).to(dev) if us
                    else torch.zeros((spec.nu,), dtype=f32, device=dev),
                )
            t0 = time.perf_counter()
            res = self.controller.step(scen)
            u0 = res.u0.cpu().numpy()  # host fetch = solve complete
            times_ms.append((time.perf_counter() - t0) * 1e3)
            state = self.plant.step(state, torch.from_numpy(u0).to(dev), self.sim_dt,
                                    generator=generator)
            xs.append(state.x.cpu().numpy())
            us.append(u0)
            if self.controller.is_goal_reached(state.x, goal):
                reached = True
                break
        t = torch.from_numpy(np.arange(len(xs)) * self.sim_dt)
        if us:
            controls = TimeSeries(times=t[:-1], values=torch.from_numpy(np.stack(us)))
        else:
            controls = TimeSeries(times=torch.zeros((0,), dtype=torch.float64),
                                  values=torch.zeros((0, spec.nu)))
        return ClosedLoopLog(
            states=TimeSeriesSE2(times=t, values=torch.from_numpy(np.stack(xs))),
            controls=controls,
            solve_ms=np.asarray(times_ms),
            goal_reached=reached,
        )


def run_feedback_loop(control_law, plant: SimulatedPlant, x0, dt, n_cycles: int):
    """Closed loop of a pure control law (LQR, PID, state feedback) on the
    device of ``x0``: ``control_law(y) → u`` each cycle. Returns
    (xs (T+1, ..., nx), us (T, ..., nu)); the leading axes of ``x0`` are a
    batch of independent loops."""
    state = plant.init_state(torch.as_tensor(x0))
    xs, us = [state.x], []
    for _ in range(n_cycles):
        u = control_law(plant.output(state))
        state = plant.step(state, u, dt)
        xs.append(state.x)
        us.append(u)
    return torch.stack(xs, dim=0), torch.stack(us, dim=0)
