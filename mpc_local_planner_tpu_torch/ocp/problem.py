"""OCP assembly: the cost, equality and inequality evaluators of a spec (port
of ``mpc_local_planner_tpu.ocp.problem``).

The constraint system of the fixed-shape OCP, as dense stage-wise tensors:
  equality   : N collocation defects (N, 3) + masked terminal equality (3,)
  inequality : obstacles (N, M) ++ control-rate (N, 2nu) ++ control box
               (N, 2nu) ++ dt box (2,), or (2N,) per interval on the
               non-uniform grid ++ terminal ball (1,)
``flatten`` / ``unflatten`` give the packed decision vector z = [X_free, U,
dt?] of the float64 golden solver (scipy SLSQP) and the Levenberg–Marquardt
solver; the AL-SQP solver works on the structured form.
"""

from __future__ import annotations

import dataclasses

import torch

from mpc_local_planner_tpu_torch.ocp import constraints as C
from mpc_local_planner_tpu_torch.ocp.collocation import collocation_defects
from mpc_local_planner_tpu_torch.ocp.costs import total_cost
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec


@dataclasses.dataclass(frozen=True)
class OcpFunctions:
    """Pure evaluators over (Primal, Scenario); all shapes static per spec."""

    spec: OcpSpec

    def cost(self, primal: Primal, scenario) -> torch.Tensor:
        return total_cost(self.spec, primal.xs, primal.us, primal.dt, scenario)

    def defects(self, primal: Primal) -> torch.Tensor:
        return collocation_defects(
            self.spec.model, self.spec.collocation, primal.xs, primal.us, primal.dt
        )

    def eq(self, primal: Primal, scenario) -> torch.Tensor:
        """Flat equality residual: [defects (N·3), terminal equality (3)]."""
        d = self.defects(primal)
        te = C.terminal_equality(self.spec, primal.xs, scenario.xf)
        return torch.cat([d.flatten(-2), te], dim=-1)

    def ineq(self, primal: Primal, scenario) -> torch.Tensor:
        """Flat inequality residual (g ≤ 0), in the order of the module
        docstring."""
        s = self.spec
        xs, us, dt = primal.xs, primal.us, primal.dt
        parts = [
            C.obstacle_inequalities(s, xs, dt, scenario).flatten(-2),
            C.control_rate_inequalities(s, us, dt, scenario.u_prev).flatten(-2),
            C.control_box_inequalities(s, us).flatten(-2),
            C.dt_inequalities(s, dt, xs.dtype),
            C.terminal_ball_inequality(s, xs, scenario.xf),
        ]
        return torch.cat(parts, dim=-1)

    @property
    def n_eq(self) -> int:
        return self.spec.N * self.spec.nx + self.spec.nx

    @property
    def n_dt(self) -> int:
        """Number of dt decision variables (0 fixed, 1 uniform, N non-uniform)."""
        s = self.spec
        if not s.variable_dt:
            return 0
        return s.N if s.nonuniform_dt else 1

    @property
    def n_ineq(self) -> int:
        s = self.spec
        n_dt_box = 2 * s.N if s.nonuniform_dt else 2
        return s.N * s.obstacle_cap + 4 * s.N * s.nu + n_dt_box + 1

    @property
    def n_free(self) -> int:
        s = self.spec
        return s.N * s.nx + s.N * s.nu + self.n_dt

    def flatten(self, primal: Primal) -> torch.Tensor:
        """z = [x_1..x_N, u_0..u_{N-1}, dt?] (x_0 is pinned)."""
        s = self.spec
        parts = [primal.xs[..., 1:, :].flatten(-2), primal.us.flatten(-2)]
        if s.variable_dt:
            parts.append(primal.dt if s.nonuniform_dt else primal.dt[..., None])
        return torch.cat(parts, dim=-1)

    def unflatten(self, z: torch.Tensor, x0, dt_fixed=None) -> Primal:
        """The inverse of ``flatten`` with x_0 from ``x0``; a fixed dt is
        ``dt_fixed`` (dt_ref by default)."""
        s = self.spec
        batch = z.shape[:-1]
        nX, nU = s.N * s.nx, s.N * s.nu
        xs_tail = z[..., :nX].reshape(batch + (s.N, s.nx))
        xs = torch.cat([x0.expand(batch + (s.nx,))[..., None, :], xs_tail], dim=-2)
        us = z[..., nX : nX + nU].reshape(batch + (s.N, s.nu))
        if s.variable_dt:
            dt = z[..., nX + nU :] if s.nonuniform_dt else z[..., nX + nU]
        else:
            dt = torch.full(batch, s.dt_ref if dt_fixed is None else dt_fixed,
                            dtype=z.dtype, device=z.device)
        return Primal(xs=xs, us=us, dt=dt)


def make_ocp_functions(spec: OcpSpec) -> OcpFunctions:
    return OcpFunctions(spec=spec)
