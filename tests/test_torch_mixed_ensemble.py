"""The port's mixed-model ensemble (``parallel/ensembles.py``) on the CPU.

JAX's ``test_mixed_unicycle_and_carlike_fleet`` fleet (config #1's unicycle
at N=10 and a simple car at N=12, both the quadratic form, 6×6 iterations,
1e-3 tolerances), 8 and 6 lanes, in float64: the same scenarios (made by the
JAX package and handed over through numpy) go through JAX's
``MixedEnsembleSolver`` and the port's. Each group's conv flags equal JAX's,
its states, controls, dt and cost within 1e-9 plus ten times JAX's own move
on the lane when its initial states move by one ulp (2.6e-9 on a car lane's
controls at this budget); the summary equals JAX's; each group of
``solve_all`` equals its own ``solve_group``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.geometry.footprints import PointFootprint as JPoint
from mpc_local_planner_tpu.ocp.spec import OcpSpec as JSpec
from mpc_local_planner_tpu.parallel.ensembles import MixedEnsembleSolver as JMixed
from mpc_local_planner_tpu.solvers.al_sqp import SolverSettings as JSettings
from mpc_local_planner_tpu.systems.models import RobotLimits as JLimits
from mpc_local_planner_tpu.systems.models import SimpleCarModel as JCar

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.geometry.footprints import PointFootprint
from mpc_local_planner_tpu_torch.ocp.spec import OcpSpec, Scenario
from mpc_local_planner_tpu_torch.parallel.ensembles import MixedEnsembleSolver
from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings
from mpc_local_planner_tpu_torch.systems.models import RobotLimits, SimpleCarModel

CAR = dict(N=12, objective="quadratic_form", qf_diag=(10.0, 10.0, 5.0), dt_ref=0.3)
LIMITS = dict(max_vel_x=0.4, max_vel_x_backwards=0.2, max_steering_angle=0.8)
ST = dict(n_al=6, n_sqp=6, tol_eq=1e-3, tol_ineq=1e-3)


def _np(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: _np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def test_torch_mixed_ensemble_groups_match_jax():
    jspecs = (jb.config1_unicycle_quadratic(N=10),
              JSpec(model=JCar(wheelbase=0.5), footprint=JPoint(), limits=JLimits(**LIMITS),
                    **CAR))
    tspecs = (tb.config1_unicycle_quadratic(N=10),
              OcpSpec(model=SimpleCarModel(wheelbase=0.5), footprint=PointFootprint(),
                      limits=RobotLimits(**LIMITS), **CAR))
    jsolver = JMixed([(s, JSettings(**ST)) for s in jspecs])
    tsolver = MixedEnsembleSolver([(s, SolverSettings(**ST)) for s in tspecs], device="cpu")
    assert tsolver.n_groups == jsolver.n_groups == 2
    jscen = [jb.random_ensemble(s, b, jax.random.PRNGKey(k), dtype=jnp.float64, goal_radius=1.2)
             for s, b, k in zip(jspecs, (8, 6), (0, 1))]
    tscen = [convert.from_numpy(Scenario, _np(s), "cpu") for s in jscen]
    jinit = [jsolver.init_state(g, jscen[g], dtype=jnp.float64) for g in range(2)]
    tinit = [tsolver.init_state(g, tscen[g], dtype=torch.float64) for g in range(2)]
    for (ji, jd), (ti, td) in zip(jinit, tinit):
        np.testing.assert_allclose(ti.xs.numpy(), np.asarray(ji.xs), rtol=0, atol=1e-12)
        assert td.rho.shape == jd.rho.shape and td.mu_obs.shape == jd.mu_obs.shape
    jres = jsolver.solve_all(jscen, [i for i, _ in jinit], [d for _, d in jinit])
    tres = tsolver.solve_all(tscen, [i for i, _ in tinit], [d for _, d in tinit])
    assert tres[0].primal.us.shape == (8, 10, 2) and tres[1].primal.us.shape == (6, 12, 2)
    for g in range(2):
        np.testing.assert_array_equal(tres[g].converged.numpy(), np.asarray(jres[g].converged))
        ji, jd = jinit[g]
        moved = jsolver.solve_group(g, jscen[g], dataclasses.replace(
            ji, xs=jnp.nextafter(ji.xs, jnp.inf)), jd)
        lanes = tres[g].converged.shape[0]

        def lane_err(a, b):
            return np.abs(np.asarray(a) - np.asarray(b)).reshape(lanes, -1).max(1)

        names = ("xs", "us", "dt")
        move = np.max([lane_err(getattr(moved.primal, n), getattr(jres[g].primal, n))
                       for n in names] + [lane_err(moved.cost, jres[g].cost)], axis=0)
        tol = 1e-9 + 10.0 * move
        for n in names:
            err = lane_err(getattr(tres[g].primal, n).numpy(), getattr(jres[g].primal, n))
            assert np.all(err <= tol), (g, n, err, tol)
        cost_err = lane_err(tres[g].cost.numpy(), jres[g].cost)
        assert np.all(cost_err <= tol * np.maximum(1.0, np.abs(np.asarray(jres[g].cost))))
        alone = tsolver.solve_group(g, tscen[g], *tinit[g])
        assert torch.equal(alone.primal.xs, tres[g].primal.xs)
        assert torch.equal(alone.converged, tres[g].converged)
    s = tsolver.summary(tres)
    assert s == jsolver.summary(jres)
    assert s["n_scenarios"] == 14 and s["converged_frac"] > 0.5
