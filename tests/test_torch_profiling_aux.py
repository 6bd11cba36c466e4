"""The port's profiling and the small aux modules on the CPU
(``profiling.py``, ``core/{references,signals,value_comparison}.py``,
``utils/compilation_cache.py``).

* ``convergence_report`` and ``active_constraints_report`` equal JAX's on one
  result (JAX's profiling fixture: the flagship at N=8 with 3 circle
  slots, 4 lanes, 2×3 iterations), handed to the port through numpy;
* ``profile_solver_phases`` gives positive times for both phases;
* ``torch_trace`` writes a trace file;
* the references, the signal recorder and the comparisons against JAX's;
* ``enable_persistent_cache`` moves where the native libraries are built:
  the costmap runtime is built into a temporary directory.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu import profiling as jprof
from mpc_local_planner_tpu.core import references as jref
from mpc_local_planner_tpu.core import value_comparison as jvc
from mpc_local_planner_tpu.core.signals import SignalRecorder as JRecorder
from mpc_local_planner_tpu.core.time_series import TimeSeries as JTimeSeries
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.solvers.al_sqp import SolverSettings as JSettings
from mpc_local_planner_tpu.solvers.al_sqp import init_duals as j_init_duals
from mpc_local_planner_tpu.solvers.al_sqp import solve_single as j_solve_single

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert, native, profiling
from mpc_local_planner_tpu_torch.core import references as tref
from mpc_local_planner_tpu_torch.core import value_comparison as tvc
from mpc_local_planner_tpu_torch.core.signals import SignalRecorder
from mpc_local_planner_tpu_torch.core.time_series import TimeSeries
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.ops import nvcc_build
from mpc_local_planner_tpu_torch.solvers.al_sqp import DualState, SolverSettings, SolveResult
from mpc_local_planner_tpu_torch.utils import compilation_cache

ST = dict(n_al=2, n_sqp=3, tol_eq=1e-3, tol_ineq=1e-3)


def _np(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: _np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def _solved(batch=4):
    """JAX's profiling fixture, and the same objects in the port."""
    jspec = jb.config3_carlike_min_time(N=8, obstacle_cap=3)
    st = JSettings(**ST)
    scen = jb.random_ensemble(jspec, batch, jax.random.PRNGKey(0))
    init = j_initial_primal(jspec, scen)
    duals = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape),
                                   j_init_duals(jspec, st, dtype=jnp.float32))
    res = jax.jit(jax.vmap(lambda s, i, d: j_solve_single(jspec, st, s, i, d)))(scen, init, duals)
    port = (convert.from_numpy(Scenario, _np(scen), "cpu"),
            convert.from_numpy(Primal, _np(init), "cpu"),
            convert.from_numpy(DualState, _np(duals), "cpu"),
            convert.from_numpy(SolveResult, _np(res), "cpu"))
    return jspec, tb.config3_carlike_min_time(N=8, obstacle_cap=3), (scen, res), port


def test_torch_reports_match_jax_and_phase_times_are_positive(tmp_path):
    jspec, tspec, (jscen, jres), (scen, init, duals, res) = _solved()
    assert profiling.convergence_report(res) == jprof.convergence_report(jres)
    rep = profiling.active_constraints_report(tspec, res, scen)
    assert rep == jprof.active_constraints_report(jspec, jres, jscen)
    assert rep["active_box_mean"] > 0.0 and rep["active_ball_max"] == 0
    for cls in ("obstacle", "rate", "box", "dt", "ball"):
        assert rep[f"active_{cls}_max"] >= rep[f"active_{cls}_mean"]
    out = profiling.profile_solver_phases(tspec, SolverSettings(**ST), scen, init, duals, iters=1)
    assert set(out) == {"full_iteration", "line_search_merits"}
    assert all(v > 0.0 for v in out.values())
    with profiling.torch_trace(str(tmp_path)):
        profiling.profile_solver_phases(tspec, SolverSettings(**ST), scen, init, duals, iters=1)
    assert list(tmp_path.glob("*.pt.trace.json"))


def test_torch_references_and_signals_match_jax():
    value = np.array([0.5, -1.0, 2.0])
    times = np.array([0.0, 0.3, 0.75, 1.2])
    np.testing.assert_array_equal(
        tref.StaticReference(torch.from_numpy(value)).at_stages(torch.from_numpy(times)).numpy(),
        np.asarray(jref.StaticReference(jnp.asarray(value)).at_stages(jnp.asarray(times))))
    z = tref.ZeroReference(dim=2).at_time(torch.from_numpy(times))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jref.ZeroReference(dim=2).at_time(
        jnp.asarray(times))))
    assert z.dtype == torch.float64
    rng = np.random.default_rng(0)
    st, sv = np.sort(rng.uniform(0, 2, 6)), rng.normal(size=(6, 3))
    ttraj = tref.TrajectoryReference(TimeSeries(times=torch.from_numpy(st),
                                                values=torch.from_numpy(sv)))
    jtraj = jref.TrajectoryReference(JTimeSeries(times=jnp.asarray(st), values=jnp.asarray(sv)))
    q = np.array([-0.1, 0.4, 1.1, 2.5])
    np.testing.assert_allclose(ttraj.at_stages(torch.from_numpy(q)).numpy(),
                               np.asarray(jtraj.at_stages(jnp.asarray(q))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ttraj.at_time(0.9).numpy(), np.asarray(jtraj.at_time(0.9)),
                               rtol=0, atol=1e-12)

    rec, jrec = SignalRecorder(), JRecorder()
    for t in range(5):
        rec.send_measurement("eq_norm", 0.1 * t, torch.tensor(t * 1.0))
        jrec.send_measurement("eq_norm", 0.1 * t, t * 1.0)
        rec.send_measurement("u", 0.1 * t, [t, -t])
    assert rec.names() == ["eq_norm", "u"]
    ts = rec.series("eq_norm")
    assert ts.values.shape == (5, 1) and rec.series("u").values.shape == (5, 2)
    np.testing.assert_array_equal(ts.values.numpy(), np.asarray(jrec.series("eq_norm").values))
    np.testing.assert_array_equal(ts.times.numpy(), np.asarray(jrec.series("eq_norm").times))
    rec.clear()
    assert rec.names() == []


def test_torch_core_exports_and_angle_helpers_match_jax():
    """The core package exports JAX's names; the circular mean (with weights,
    over an axis, across the ±π seam) and the point distance match JAX's."""
    import mpc_local_planner_tpu.core as jcore
    import mpc_local_planner_tpu_torch.core as tcore

    names = [n for n in dir(jcore)
             if not n.startswith("_") and not isinstance(getattr(jcore, n), types.ModuleType)]
    assert len(names) == 14 and all(hasattr(tcore, n) for n in names)
    rng = np.random.default_rng(4)
    ang = np.concatenate([rng.uniform(-np.pi, np.pi, (3, 5)), [[3.1, -3.1, 3.0, -3.05, 2.9]]])
    w = rng.uniform(0.1, 2.0, (4, 5))
    for kw in ({}, {"axis": 1}, {"axis": 0, "weights": w}):
        jkw = {k: (jnp.asarray(v) if k == "weights" else v) for k, v in kw.items()}
        tkw = {k: (torch.from_numpy(v) if k == "weights" else v) for k, v in kw.items()}
        np.testing.assert_allclose(tcore.average_angles(torch.from_numpy(ang), **tkw).numpy(),
                                   np.asarray(jcore.average_angles(jnp.asarray(ang), **jkw)),
                                   rtol=0, atol=1e-12)
    p1, p2 = rng.normal(size=(6, 2)), rng.normal(size=(6, 2))
    np.testing.assert_allclose(tcore.distance_points2d(p1, p2).numpy(),
                               np.asarray(jcore.distance_points2d(p1, p2)), rtol=1e-15)


def test_torch_value_comparison_matches_jax():
    a = np.array([1.0, 1.0 + 1e-7, 2.0, 0.0, -3.0, 1e-7])
    b = np.array([1.0, 1.0, 2.0 + 3e-6, 1e-6, -3.0 - 3e-6, -1e-7])
    ta, tbb = torch.from_numpy(a), torch.from_numpy(b)
    for kw in ({}, {"atol": 1e-5}, {"atol": 0.0, "rtol": 2e-6}):
        np.testing.assert_array_equal(tvc.approx_equal(ta, tbb, **kw).numpy(),
                                      np.asarray(jvc.approx_equal(a, b, **kw)))
    np.testing.assert_array_equal(tvc.approx_zero(tbb).numpy(), np.asarray(jvc.approx_zero(b)))
    # the tie |a − b| = rtol·min(|a|, |b|) counts as equal in both
    x, y = np.array([1.0, 4.0]), np.array([1.5, 4.0])
    np.testing.assert_array_equal(tvc.essentially_equal(x, y, rtol=0.5).numpy(),
                                  np.asarray(jvc.essentially_equal(x, y, rtol=0.5)))
    np.testing.assert_array_equal(tvc.essentially_equal(ta, tbb).numpy(),
                                  np.asarray(jvc.essentially_equal(a, b)))
    p = Primal(xs=torch.zeros(2, 3), us=torch.ones(2), dt=torch.tensor(0.3))
    q = Primal(xs=torch.zeros(2, 3), us=torch.ones(2) + 1e-7, dt=torch.tensor(0.3))
    assert tvc.all_close(p, q) and not tvc.all_close(p, q, atol=0.0)


def test_torch_persistent_cache_moves_the_native_builds(tmp_path):
    before = compilation_cache.build_dir()
    assert before == compilation_cache.DEFAULT_BUILD_DIR == native.BUILD_DIR
    try:
        where = compilation_cache.enable_persistent_cache(str(tmp_path / "cache"))
        assert where == str(tmp_path / "cache") and compilation_cache.build_dir() == tmp_path / "cache"
        lib = native.build()
        assert lib.parent == tmp_path / "cache" and lib.exists()
        assert nvcc_build.library_path(nvcc_build.CSRC / "riccati_sweep.cu").parent == \
            tmp_path / "cache"
        assert native.build() == lib  # found, not built again
    finally:
        compilation_cache.enable_persistent_cache(str(before))
    assert compilation_cache.build_dir() == before
