"""The port's meshes and sharded ensemble solves on the CPU
(``parallel/sharding.py``, ``parallel/dryrun.py``).

PyTorch has one CPU device, so a mesh of ``[cpu] * 8`` stands in for the
JAX package's 8 virtual CPU devices (``tests/conftest.py``): eight shards of
the batch, each solved alone. On the min-time fixture of JAX's
``test_sharded_per_shard_rescue_matches_manual_blocks`` (N=8, 16 lanes, goals
pulled in to 40%, float64; here at warm budgets, 3×3 with a 4×4 rescue and
the fleet cycle's ρ0, reg0 and tolerances, which leave a mix of converged
lanes and a block of two stragglers) the port's sharded
solve, its per-shard rescue and the early-exit serving composition are held
against JAX's ``make_sharded_solver`` on its 8-device mesh: conv flags
equal, xs and dt within 1e-9 plus ten times JAX's own move on the lane when
its initial states move by one ulp (the minimum-time steps amplify rounding:
that move reaches 3e-8 on a lane at a 6×8 budget), the early exit's flags
only (a shard's loop stops at its own straggler count). The rescue runs
with one slot a shard as well as with its block's two: with one, a block's
stragglers exceed its slots, and a rescue over the whole batch would rescue
other lanes than the per-shard one. The ensemble summary is held to JAX's
``ensemble_summary``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.parallel import sharding as js
from mpc_local_planner_tpu.solvers.al_sqp import SolverSettings as JSettings
from mpc_local_planner_tpu.solvers.al_sqp import init_duals as j_init_duals

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.ocp.grid import Primal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.parallel import sharding as ts
from mpc_local_planner_tpu_torch.parallel.dryrun import dryrun_multichip
from mpc_local_planner_tpu_torch.solvers import al_sqp
from mpc_local_planner_tpu_torch.solvers.rescue import make_rescue

B, N = 16, 8
CPU8 = [torch.device("cpu")] * 8
TINY = dict(n_al=3, n_sqp=3, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3)
DEEPER = dict(TINY, n_al=4, n_sqp=4)
EARLY_EXIT = dict(n_al=4, n_sqp=2, rho0=120.0, tol_eq=1e-3, tol_ineq=1e-3, early_exit=True)


def _np(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: _np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _fixture():
    """(JAX spec, port spec, JAX inputs, the same inputs as numpy trees)."""
    jspec = jb.config3_carlike_min_time(N=N, obstacle_cap=0)
    tspec = tb.config3_carlike_min_time(N=N, obstacle_cap=0)
    scen = jb.random_ensemble(jspec, B, jax.random.PRNGKey(2), dtype=jnp.float64)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.4 * (scen.xf - scen.x0))
    init = j_initial_primal(jspec, scen)
    duals = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (B,) + a.shape),
        j_init_duals(jspec, JSettings.for_spec(jspec, **TINY), dtype=jnp.float64),
    )
    return jspec, tspec, (scen, init, duals), tuple(_np(t) for t in (scen, init, duals))


def _torch_inputs():
    *_, (scen, init, duals) = _fixture()
    return (convert.from_numpy(Scenario, scen, "cpu"), convert.from_numpy(Primal, init, "cpu"),
            convert.from_numpy(al_sqp.DualState, duals, "cpu"))


@functools.lru_cache(maxsize=None)
def _jax_sharded(kind, slots=0):
    """JAX's make_sharded_solver on its 8-device mesh: 'plain' (tiny
    settings), 'rescue' (tiny, per-shard rescue at the deeper settings) or
    'early_exit' (with the per-shard rescue). Returns the result and each
    lane's largest |Δxs| or |Δdt| when the initial states move by one ulp."""
    jspec, _, (scen, init, duals), _ = _fixture()
    mesh = js.make_mesh()
    st = JSettings.for_spec(jspec, **(EARLY_EXIT if kind == "early_exit" else TINY))
    deeper = JSettings.for_spec(jspec, **DEEPER) if kind == "rescue" else None
    solver = js.make_sharded_solver(jspec, st, mesh, rescue_slots=slots, rescue_settings=deeper)
    out = solver(*(js.shard_batch(t, mesh) for t in (scen, init, duals)))
    up = dataclasses.replace(init, xs=jnp.nextafter(init.xs, jnp.inf))
    moved = solver(*(js.shard_batch(t, mesh) for t in (scen, up, duals)))
    move = np.maximum(
        np.abs(np.asarray(moved.primal.xs) - np.asarray(out.primal.xs)).reshape(B, -1).max(1),
        np.abs(np.asarray(moved.primal.dt) - np.asarray(out.primal.dt)))
    return out, move


def _port_sharded(kind, slots=0):
    _, tspec, _, _ = _fixture()
    st = al_sqp.SolverSettings.for_spec(tspec, **(EARLY_EXIT if kind == "early_exit" else TINY))
    deeper = al_sqp.SolverSettings.for_spec(tspec, **DEEPER) if kind == "rescue" else None
    mesh = ts.make_mesh(devices=CPU8)
    solver = ts.make_sharded_solver(tspec, st, mesh, rescue_slots=slots, rescue_settings=deeper)
    out = solver(*(ts.shard_batch(t, mesh) for t in _torch_inputs()))
    assert isinstance(out, ts.ShardedBatch) and len(out.blocks) == 8
    assert all(b.converged.shape == (B // 8,) for b in out.blocks)
    return out


def test_torch_mesh_shapes_axis_names_and_errors():
    jmesh, tmesh = js.make_mesh(), ts.make_mesh(devices=CPU8)
    assert tmesh.axis_names == jmesh.axis_names == ("dcn", "ici")
    assert tmesh.devices.shape == jmesh.devices.shape == (1, 8) and tmesh.size == 8
    assert ts.make_mesh(n_dcn=2, devices=CPU8).devices.shape == js.make_mesh(n_dcn=2).devices.shape
    assert ts.make_mesh(2, 4, devices=CPU8).shape == {"dcn": 2, "ici": 4}
    assert ts.batch_spec() == tuple(js.batch_spec()[0])
    with pytest.raises(ValueError):
        ts.make_mesh(3, 3, devices=CPU8)
    with pytest.raises(ValueError):
        js.make_mesh(3, 3)
    if not torch.cuda.is_available():  # the default is every local card
        with pytest.raises(RuntimeError):
            ts.make_mesh()


def test_torch_shard_batch_gives_contiguous_blocks_in_row_major_order():
    mesh = ts.make_mesh(2, 4, devices=CPU8)
    scen, init, _ = _torch_inputs()
    sharded = ts.shard_batch(init, mesh)
    assert sharded.devices == tuple(CPU8)
    for i, blk in enumerate(sharded.blocks):
        np.testing.assert_array_equal(blk.xs.numpy(), init.xs[2 * i:2 * i + 2].numpy())
        np.testing.assert_array_equal(blk.dt.numpy(), init.dt[2 * i:2 * i + 2].numpy())
    back = ts.gather(ts.shard_batch(scen, mesh))
    np.testing.assert_array_equal(back.obstacles.circles.numpy(), scen.obstacles.circles.numpy())
    np.testing.assert_array_equal(back.xf.numpy(), scen.xf.numpy())
    with pytest.raises(ValueError):
        ts.shard_batch(Primal(xs=init.xs[:12], us=init.us[:12], dt=init.dt[:12]), mesh)


def _assert_matches(port, jax_out, flags_only=False):
    jres, move = jax_out
    got = ts.gather(port)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(jres.converged))
    if not flags_only:
        tol = 1e-9 + 10.0 * move
        dxs = np.abs(got.primal.xs.numpy() - np.asarray(jres.primal.xs)).reshape(B, -1).max(1)
        ddt = np.abs(got.primal.dt.numpy() - np.asarray(jres.primal.dt))
        assert np.all(dxs <= tol), (dxs, tol)
        assert np.all(ddt <= tol), (ddt, tol)
    return got


def test_torch_sharded_solve_and_summary_match_jax_8_shards():
    port = _port_sharded("plain")
    jres, move = _jax_sharded("plain")
    _assert_matches(port, (jres, move))
    # unsharded: the same solve over the whole batch
    _, tspec, _, _ = _fixture()
    whole = ts.make_sharded_solver(tspec, al_sqp.SolverSettings.for_spec(tspec, **TINY),
                                   device="cpu")(*_torch_inputs())
    np.testing.assert_array_equal(whole.converged.numpy(), np.asarray(jres.converged))
    n_conv, mean_cost, max_eq, max_viol = (float(v) for v in jax.jit(js.ensemble_summary)(jres))
    got = ts.ensemble_summary(port)
    assert got.n_converged == int(n_conv) and 0 < got.n_converged < B
    np.testing.assert_allclose(got.mean_cost, mean_cost, rtol=1e-9)
    np.testing.assert_allclose(got.max_eq_norm, max_eq, rtol=1e-9)
    np.testing.assert_allclose(got.max_ineq_viol, max_viol, rtol=1e-9, atol=1e-15)
    # partials of 8 blocks against one block: the sums in another order
    one, eight = ts.ensemble_summary(whole), ts.ensemble_summary(
        ts.shard_batch(whole, ts.make_mesh(devices=CPU8)))
    assert one._replace(mean_cost=0.0) == eight._replace(mean_cost=0.0)
    np.testing.assert_allclose(eight.mean_cost, one.mean_cost, rtol=1e-14)


@pytest.mark.parametrize("slots", [1, 2])
def test_torch_per_shard_rescue_matches_jax_8_shards(slots):
    port = _port_sharded("rescue", slots)
    got = _assert_matches(port, _jax_sharded("rescue", slots))
    assert int(got.converged.sum()) > 0
    if slots == 2:
        return
    # one slot a shard: the per-block reference (the unsharded solve, then
    # make_rescue on each block), on a fixture with a block of two
    # stragglers, which a rescue over the whole batch with as many slots
    # would treat otherwise
    _, tspec, _, _ = _fixture()
    scen, init, duals = _torch_inputs()
    st = al_sqp.SolverSettings.for_spec(tspec, **TINY)
    deeper = al_sqp.SolverSettings.for_spec(tspec, **DEEPER)
    plain = al_sqp.make_solver(tspec, st, "cpu")(scen, init, duals)
    resc = make_rescue(tspec, st, 1, rescue_settings=deeper, device="cpu")
    conv = torch.cat([resc(*(tree_map(lambda a, i=i: a[2 * i:2 * i + 2], t)
                             for t in (scen, plain))).converged for i in range(8)])
    np.testing.assert_array_equal(got.converged.numpy(), conv.numpy())
    assert int((~plain.converged).reshape(8, 2).sum(1).max()) == 2
    assert 0 < int(conv.sum()) < B
    whole = make_rescue(tspec, st, 8, rescue_settings=deeper, device="cpu")(scen, plain)
    assert not torch.equal(whole.primal.xs, got.primal.xs)


def test_torch_sharded_early_exit_composition_flags_match_jax():
    port = _port_sharded("early_exit", slots=2)
    _assert_matches(port, _jax_sharded("early_exit", slots=2), flags_only=True)


def test_torch_dryrun_multichip_checks_pass_on_a_cpu_mesh():
    out = dryrun_multichip(ts.make_mesh(2, 2, devices=[torch.device("cpu")] * 4), "cpu",
                           spec=tb.config3_carlike_min_time(N=6, obstacle_cap=2),
                           lanes_per_shard=2, check_lanes_per_shard=3)
    assert out["shards"] == 4 and out["checks_lanes"] == 12
    assert out["cross_shard_max_abs_dxs"] <= 1e-4 and out["cross_shard_max_abs_dus"] <= 1e-4
    assert set(out["summary"]) == {"n_converged", "mean_cost", "max_eq_norm", "max_ineq_viol"}
