"""The port's checkpoint of a Controller's warm state (``checkpoint.py``) on
the CPU.

The snapshot is an ``.npz`` in the JAX package's layout, so each package
loads the other's:

* round trips in the port (one robot and a fleet of 4): the restored state
  equals the saved one bit for bit and the next step is the same; an empty
  snapshot resets; the standalone primal/dual snapshot round-trips;
* the JAX and port snapshots of the same cold step hold the same keys, shapes
  and dtypes (an unbatched Controller keeps no lane axis in either package);
* JAX → port: a JAX Controller's snapshot loaded into a fresh port
  Controller, whose next warm step is held to the JAX Controller's; and
  port → JAX: the port's snapshot loaded into the JAX Controller (back at
  its cold step's counters, so that its compiled solves are reused), whose
  next warm step is held to the port's. The tolerance is the Controller
  tests' (``tests/test_torch_controller.py``: flags and counters exact,
  floats within 1e-9 plus ten times JAX's own move from the scenario one ulp
  away), on the small minimum-time car of those tests, float64.
"""

import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import checkpoint as jck

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import checkpoint as tck
from mpc_local_planner_tpu_torch.core.value_comparison import all_close
from mpc_local_planner_tpu_torch.ocp.grid import initial_primal
from mpc_local_planner_tpu_torch.planner import Controller as TController
from mpc_local_planner_tpu_torch.planner import load_config as t_load
from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings, init_duals

from test_torch_controller import (
    advance,
    assert_cycle_matches,
    carlike,
    controllers,
    fleet_np,
    flat,
    one_ulp,
    single_np,
    to_jax,
    to_torch,
)

BATCHES = [None, 4]


def _tree(batch):
    if batch is None:
        return single_np([0.0, 0.0, 0.0], [1.4, 0.3, 0.2], [(0.7, 0.35, 0.15)], 3)
    return fleet_np(np.random.default_rng(11), batch)


def _port(cfg, batch):
    return TController(t_load(cfg), batch=batch, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("batch", BATCHES)
def test_torch_controller_state_round_trips_through_a_snapshot(tmp_path, batch):
    cfg = carlike()
    c1 = _port(cfg, batch)
    empty = str(tmp_path / "empty.npz")
    tck.save_controller_state(empty, c1)
    assert not tck.load_controller_state(empty, c1) and c1._primal is None
    tree = _tree(batch)
    c1.step(to_torch(tree))
    path = str(tmp_path / "state.npz")
    tck.save_controller_state(path, c1)
    c2 = _port(cfg, batch)
    assert tck.load_controller_state(path, c2)
    assert all_close(c1._primal, c2._primal, atol=0) and all_close(c1._duals, c2._duals, atol=0)
    for name in ("_last_goal", "_last_ok", "_last_diverged"):
        assert torch.equal(getattr(c1, name), getattr(c2, name)), name
    a, b = c1.step(to_torch(tree)), c2.step(to_torch(tree))
    assert torch.equal(a.u0, b.u0) and torch.equal(a.solve.primal.xs, b.solve.primal.xs)


def test_torch_solve_state_round_trips(tmp_path):
    spec = tb.config1_unicycle_quadratic(N=6)
    scen = tb.random_ensemble(spec, 3, torch.Generator().manual_seed(0), dtype=torch.float64,
                              device="cpu")
    primal = initial_primal(spec, scen)
    duals = init_duals(spec, SolverSettings(), dtype=torch.float64, batch=(3,))
    path = str(tmp_path / "solve.npz")
    tck.save_solve_state(path, primal, duals)
    p2, d2 = tck.load_solve_state(path, duals_template=duals, device="cpu")
    assert all_close(primal, p2, atol=0) and all_close(duals, d2, atol=0)
    assert tck.load_solve_state(path, device="cpu")[1] is None
    # the JAX package reads the same file
    jp, jd = jck.load_solve_state(path, duals_template=jck.DualState(*[0] * 8))
    np.testing.assert_array_equal(np.asarray(jp.us), primal.us.numpy())
    np.testing.assert_array_equal(np.asarray(jd.rho), duals.rho.numpy())


def _warm_step_matches(j_ctrl, t_ctrl, tree, batch):
    """One warm step of both Controllers from their own states, the port's
    held to JAX's (JAX also steps from the scenario one ulp away)."""
    before = dict(j_ctrl.__dict__)
    moved = flat(j_ctrl.step(to_jax(one_ulp(tree))), j_ctrl)
    j_ctrl.__dict__.update(before)
    j_res = j_ctrl.step(to_jax(tree))
    t_res = t_ctrl.step(to_torch(tree))
    assert_cycle_matches(flat(t_res, t_ctrl), flat(j_res, j_ctrl), moved,
                         batched=batch is not None)
    return j_res


@pytest.mark.parametrize("batch", BATCHES)
def test_torch_snapshots_cross_load_between_jax_and_the_port(tmp_path, batch):
    cfg = carlike()
    j_ctrl, t_ctrl = controllers(cfg, batch)
    tree = _tree(batch)
    j_res = j_ctrl.step(to_jax(tree))
    t_ctrl.step(to_torch(tree))
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jck.save_controller_state(pj, j_ctrl)
    tck.save_controller_state(pt, t_ctrl)
    with np.load(pj) as a, np.load(pt) as b:
        assert sorted(a.files) == sorted(b.files)
        assert {"primal_2", "duals_7", "last_goal", "last_ok", "last_diverged"} <= set(a.files)
        assert "duals_8" not in a.files
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    lanes = () if batch is None else (batch,)
    with np.load(pt) as b:
        assert b["duals_7"].shape == lanes and b["last_goal"].shape == lanes + (3,)
    tree = advance(tree, j_res)
    after_cold = dict(j_ctrl.__dict__)

    # JAX → port: a fresh port Controller resumes from JAX's snapshot
    t_from_jax = _port(cfg, batch)
    assert tck.load_controller_state(pj, t_from_jax)
    _warm_step_matches(j_ctrl, t_from_jax, tree, batch)

    # port → JAX: the JAX Controller, back at its cold step's counters (its
    # compiled solves kept), resumes from the port's snapshot in place of
    # its own state
    j_ctrl.__dict__.update(after_cold)
    assert jck.load_controller_state(pt, j_ctrl)
    np.testing.assert_array_equal(np.asarray(j_ctrl._primal.xs), t_ctrl._primal.xs.numpy())
    _warm_step_matches(j_ctrl, t_ctrl, tree, batch)
