"""The serving stream: the port's ``planner/serving.py`` against the JAX
package's ``JourneyStream`` (CPU, float64).

Both streams run the stream of ``tests/test_serving.py`` (BASELINE config #1
at N=8 with dt_ref 0.4 and a fixed goal position, warm 2×4, E=4). Their
``redraw_fn`` returns the k-th of a list of numpy-made journey batches on its
k-th call, so both draw the same journeys. JAX's ``cycle`` is driven eagerly
(a traced cycle would fix the redraw at trace time), one cycle at a time;
its solves are the same functions jitted on the JAX stream object (compiled
once) and its fresh duals take the scenarios' float64, as the port's do (JAX
builds them in float32 by default, which float64 scenarios do not admit).
Before each cycle JAX's state is handed to the port through numpy, so
nothing drifts: ``init`` and three cycles (the second retires two stuck
lanes and runs the early-exit cold replant) are held together, the states
(scenarios, primal, duals, ``stuck``) and every ``CycleStats`` field, floats
within 1e-9 plus ten times JAX's own move from the state one ulp away, the
multipliers also within 1e-9 of the lane's largest multiplier (the rule of
``tests/test_torch_controller.py``); flags and counters exact.
``collect_abandoned``'s rows and ``audit_abandoned``'s oracle count equal
JAX's.

The five invariants of ``tests/test_serving.py`` are pinned on the port: a
retired lane redraws and the others keep their journey; results of lanes
that do not retire survive a redraw cycle bit for bit; the chained rescue
touches only unconverged lanes; the stuck counter resets and abandons;
``block_fn`` equals iterated cycles.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.planner import serving as js
from mpc_local_planner_tpu.solvers.al_sqp import SolverSettings as JSettings

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.core.tree import tree_map
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.planner import serving as ts
from mpc_local_planner_tpu_torch.solvers.al_sqp import SolveResult
from mpc_local_planner_tpu_torch.solvers.al_sqp import SolverSettings as TSettings
from test_torch_controller import _np, assert_cycle_matches, obstacles_np, to_jax

E = 4
WARM = dict(n_al=2, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
            alphas=(1.0, 0.5, 0.22))


def spec_pair():
    def cut(spec):
        return dc.replace(spec, dt_ref=0.4, xf_fixed=(True, True, False))

    return cut(jb.config1_unicycle_quadratic(N=8)), cut(tb.config1_unicycle_quadratic(N=8))


def journeys_np(rng, n=E):
    """``random_ensemble``'s journeys at goal radius 1 (no obstacle slot in
    config #1), float64."""
    ang = rng.uniform(-0.8, 0.8, n)
    dist = rng.uniform(0.6, 1.0, n)
    xf = np.stack([dist * np.cos(ang), dist * np.sin(ang), ang], axis=-1)
    z = np.zeros
    return dict(x0=z((n, 3)), xf=xf,
                obstacles=obstacles_np((n,), z((n, 0, 2)), z((n, 0)), z((n, 0), bool)),
                via_points=z((n, 0, 3)), via_mask=z((n, 0), bool), u_prev=z((n, 2)))


class Draws:
    """The k-th batch on the k-th call (set ``calls`` back to draw again)."""

    def __init__(self, batches):
        self.batches, self.calls = batches, 0

    def take(self):
        self.calls += 1
        return self.batches[self.calls - 1]


def streams(draws, settings=js.StreamSettings()):
    jspec, tspec = spec_pair()
    jst = js.JourneyStream(jspec, JSettings(**WARM), settings=settings,
                           redraw_fn=lambda key, n: to_jax(draws.take()))
    # the same solve functions, compiled once on this object; fresh duals in
    # the scenarios' float64 (the port builds them in the scenarios' dtype)
    jst._warm_solve = jax.jit(jst._warm_solve)
    jst._cold_ee_solve = jax.jit(jst._cold_ee_solve)
    jst._duals0 = lambda n, dtype=jnp.float64: js.JourneyStream._duals0(jst, n, dtype)
    tst = ts.JourneyStream(
        tspec, TSettings(**WARM), redraw_fn=lambda gen, n: convert.from_numpy(
            TScenario, draws.take(), "cpu"), settings=settings, device="cpu")
    return jst, tst


# --------------------------------------------------------------------------- #
# states as flat numpy dicts
# --------------------------------------------------------------------------- #
def _walk(out, prefix, tree):
    if dc.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name) for f in dc.fields(tree)}
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk(out, f"{prefix}.{k}", v)
    else:
        out[prefix] = _np(tree)


def flat_state(state, stats=None):
    out = {}
    _walk(out, "scen", state.scen)
    _walk(out, "result", state.result)
    out["stuck"] = _np(state.stuck)
    if stats is not None:
        _walk(out, "stats", stats)
    # the duals rule of assert_cycle_matches is keyed on ".duals."
    return out


def to_port(jstate):
    """JAX's StreamState handed to the port through numpy."""
    np_tree = jax.tree_util.tree_map(np.asarray, jstate)
    return ts.StreamState(
        scen=convert.from_numpy(TScenario, np_tree.scen, "cpu"),
        result=convert.from_numpy(SolveResult, np_tree.result, "cpu"),
        stuck=torch.from_numpy(np.array(np_tree.stuck)), generator=torch.Generator(),
    )


def one_ulp(jstate):
    scen = jstate.scen
    return dc.replace(jstate, scen=dc.replace(
        scen, x0=jnp.nextafter(scen.x0, jnp.inf), xf=jnp.nextafter(scen.xf, jnp.inf)))


@pytest.fixture(scope="module")
def parity_run():
    """init and three cycles of both streams (JAX's state handed over before
    each), with JAX's own one-ulp moves."""
    rng = np.random.default_rng(0)
    draws = Draws([journeys_np(rng) for _ in range(8)])
    jst, tst = streams(draws)
    # init draws batch 0 on both; JAX's move from the batch one ulp away
    first = draws.batches[0]
    draws.batches[0] = dict(first, x0=np.nextafter(first["x0"], np.inf),
                            xf=np.nextafter(first["xf"], np.inf))
    moved = jst.init(E, jax.random.PRNGKey(0))
    draws.batches[0], draws.calls = first, 0
    jstate = jst.init(E, jax.random.PRNGKey(0))
    draws.calls = 0
    tstate = tst.init(E, torch.Generator())
    steps = [(flat_state(tstate), flat_state(jstate), flat_state(moved))]
    j_stats, t_stats = [], []
    for _ in range(3):
        calls = draws.calls
        moved = flat_state(*jst.cycle(one_ulp(jstate)))
        draws.calls = calls
        t_next, t_st = tst.cycle(to_port(jstate))
        draws.calls = calls
        j_next, j_st = jst.cycle(jstate)
        steps.append((flat_state(t_next, t_st), flat_state(j_next, j_st), moved))
        j_stats.append(j_st)
        t_stats.append(t_st)
        jstate = j_next
    return jst, tst, steps, j_stats, t_stats


def test_torch_stream_init_and_cycles_match_jax(parity_run):
    _, _, steps, j_stats, _ = parity_run
    for got, want, moved in steps:
        assert_cycle_matches(got, want, moved, batched=True)
    # the run covers the branches: lanes converge, lanes abandon (the replant)
    assert any(np.asarray(s.converged).any() for s in j_stats)
    assert any(np.asarray(s.abandoned).any() for s in j_stats)


def _stack_np(stats):
    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *stats)


def test_torch_collect_and_audit_abandoned_match_jax(parity_run):
    jst, tst, _, j_stats, t_stats = parity_run
    j_rows, j_n = js.JourneyStream.collect_abandoned(_stack_np(j_stats))
    t_block = tree_map(lambda *xs: torch.stack(xs), t_stats[0], *t_stats[1:])
    t_rows, t_n = ts.JourneyStream.collect_abandoned(t_block)
    assert t_n == j_n > 0
    got, want = {}, {}
    _walk(got, "rows", t_rows)
    _walk(want, "rows", j_rows)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    t_audit, j_audit = tst.audit_abandoned(t_rows), jst.audit_abandoned(j_rows)
    assert t_audit == j_audit
    empty = tst.audit_abandoned(dc.replace(t_rows, x0=t_rows.x0[:0]))
    assert empty == {"n_abandoned": 0, "false_abandon_oracle": 0}


def test_torch_stream_solves_are_unfused_and_need_a_redraw_fn():
    jspec, tspec = spec_pair()
    with pytest.raises(ValueError, match="redraw_fn"):
        ts.JourneyStream(tspec, TSettings(**WARM), device="cpu")
    # on CPU tensors the KKT solve is the plain lqr_solve: K1 never launches
    before = riccati_cuda.lqr_solve_cuda.launches
    stream = ts.JourneyStream(tspec, TSettings(**WARM, early_exit=True),
                              redraw_fn=lambda g, n: tb.random_ensemble(
                                  tspec, n, g, device="cpu", goal_radius=1.0), device="cpu")
    state, stats = stream.block_fn(1)(stream.init(2, torch.Generator().manual_seed(3)))
    assert riccati_cuda.lqr_solve_cuda.launches == before
    assert stats.converged.shape == (1, 2) and state.stuck.dtype == torch.int32


# --------------------------------------------------------------------------- #
# the invariants of tests/test_serving.py, on the port
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def stream_bits():
    _, spec = spec_pair()
    warm = TSettings(**WARM)

    def redraw(gen, n):
        return tb.random_ensemble(spec, n, gen, goal_radius=1.0, device="cpu")

    stream = ts.JourneyStream(spec, warm, redraw_fn=redraw, device="cpu")
    state = stream.init(E, torch.Generator().manual_seed(0))
    return spec, warm, redraw, stream, state


def _fresh_gen(state, seed=11):
    return dc.replace(state, generator=torch.Generator().manual_seed(seed))


def _near_goal(state):
    """Lane 0 moved onto its goal and marked unconverged (a converged lane's
    x0 would advance along its previous solution)."""
    x0 = state.scen.x0.clone()
    x0[0] = state.scen.xf[0]
    conv = state.result.converged.clone()
    conv[0] = False
    return dc.replace(state, scen=dc.replace(state.scen, x0=x0),
                      result=dc.replace(state.result, converged=conv))


def test_torch_retired_lane_redraws_others_keep_journey(stream_bits):
    _, _, _, stream, state = stream_bits
    st = _near_goal(_fresh_gen(state))
    xf_before = st.scen.xf.clone()
    new_state, stats = stream.cycle(st)
    assert bool(stats.reached[0]), "lane 0 sits on its goal: it retires as reached"
    assert not torch.allclose(new_state.scen.xf[0], xf_before[0])
    for b in range(1, E):
        if not stats.reached[b] and not stats.abandoned[b]:
            assert torch.equal(new_state.scen.xf[b], xf_before[b])
    assert int(new_state.stuck[0]) == 0


def test_torch_nonretired_results_survive_redraw_bit_identically(stream_bits):
    _, _, _, stream, state = stream_bits
    st_retire = _near_goal(state)
    x0 = st_retire.scen.x0.clone()
    x0[0] = state.scen.x0[0]
    st_plain = dc.replace(st_retire, scen=dc.replace(st_retire.scen, x0=x0))
    s_a, stats_a = stream.cycle(_fresh_gen(st_retire))
    s_b, stats_b = stream.cycle(_fresh_gen(st_plain))
    retire_a = stats_a.reached | stats_a.abandoned
    retire_b = stats_b.reached | stats_b.abandoned
    assert bool(retire_a[0]), "lane 0 must retire in the first state"
    live = ~retire_a & ~retire_b
    live[0] = False
    assert bool(live.any())
    for b in torch.nonzero(live).reshape(-1).tolist():
        assert torch.equal(s_a.result.primal.xs[b], s_b.result.primal.xs[b])
        assert torch.equal(s_a.result.converged[b], s_b.result.converged[b])
        assert torch.equal(s_a.scen.xf[b], s_b.scen.xf[b])


def test_torch_chained_rescue_only_touches_unconverged(stream_bits):
    spec, warm, redraw, _, state = stream_bits
    on = ts.JourneyStream(spec, warm, redraw_fn=redraw, device="cpu", settings=ts.StreamSettings(
        chained_rescue=True, cold_replant=False))
    off = ts.JourneyStream(spec, warm, redraw_fn=redraw, device="cpu", settings=ts.StreamSettings(
        chained_rescue=False, cold_replant=False))
    s_on, _ = on.cycle(_fresh_gen(state))
    s_off, _ = off.cycle(_fresh_gen(state))
    conv_first = s_off.result.converged
    assert bool(conv_first.any())
    for b in torch.nonzero(conv_first).reshape(-1).tolist():
        assert torch.equal(s_on.result.primal.xs[b], s_off.result.primal.xs[b])


def test_torch_stuck_counter_resets_and_abandons(stream_bits):
    _, _, _, stream, state = stream_bits
    xf = state.scen.xf.clone()
    xf[1, 0] = 50.0  # out of reach of the 8-stage grid at these limits
    conv = state.result.converged.clone()
    conv[1] = False
    st = dc.replace(_fresh_gen(state), scen=dc.replace(state.scen, xf=xf),
                    result=dc.replace(state.result, converged=conv))
    st1, stats1 = stream.cycle(st)
    assert not bool(stats1.converged[1])
    assert int(st1.stuck[1]) == 1
    st2, stats2 = stream.cycle(st1)
    assert bool(stats2.abandoned[1])  # stuck_limit 2
    assert int(st2.stuck[1]) == 0
    # the audit record holds the journey at abandon time, zeros elsewhere
    assert float(stats2.abandoned_scen.xf[1, 0]) == pytest.approx(50.0)
    for b in torch.nonzero(~stats2.abandoned).reshape(-1).tolist():
        assert bool((stats2.abandoned_scen.xf[b] == 0).all())
    for b in torch.nonzero(stats1.converged).reshape(-1).tolist():
        assert int(st1.stuck[b]) == 0


def test_torch_block_fn_matches_iterated_cycles(stream_bits):
    _, _, _, stream, state = stream_bits
    s_block, stats = stream.block_fn(3)(_fresh_gen(state))
    s_iter = _fresh_gen(state)
    for _ in range(3):
        s_iter, _ = stream.cycle(s_iter)
    assert torch.equal(s_block.result.primal.xs, s_iter.result.primal.xs)
    assert torch.equal(s_block.scen.xf, s_iter.scen.xf)
    assert stats.converged.shape == (3, E) and stats.abandoned_scen.x0.shape == (3, E, 3)
    assert isinstance(s_block, ts.StreamState)
