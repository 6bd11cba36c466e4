"""Via points (the ``minimum_time_via_points`` objective, ROADMAP M9a) on the
CPU, against the JAX package, from seeded numpy inputs handed to both:

- ``ocp/costs.py``: ``via_stage_assignment`` (unordered: the first minimum
  over the N+1 states; ordered: the cumulative cursor that an inactive slot
  never moves) and ``via_points_cost`` (the orientation term wrapped), at
  1e-12 and exactly for the stages, on random inputs, on the fixtures of
  ``tests/test_via_ordered.py`` and on exact ties (a via point halfway
  between two states, a repeated last state), with a candidate axis in
  front;
- the fused kernel's closed forms (``fused_kkt_system``: the via rows on the
  x, y and θ diagonal of the stage and terminal blocks) against the AD path
  (``al_sqp._kkt_system``) at 1e-10 in float64, at random iterates, with
  exact assignment ties and with θ errors across the wrap at ±π;
- the kernel's scope and bound: via points up to 8 slots, any number of
  obstacle slots, of candidates and of stages; ``step_structure`` against
  the plain tensors; ``k2a_flops`` counts the sweeps;
- F1: the plain version and the un-fused solve at 30 obstacle slots (the
  example configs' capacity, which the kernel once refused) against JAX
  ``vmap(solve_single)`` at 1e-9 in float64 on every lane (the multipliers
  at 1e-9 + ρ·1e-13, ``tests/test_torch_footprints_lp_solves.py``'s rule).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp import costs as j_costs
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.solvers import al_sqp as j_al

from test_torch_fused import KKT_NAMES, _iterate
from test_torch_footprints_lp_solves import _assert_f64_matches
from test_torch_quadratic import np_tree, to_torch
from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ocp import costs as t_costs
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.solvers import al_sqp

N = 8


def _specs(ordered=False, ow=0.0, mv=3, **kw):
    """The via-points family at N=8 (JAX and port), ordered or not, with
    orientation weight ``ow`` and ``mv`` slots."""
    over = dict(via_points_ordered=ordered, via_orientation_weight=ow, via_cap=mv, **kw)
    return (dataclasses.replace(jb.family_spec("via_points", N=N), **over),
            dataclasses.replace(tb.family_spec("via_points", N=N), **over))


def _line(n=25, length=3.0):
    """A straight line along x with n exactly spaced states (θ = 0)."""
    xs = np.zeros((n, 3))
    xs[:, 0] = np.linspace(0.0, length, n)
    return xs


def _assign_both(ordered, xs, vias, mask):
    jspec, tspec = _specs(ordered, mv=vias.shape[-2])
    k_j = np.asarray(j_costs.via_stage_assignment(jspec, jnp.asarray(xs), jnp.asarray(vias),
                                                  jnp.asarray(mask)))
    T = torch.from_numpy
    k_t = t_costs.via_stage_assignment(tspec, T(xs), T(vias), T(mask)).numpy()
    return k_t, k_j


# --------------------------------------------------------------------------- #
# the assignment and the cost
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("ordered", [False, True], ids=["unordered", "ordered"])
def test_torch_via_assignment_matches_jax_on_random_inputs(ordered):
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(5, N + 1, 3))
    vias = rng.normal(size=(5, 4, 3))
    mask = rng.uniform(size=(5, 4)) > 0.3
    k_t, k_j = _assign_both(ordered, xs, vias, mask)
    np.testing.assert_array_equal(k_t, k_j)
    if ordered:  # the active slots claim stages in list order
        for b in range(5):
            active = k_t[b][mask[b]]
            assert np.all(np.diff(active) >= 0)


def test_torch_via_ordered_fixtures_of_the_jax_tests():
    """``tests/test_via_ordered.py``: a crossing sequence moves the ordered
    cursor forward, and a masked slot never moves it."""
    xs = _line()
    vias = np.array([[2.0, 0.3, 0.0], [1.0, -0.3, 0.0]])
    k_un, k_un_j = _assign_both(False, xs, vias, np.array([True, True]))
    k_or, k_or_j = _assign_both(True, xs, vias, np.array([True, True]))
    np.testing.assert_array_equal(k_un, k_un_j)
    np.testing.assert_array_equal(k_or, k_or_j)
    assert k_un[0] > k_un[1] and k_or[1] >= k_or[0] and k_or[0] == k_un[0]
    # slot 1 masked (it would claim the last stage); slot 2 must not start
    # from it
    vias = np.array([[1.0, 0.0, 0.0], [3.0, 0.0, 0.0], [1.5, 0.0, 0.0]])
    mask = np.array([True, False, True])
    k, k_j = _assign_both(True, xs, vias, mask)
    np.testing.assert_array_equal(k, k_j)
    assert k[1] == 24 and k[0] <= k[2] < 20


@pytest.mark.parametrize("ordered", [False, True], ids=["unordered", "ordered"])
def test_torch_via_assignment_takes_the_first_of_exact_ties(ordered):
    """A via point exactly halfway between two states (0.375 between 0.25
    and 0.5), and a repeated last state (a shifted warm start repeats it):
    both packages take the first stage."""
    xs = _line(9, 2.0)            # x = 0, 0.25, ..., 2.0
    xs[8] = xs[7]                 # the last state repeated
    vias = np.array([[0.375, 0.0, 0.0], [1.75, 0.5, 0.0], [0.375, 0.0, 0.0]])
    mask = np.array([True, True, True])
    k, k_j = _assign_both(ordered, xs, vias, mask)
    np.testing.assert_array_equal(k, k_j)
    if ordered:
        np.testing.assert_array_equal(k, [1, 7, 7])  # the cursor at 7 after slot 1
    else:
        np.testing.assert_array_equal(k, [1, 7, 1])


@pytest.mark.parametrize("ordered", [False, True], ids=["unordered", "ordered"])
@pytest.mark.parametrize("ow", [0.0, 0.5], ids=["position", "orientation"])
def test_torch_via_cost_matches_jax(ordered, ow):
    """Random inputs with the states' and the via points' headings on both
    sides of ±π (the wrapped error), a candidate axis in front of the lane
    axis, masked slots adding nothing."""
    rng = np.random.default_rng(5)
    C, B = 3, 4
    xs = rng.normal(size=(C, B, N + 1, 3))
    xs[..., 2] = rng.choice([np.pi - 0.05, -np.pi + 0.05], size=(C, B, N + 1)) + rng.uniform(
        -0.02, 0.02, size=(C, B, N + 1))
    vias = rng.normal(size=(B, 3, 3))
    vias[..., 2] = rng.choice([np.pi - 0.02, -np.pi + 0.03], size=(B, 3))
    mask = rng.uniform(size=(B, 3)) > 0.3
    jspec, tspec = _specs(ordered, ow)
    want = np.asarray(j_costs.via_points_cost(jspec, jnp.asarray(xs), jnp.asarray(vias),
                                              jnp.asarray(mask)))
    T = torch.from_numpy
    got = t_costs.via_points_cost(tspec, T(xs), T(vias), T(mask)).numpy()
    assert got.shape == (C, B)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    if ow:  # across ±π the heading errors are at most 0.1, not 2π − 0.1
        _, pos_only = _specs(ordered, 0.0)
        plain = t_costs.via_points_cost(pos_only, T(xs), T(vias), T(mask)).numpy()
        assert np.all(got - plain <= 3 * ow * 0.1**2)
    off = t_costs.via_points_cost(tspec, T(xs), T(vias), T(np.zeros_like(mask))).numpy()
    np.testing.assert_array_equal(off, 0.0)


def test_torch_total_cost_adds_the_via_attraction():
    jspec, tspec = _specs(True, 0.5)
    js = jb.family_ensemble("via_points", jb.family_spec("via_points", N=N), 4,
                            jax.random.PRNGKey(0), dtype=jnp.float64)
    js = dataclasses.replace(js, via_points=js.via_points[:, :3], via_mask=js.via_mask[:, :3])
    rng = np.random.default_rng(2)
    xs = np.asarray(j_initial_primal(jspec, js).xs) + 0.1 * rng.normal(size=(4, N + 1, 3))
    us, dt = rng.normal(size=(4, N, 2)), rng.uniform(0.2, 0.4, size=4)
    want = np.asarray(j_costs.total_cost(jspec, jnp.asarray(xs), jnp.asarray(us),
                                         jnp.asarray(dt), js))
    ts = convert.from_numpy(Scenario, np_tree(js), "cpu")
    T = torch.from_numpy
    got = t_costs.total_cost(tspec, T(xs), T(us), T(dt), ts).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    assert np.all(got > N * dt)  # the attraction adds to N·dt


# --------------------------------------------------------------------------- #
# the closed forms against the AD path (float64)
# --------------------------------------------------------------------------- #
def _via_iterate(seed, ordered, ties=False, wrap=False):
    """``test_torch_fused._iterate``'s flagship iterate with 3 via slots (one
    masked) near the trajectory; ``ties``: via points exactly equidistant
    from two states; ``wrap``: headings near ±π at the states and the via
    points, so that the wrapped errors cross it."""
    spec, st, scen, primal, duals = _iterate(seed)
    spec = dataclasses.replace(spec, objective="minimum_time_via_points", via_cap=3,
                               via_position_weight=2.0, via_orientation_weight=0.5,
                               via_points_ordered=ordered)
    rng = np.random.default_rng(seed)
    xs = primal.xs.clone()
    B = xs.shape[0]
    k = torch.tensor([2, 5, 7])
    vp = xs[:, k] + torch.from_numpy(0.05 * rng.normal(size=(B, 3, 3)))
    if ties:
        vp[:, :, :2] = 0.5 * (xs[:, k, :2] + xs[:, k + 1, :2])
        xs[:, N] = xs[:, N - 1]  # a repeated last state
        vp[:, 2, :2] = xs[:, N, :2]
    if wrap:
        xs[:, :, 2] = math.pi - 0.01 * torch.arange(N + 1, dtype=xs.dtype)
        vp[:, :, 2] = -math.pi + 0.02
    mask = torch.tensor([True, False, True]).expand(B, 3).clone()
    scen = dataclasses.replace(scen, via_points=vp.contiguous(), via_mask=mask)
    return spec, scen, dataclasses.replace(primal, xs=xs), duals


@pytest.mark.parametrize("case", ["random", "ties", "wrap"])
@pytest.mark.parametrize("ordered", [False, True], ids=["unordered", "ordered"])
def test_torch_via_closed_forms_match_the_ad_path(ordered, case):
    spec, scen, primal, duals = _via_iterate(7, ordered, ties=case == "ties",
                                             wrap=case == "wrap")
    obs_k = al_sqp._stage_obstacles(spec, scen, primal.dt, N + 1)
    ad = al_sqp._kkt_system(spec, al_sqp._make_stage_fns(spec), al_sqp._make_terminal_fns(spec),
                            primal, scen, duals, obs_k)
    cf = k2a.fused_kkt_system(spec, primal, scen, duals, obs_k)
    for name, a, b in zip(KKT_NAMES, cf, ad):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float64, name
        torch.testing.assert_close(a, b, atol=1e-10, rtol=0, msg=name)
    # the via rows engage: without them the θ diagonal of a min-time stage
    # with one disc at the pose would be 0
    w = al_sqp._via_weights(spec, primal.xs, scen)
    assert float(w.sum()) == 2.0 * primal.xs.shape[0]  # two active slots per lane
    hzz = cf[3]
    assert bool((hzz[..., 2, 2] == 2.0 * 0.5 * w[:, :N].sum(-1)).all())
    if case == "wrap":  # the errors are small across ±π
        assert float(torch.abs(cf[6][..., 2]).max()) < 1.0


# --------------------------------------------------------------------------- #
# scope, structure and the bound
# --------------------------------------------------------------------------- #
def test_torch_via_scope_has_no_slot_candidate_or_horizon_cap():
    _, spec = _specs(True, 0.5)
    assert k2a.fused_supported(spec)
    for over in (dict(via_cap=8), dict(obstacle_cap=30), dict(N=120)):
        assert k2a.fused_supported(dataclasses.replace(spec, **over)), over
    assert not k2a.fused_supported(dataclasses.replace(spec, via_cap=9))
    scen = tb.random_ensemble(spec, 4, torch.Generator().manual_seed(0), device="cpu")
    st = al_sqp.SolverSettings(n_al=4, n_sqp=4, alphas=tuple(0.9**i for i in range(17)))
    assert al_sqp.fused_dispatch_ok(spec, st, scen, torch.float32, "cuda")
    p = k2a._params(spec, st, scen.obstacles)
    assert (p.mv, p.via_ordered, p.via_pw, p.via_ow, p.quadratic) == (3, 1, 2.0, 0.5, 0)
    assert k2a._params(tb.family_spec("flagship", N=N), st, scen.obstacles).mv == 0


@pytest.mark.parametrize("ow", [0.0, 0.5])
def test_torch_via_step_structure_matches_the_plain_tensors(ow):
    spec, scen, primal, duals = _via_iterate(4, False)
    spec = dataclasses.replace(spec, via_orientation_weight=ow)
    obs_k = al_sqp._stage_obstacles(spec, scen, primal.dt, N + 1)
    kkt = dict(zip(KKT_NAMES, k2a.fused_kkt_system(spec, primal, scen, duals, obs_k)))
    for name, rows in k2a.step_structure(spec).items():
        want = k2a.structure_rows(rows)
        got = kkt[name].reshape((-1,) + kkt[name].shape[2:])
        if got.dim() == 2:
            got = got[:, None, :]
        for i, row in enumerate(want):
            for j, c in enumerate(row):
                if c is not None:
                    assert bool((got[:, i, j] == c).all()), (name, i, j)
    assert k2a.step_structure(spec)["Hzz"][2].split()[2] == ("v" if ow else "0")


def test_torch_via_flops_count_the_sweeps():
    flagship = tb.family_spec("flagship", N=30)
    path_d = tb.family_spec("via_points", N=30)
    base, via = k2a.k2a_flops(flagship, 3, 4, 3), k2a.k2a_flops(path_d, 3, 4, 3)
    # per iteration: the sweeps over 31 states of 4 slots and the costs at
    # the current states (α = 0, the assignment of the rows) and at 3
    # candidates, whose poses the merit already counts; the rows; at the
    # end one more sweep and cost
    sweep = 4 * 31 * 5
    per_iter = 4 * 8 + 4 * (sweep + 4 * 2)
    assert via - base == 12 * per_iter + sweep + 4 * 2 == 31_156
    half = torch.zeros((2, 4), dtype=torch.bool)
    half[:, :2] = True  # half the slots active: fewer rows and costs
    assert k2a.k2a_flops(path_d, 3, 4, 3, via_mask=half) < via
    ow = dataclasses.replace(path_d, via_orientation_weight=0.5)
    assert k2a.k2a_flops(ow, 3, 4, 3) > via


# --------------------------------------------------------------------------- #
# F1: 30 obstacle slots, against JAX (float64, every lane)
# --------------------------------------------------------------------------- #
B30, M30 = 12, 30
WARM = dict(n_al=2, n_sqp=3, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3,
            alphas=(1.0, 0.7, 0.5, 0.35, 0.22, 0.14, 0.08, 0.03))


@functools.lru_cache(maxsize=None)
def _jax_30_slots():
    """A warm state (one JAX 2×3 solve from the straight-line seed) and the
    JAX solve from it, at 30 circle slots, goals pulled in to 30%."""
    jspec = jb.config3_carlike_min_time(N=N, obstacle_cap=M30)
    scen = jb.random_ensemble(jspec, B30, jax.random.PRNGKey(17), dtype=jnp.float64)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.3 * (scen.xf - scen.x0))
    jst = j_al.SolverSettings(**WARM)
    duals = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B30,) + a.shape),
                                   j_al.init_duals(jspec, jst, jnp.float64))
    solve = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, jst, s, i, d)))
    first = solve(scen, j_initial_primal(jspec, scen), duals)
    inputs = (np_tree(scen), np_tree(first.primal), np_tree(first.duals))
    return inputs, np_tree(solve(scen, first.primal, first.duals))


@pytest.mark.parametrize("path", ["unfused", "plain"])
def test_torch_30_obstacle_slots_match_jax(path):
    (scen, init, duals), j = _jax_30_slots()
    spec = tb.config3_carlike_min_time(N=N, obstacle_cap=M30)
    st = al_sqp.SolverSettings(**WARM)
    ts, ti, td = to_torch(scen, init, duals)
    assert k2a.fused_supported(spec) and al_sqp.fused_dispatch_ok(spec, st, ts, torch.float32,
                                                                  "cuda")
    if path == "unfused":
        out = al_sqp.make_solver(spec, st, device="cpu")(ts, ti, td)
    else:
        out = k2a.fused_solve_plain(spec, st, ts, ti, td)
    t = convert.to_numpy(out)
    _assert_f64_matches(t, j)
    assert t["duals"]["mu_obs"].shape == (B30, N, M30)
    assert (t["duals"]["mu_obs"][..., 8:] > 0).any()  # slots beyond the old cap are live
    assert 0 < j["converged"].sum() < B30
