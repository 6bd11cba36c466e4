"""The float64 straggler tier (``make_f64_fallback``) on the port against the
JAX package's (CPU).

The f32 result both tiers take is JAX's own mid-budget cold solve of a
shortened-goal ensemble (a mix of converged and unconverged lanes), handed
over through numpy, with one lane made diverged (a NaN iterate). Both
tiers run float64 at a converge-or-exhaust budget: continuation, then a
fresh solve, merged where float64 converged. The merged results agree on
the conv flags and within 1e-6 (float32 leaves from float64 solves that
differ by rounding only). Pinned besides: the tier takes every unconverged
lane, whatever its violation (the reference's quirk); a lane it does not
rescue, and every converged lane, keeps its float32 result bit for bit.
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
from mpc_local_planner_tpu.solvers import al_sqp as j_al
from mpc_local_planner_tpu.solvers.f64_fallback import make_f64_fallback as j_fallback

from mpc_local_planner_tpu_torch import benchmarks as tb
from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.ocp import grid as t_grid
from mpc_local_planner_tpu_torch.ocp.spec import Scenario
from mpc_local_planner_tpu_torch.solvers import al_sqp, f64_fallback
from mpc_local_planner_tpu_torch.solvers.f64_fallback import make_f64_fallback

B, N, DIVERGED = 10, 8, 3
TIER = dict(n_al=6, n_sqp=8, tol_eq=1e-3, tol_ineq=1e-3, early_exit=True)


def np_tree(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: np_tree(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _case():
    """(JAX spec, scenarios, f32 result with lane DIVERGED blown up, JAX
    tier's merged result), numpy trees."""
    jspec = jb.config3_carlike_min_time(N=N, obstacle_cap=0)
    tiny = j_al.SolverSettings.for_spec(jspec, n_al=6, n_sqp=8)
    scen = jb.random_ensemble(jspec, B, jax.random.PRNGKey(2), dtype=jnp.float32)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.4 * (scen.xf - scen.x0))
    duals = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape),
                                   j_al.init_duals(jspec, tiny, jnp.float32))
    r = jax.jit(jax.vmap(lambda s, i, d: j_al.solve_single(jspec, tiny, s, i, d)))(
        scen, j_initial_primal(jspec, scen), duals)
    xs = r.primal.xs.at[DIVERGED].set(jnp.nan)
    r = dataclasses.replace(r, primal=dataclasses.replace(r.primal, xs=xs),
                            eq_norm=r.eq_norm.at[DIVERGED].set(jnp.nan),
                            converged=r.converged.at[DIVERGED].set(False))
    deep = j_al.SolverSettings.for_spec(jspec, **TIER)
    merged = j_fallback(jspec, deep, slots=8)(scen, r)
    return np_tree(scen), np_tree(r), np_tree(merged)


def _port_args():
    scen, r, _ = _case()
    return convert.from_numpy(Scenario, scen, "cpu"), convert.from_numpy(
        al_sqp.SolveResult, r, "cpu")


def _tier(slots=8):
    spec = tb.config3_carlike_min_time(N=N, obstacle_cap=0)
    return spec, make_f64_fallback(spec, al_sqp.SolverSettings.for_spec(spec, **TIER),
                                   slots=slots, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def test_torch_f64_fallback_matches_jax():
    _, r, want = _case()
    conv0 = r["converged"]
    assert 0 < conv0.sum() < B - 1 and not conv0[DIVERGED]
    _, fb = _tier()
    got = convert.to_numpy(fb(*_port_args()))
    np.testing.assert_array_equal(got["converged"], want["converged"])
    assert got["converged"].sum() > conv0.sum() and got["converged"][DIVERGED]
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg=name)


def test_torch_f64_fallback_keeps_what_it_does_not_rescue_bit_for_bit():
    scen, r = _port_args()
    _, fb = _tier()
    out = fb(scen, r)
    before, after = convert.to_numpy(r), convert.to_numpy(out)
    untouched = ~after["converged"] | before["converged"]
    assert not (before["converged"] & ~after["converged"]).any()  # never true → false
    for (name, a), (_, b) in zip(_leaves(after), _leaves(before)):
        np.testing.assert_array_equal(a[untouched], b[untouched], err_msg=name)
    assert out.primal.xs.dtype == torch.float32


def test_torch_f64_fallback_takes_every_unconverged_lane(monkeypatch):
    """The reference's quirk, kept: the tier fires on every lane whose
    converged flag is false, a lane just over the tolerance and a diverged
    one alike, and on no converged lane."""
    scen, r = _port_args()
    near = int(np.nonzero(~r.converged.numpy())[0][-1])
    r = dataclasses.replace(r, eq_norm=r.eq_norm.clone().index_fill_(0, torch.tensor([near]),
                                                                    1.01e-3))
    seen = []
    real = f64_fallback.make_solver

    def spy(spec, settings, device):
        solve = real(spec, settings, device)

        def recording(scen_k, init, duals):
            seen.append(scen_k.xf.clone())
            return solve(scen_k, init, duals)

        return recording

    monkeypatch.setattr(f64_fallback, "make_solver", spy)
    _, fb = _tier(slots=16)
    fb(scen, r)
    lanes = {int(i) for x in seen[:1]
             for i in torch.nonzero((x[:, None, :] == scen.xf.double()[None]).all(-1))[:, 1]}
    assert lanes == set(np.nonzero(~r.converged.numpy())[0].tolist())
    assert DIVERGED in lanes and near in lanes


def test_torch_f64_fallback_chunks_cover_every_straggler():
    scen, r = _port_args()
    _, fb8 = _tier(slots=8)
    _, fb2 = _tier(slots=2)
    a, b = convert.to_numpy(fb8(scen, r)), convert.to_numpy(fb2(scen, r))
    np.testing.assert_array_equal(a["converged"], b["converged"])
    np.testing.assert_allclose(a["primal"]["xs"], b["primal"]["xs"], atol=1e-6, rtol=0)


def test_torch_f64_fallback_seeds_from_fresh_primal_and_is_identity_when_all_converged():
    scen, r = _port_args()
    spec, fb = _tier()
    plan = torch.stack([scen.x0, 0.5 * (scen.x0 + scen.xf), scen.xf], dim=-2)
    fresh = t_grid.primal_from_plan(spec, plan, scen.x0)
    out = fb(scen, r, fresh_primal=fresh)
    assert bool(out.converged[DIVERGED])
    done = dataclasses.replace(r, converged=torch.ones_like(r.converged))
    assert fb(scen, done) is done
    with pytest.raises(ValueError, match="slots"):
        make_f64_fallback(spec, al_sqp.SolverSettings(), slots=0, device="cpu")
