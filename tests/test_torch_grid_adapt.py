"""Grid adaptation and the per-lane warm starts: the port against the JAX
package (CPU, f64).

``adapt_grid_size``'s decision table over a grid of dt values, horizons and
both time-based modes; ``resize_primal`` and ``resize_duals``;
``adapt_grid_nonuniform``'s merge, split and no-edit cases (the primal, the
stage duals and the 2N dt-box multipliers); the per-lane (tensor ``steps``)
``warm_start_shift``, ``warm_start_resample`` and ``shift_duals`` on a
uniform and a per-stage dt, with steps of 0, 1, N//2 and above N//2 (clipped
to [1, N//2], where the static int path is not clipped). Inputs are made
with numpy from a seed. Tolerance: 1e-12 absolute; horizons, indices and
decisions exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu.benchmarks import config3_carlike_min_time as j_config3
from mpc_local_planner_tpu.ocp import grid as j_grid
from mpc_local_planner_tpu.solvers import al_sqp as j_al

from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time as t_config3
from mpc_local_planner_tpu_torch.ocp import grid as t_grid
from mpc_local_planner_tpu_torch.solvers import al_sqp as t_al

ATOL = 1e-12
N, M, B = 8, 3, 6


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.0, atol=ATOL)


def _trees(t_obj, j_obj):
    for f in dataclasses.fields(j_obj):
        _close(getattr(t_obj, f.name), getattr(j_obj, f.name))


def _primal_np(rng, batch, n=N, per_stage=False):
    xs = np.cumsum(rng.uniform(-0.3, 0.5, batch + (n + 1, 3)), axis=-2)
    xs[..., 2] = rng.uniform(-np.pi, np.pi, batch + (n + 1,))  # angles across the seam
    us = rng.uniform(-0.4, 0.4, batch + (n, 2))
    dt = rng.uniform(0.05, 0.45, batch + ((n,) if per_stage else ()))
    return xs, us, dt


def _pair(xs, us, dt):
    return (j_grid.Primal(xs=jnp.asarray(xs), us=jnp.asarray(us), dt=jnp.asarray(dt)),
            t_grid.Primal(xs=torch.from_numpy(xs), us=torch.from_numpy(us),
                          dt=torch.from_numpy(np.asarray(dt))))


def _duals_np(rng, batch, n=N, per_stage=False):
    return dict(
        lam_def=rng.normal(size=batch + (n, 3)), lam_term=rng.normal(size=batch + (3,)),
        mu_obs=rng.uniform(0, 2, batch + (n, M)), mu_rate=rng.uniform(0, 2, batch + (n, 4)),
        mu_box=rng.uniform(0, 2, batch + (n, 4)),
        mu_dt=rng.uniform(0, 2, batch + ((2 * n,) if per_stage else (2,))),
        mu_ball=rng.uniform(0, 2, batch + (1,)), rho=rng.uniform(10, 100, batch),
    )


def _dual_pair(d):
    return (j_al.DualState(**{k: jnp.asarray(v) for k, v in d.items()}),
            t_al.DualState(**{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}))


# --------------------------------------------------------------------------- #
# the decision table
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["time_based_single_step", "time_based_aggressive_estimate"])
def test_torch_adapt_grid_size_decision_table_matches_jax(mode):
    kw = dict(dt_ref=0.3, dt_hyst_ratio=0.1, min_grid_size=5, max_grid_size=30, mode=mode)
    dts = np.concatenate([np.linspace(0.001, 1.2, 97), [0.27, 0.33, 0.3, 0.269999, 0.330001]])
    for n in (4, 5, 6, 17, 29, 30, 31):
        for dt in dts:
            want = j_grid.adapt_grid_size(float(dt), n, **kw)
            assert t_grid.adapt_grid_size(float(dt), n, **kw) == want, (n, dt)


# --------------------------------------------------------------------------- #
# resizing
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("batch", [(), (B,)])
@pytest.mark.parametrize("new_N", [5, 8, 13])
def test_torch_resize_primal_and_duals_match_jax(batch, new_N):
    rng = np.random.default_rng(new_N)
    jp, tp = _pair(*_primal_np(rng, batch))
    jspec = j_config3(N=N, obstacle_cap=M)
    tspec = t_config3(N=N, obstacle_cap=M)
    for js, ts in ((None, None), (jspec, tspec)):
        _trees(t_grid.resize_primal(tp, new_N, spec=ts), j_grid.resize_primal(jp, new_N, spec=js))
    jd, td = _dual_pair(_duals_np(rng, batch))
    _trees(t_grid.resize_duals(td, new_N), j_grid.resize_duals(jd, new_N))


def _edit_case(kind, rng):
    """An unbatched per-stage-dt primal whose control changes make
    ``adapt_grid_nonuniform`` merge (one near-repeat), split (one jump) or
    leave the grid alone."""
    xs, us, dt = _primal_np(rng, (), per_stage=True)
    box = (np.array([-0.2, -1.0]), np.array([0.4, 1.0]))
    # every neighbouring pair differs by 0.1-0.14 of the ranges: no edit at eps
    # 0.08 (merge below 0.08, split above 0.16)
    steps = rng.uniform(0.1, 0.14, (N - 1, 2)) * (box[1] - box[0])
    us = np.concatenate([[[0.0, -0.5]], [0.0, -0.5] + np.cumsum(steps, axis=0)])
    if kind == "merge":
        us[4] = us[3] + 0.01 * (box[1] - box[0])
    elif kind == "split":
        us[6] = us[5] + 0.5 * (box[1] - box[0])
        us[7] = us[6] + 0.11 * (box[1] - box[0])
    return xs, us, dt, box


@pytest.mark.parametrize("kind, dN", [("merge", -1), ("split", 1), ("none", 0)])
def test_torch_adapt_grid_nonuniform_matches_jax(kind, dN):
    rng = np.random.default_rng(7)
    xs, us, dt, box = _edit_case(kind, rng)
    jp, tp = _pair(xs, us, dt)
    jd, td = _dual_pair(_duals_np(rng, (), per_stage=True))
    kw = dict(control_box=box, epsilon=0.08, dt_max=1.0, min_grid_size=4, max_grid_size=12)
    jp2, jd2, jn = j_grid.adapt_grid_nonuniform(jp, jd, **kw)
    tp2, td2, tn = t_grid.adapt_grid_nonuniform(tp, td, **kw)
    assert tn == jn == N + dN
    _trees(tp2, jp2)
    _trees(td2, jd2)
    assert td2.mu_dt.shape[-1] == 2 * tn


# --------------------------------------------------------------------------- #
# per-lane warm starts and dual shifts
# --------------------------------------------------------------------------- #
LANE_STEPS = np.array([0, 1, 2, N // 2, N // 2 + 1, N + 3], dtype=np.int32)


@pytest.mark.parametrize("per_stage", [False, True])
@pytest.mark.parametrize("fn", ["warm_start_shift", "warm_start_resample"])
def test_torch_per_lane_warm_starts_match_jax(fn, per_stage):
    rng = np.random.default_rng(11 + per_stage)
    jp, tp = _pair(*_primal_np(rng, (B,), per_stage=per_stage))
    x0 = rng.uniform(-1, 1, (B, 3))
    jspec = j_config3(N=N, obstacle_cap=M)
    tspec = t_config3(N=N, obstacle_cap=M)
    for js, ts in ((jspec, tspec), (None, None)):
        want = getattr(j_grid, fn)(jp, jnp.asarray(x0), steps=jnp.asarray(LANE_STEPS), spec=js)
        got = getattr(t_grid, fn)(tp, torch.from_numpy(x0),
                                  steps=torch.from_numpy(LANE_STEPS), spec=ts)
        _trees(got, want)
    # a lane whose step is inside [1, N//2] moves as the static path moves it
    for lane, s in ((1, 1), (3, N // 2)):
        one = t_grid.Primal(*(getattr(tp, f)[lane] for f in ("xs", "us", "dt")))
        static = getattr(t_grid, fn)(one, torch.from_numpy(x0[lane]), steps=s, spec=tspec)
        lanes = getattr(t_grid, fn)(tp, torch.from_numpy(x0),
                                    steps=torch.from_numpy(LANE_STEPS), spec=tspec)
        for f in ("xs", "us", "dt"):
            _close(getattr(lanes, f)[lane], getattr(static, f).numpy())


@pytest.mark.parametrize("per_stage", [False, True])
def test_torch_per_lane_shift_duals_match_jax(per_stage):
    rng = np.random.default_rng(21 + per_stage)
    jd, td = _dual_pair(_duals_np(rng, (B,), per_stage=per_stage))
    st = dict(rho0=37.0)
    want = j_al.shift_duals(jd, j_al.SolverSettings(**st), steps=jnp.asarray(LANE_STEPS))
    got = t_al.shift_duals(td, t_al.SolverSettings(**st), steps=torch.from_numpy(LANE_STEPS))
    _trees(got, want)
    # the clip: a lane with step 0 shifts by 1, as its primal does; the
    # static path's int 0 leaves the multipliers where they are
    _close(got.lam_def[0], td.lam_def[0][torch.tensor([1, 2, 3, 4, 5, 6, 7, 7])].numpy())
    _trees(t_al.shift_duals(td, t_al.SolverSettings(**st), steps=0),
           j_al.shift_duals(jd, j_al.SolverSettings(**st), steps=0))
