"""The fused kernel (``csrc/fused_al_sqp.cu``) against its plain PyTorch
version (``fused_solve_plain``), on the card: the flagship (K2a), BASELINE
config #2 (unicycle, quadratic form, Qf, terminal ball, fixed dt), config #1
(no obstacle slot, integral left-sum), the flagship with the front-wheel
car and the kinematic bicycle, and the geometry of K2c: the reference's
car-like config (two discs), the wall world (line slots), polygon slots
with a varying vertex count, dynamic line slots, all four slot families with
two discs and dynamic obstacles, the bicycle with two discs, the
polygon-footprint family, and all four slot families moving with a line
footprint, with a polygon footprint and with polygons of 2 and 1
vertices; the routing of user types (a subclass of a model takes the
un-fused path, a subclass of a footprint one launch, bit-equal to its base
class's); via points (K2d: the via-points
family, path D, and ordered via points with an orientation weight and
masked slots), what the kernel once refused: 30 obstacle slots (the
example configs' capacity), 17 line-search candidates and N = 80, and the
non-uniform per-stage dt grid (K2f: minimum time, all four slot families
moving with two discs, the polygon footprint; config #2's integral
trapezoidal form, held to 64 of 1024 lanes converged on both), and the
other collocation rules (K2b: the flagship with Crank–Nicolson and with
midpoint differences, config #2 with Crank–Nicolson, midpoint on the
non-uniform grid; K2e: the flagship on the shooting_rk4 and shooting_rk7_2
grids, shooting_rk2_heun under all four slot families moving with two
discs); and the edges of the kernel's team layout (a team of lanes per
scenario): N at the edges of a chunk of stages and of the team, batches of
1, 3 and 301 lanes, no slots, 30 slots with 17 candidates, a lane with a
NaN state, via points with exactly tied distances and with a NaN stage,
and the launch geometry against each library's own.

The kernel has no CPU or interpret mode, so these tests skip without a CUDA
card.
This file imports neither JAX nor the JAX package, so that it runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_k2a_gpu.py

Both versions start from one warm state, built as the fleet cycle builds
the next warm solve's inputs from a cold solve. Tolerances
(``solvers/agreement.py``):
- float64, at the whole budget and after one SQP iteration: conv flags
  identical on every lane; max relative |Δ| (over xs, us, dt and the duals,
  relative to max(|plain|, 1)) ≤ 1e-8 on at least 99.5% of the lanes both
  converged with no line-search or growth-test tie shown; on every lane at
  most 100 times the plain version's own change under a one-ulp change of
  its states or of its KKT inputs, plus 1e-12, where that change is below
  1e-6 (on every lane
  after one iteration); on a lane both converged with a tie shown, 100 times
  the larger of that change and the plain version's change when it takes
  its near-ties the other way, with ρ within one growth factor.
- float32: the bench gate's semantics (bench.py): conv flags agree on
  99.5% of lanes, a quarter of the lanes converged on both, max |Δxs| on
  those ≤ 5e-2 at 12 iterations and 1e-1 at 16.
"""

import dataclasses
import json

import pytest
import torch

from mpc_local_planner_tpu_torch.benchmarks import (
    case_ensemble,
    config1_unicycle_quadratic,
    config2_diffdrive_obstacles,
    config3_carlike_min_time,
    family_ensemble,
    family_spec,
    mixed_obstacles,
    random_ensemble,
)
from mpc_local_planner_tpu_torch.geometry.footprints import (
    CircularFootprint,
    LineFootprint,
    PointFootprint,
    PolygonFootprint,
    TwoCirclesFootprint,
)
from mpc_local_planner_tpu_torch.ocp.grid import warm_start_resample
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.ops import riccati_cuda
from mpc_local_planner_tpu_torch.planner.cycle import make_fleet_cycle
from mpc_local_planner_tpu_torch.solvers import agreement, al_sqp
from mpc_local_planner_tpu_torch.systems.models import (
    KinematicBicycleModelVelocityInput,
    SimpleCarFrontWheelDrivingModel,
    SimpleCarModel,
)

WARM = dict(
    n_al=3, n_sqp=4, rho0=120.0, reg0=1.0, tol_eq=1e-3, tol_ineq=1e-3, alphas=(1.0, 0.5, 0.22)
)
RESCUE = dict(WARM, n_al=4, alphas=(1.0, 0.7, 0.5, 0.35, 0.22, 0.14, 0.08, 0.03))
FAMILY = {
    "config2": lambda: config2_diffdrive_obstacles(N=30, obstacle_cap=10),
    "config1": lambda: dataclasses.replace(config1_unicycle_quadratic(N=20), integral_form=True),
    "front-wheel": lambda: dataclasses.replace(
        config3_carlike_min_time(N=30, obstacle_cap=8),
        model=SimpleCarFrontWheelDrivingModel(wheelbase=0.5),
    ),
    "bicycle": lambda: dataclasses.replace(
        config3_carlike_min_time(N=30, obstacle_cap=8),
        model=KinematicBicycleModelVelocityInput(lf=0.3, lr=0.2),
    ),
}
# the fused kernel's geometry (K2c): (spec, slot mix for
# ``benchmarks.mixed_obstacles`` or the family whose ensemble it runs)
TWO_DISCS = dict(front_offset=0.15, front_radius=0.2, rear_offset=-0.15, rear_radius=0.2)


def _k2c_spec(footprint, dynamic=False, **slots):
    M = sum(slots.get(k, 0) for k in ("mp", "mc", "ml", "mg"))
    spec = dataclasses.replace(
        config3_carlike_min_time(N=30, obstacle_cap=M), footprint=footprint,
        enable_dynamic_obstacles=dynamic,
    )
    return spec, dict(slots, dynamic=dynamic)


K2C = {
    "canonical_carlike": lambda: (family_spec("canonical_carlike"), "canonical_carlike"),
    "converter_lines": lambda: (family_spec("converter_lines"), "converter_lines"),
    "polygons": lambda: _k2c_spec(CircularFootprint(0.15), mc=1, mg=2, V=5, vary_nv=True),
    "lines-dynamic": lambda: _k2c_spec(CircularFootprint(0.2), True, mc=2, ml=3),
    "mixed-dynamic": lambda: _k2c_spec(
        TwoCirclesFootprint(**TWO_DISCS), True, mp=1, mc=2, ml=2, mg=1, V=4
    ),
    "bicycle-two-circles": lambda: (dataclasses.replace(
        family_spec("canonical_carlike"), model=KinematicBicycleModelVelocityInput(0.3, 0.2)
    ), "canonical_carlike"),
    # the line and polygon footprints: the polygon-footprint family (path C)
    # and each footprint against all four slot families, moving
    "polygon_footprint": lambda: (family_spec("polygon_footprint"), "polygon_footprint"),
    "line-footprint-mixed-dynamic": lambda: _k2c_spec(
        LineFootprint((-0.1, 0.0), (0.35, 0.0)), True, mp=1, mc=2, ml=2, mg=1, V=4
    ),
    "polygon-footprint-mixed-dynamic": lambda: _k2c_spec(
        family_spec("polygon_footprint").footprint, True, mp=1, mc=2, ml=2, mg=1, V=4
    ),
    # polygon footprints of 2 and 1 vertices, which JAX fused_supported takes:
    # the segment walked out and back, a point off the pose
    "polygon-footprint-2v": lambda: _k2c_spec(
        PolygonFootprint(((-0.25, 0.0), (0.25, 0.0))), True, mp=1, mc=2, ml=2, mg=1, V=4
    ),
    "polygon-footprint-1v": lambda: _k2c_spec(
        PolygonFootprint(((0.1, -0.05),)), True, mp=1, mc=2, ml=2, mg=1, V=4
    ),
}


# via points and the old caps: (spec, ensemble as ``_ensemble`` takes it,
# settings)
RESCUE17 = dict(RESCUE, alphas=tuple(0.85**i for i in range(17)))
BEYOND = {
    "via_points": lambda: (family_spec("via_points"), "via_points", WARM),
    "via-ordered-orientation": lambda: (dataclasses.replace(
        config3_carlike_min_time(N=30, obstacle_cap=8), objective="minimum_time_via_points",
        via_cap=3, via_position_weight=2.0, via_orientation_weight=0.5,
        via_points_ordered=True), "random_via", WARM),
    "30-slots": lambda: (dataclasses.replace(family_spec("canonical_carlike"), obstacle_cap=30),
                         "8_obstacles", WARM),
    "17-candidates": lambda: (config3_carlike_min_time(N=30, obstacle_cap=8), None, RESCUE17),
    "N80": lambda: (config3_carlike_min_time(N=80, obstacle_cap=8), None, WARM),
}


# the non-uniform grid (K2f): (spec, ensemble as ``_ensemble`` takes it,
# settings)
K2F = {
    "min-time": lambda: (family_spec("nonuniform"), None, WARM),
    "mixed-dynamic": lambda: (dataclasses.replace(K2C["mixed-dynamic"]()[0], nonuniform_dt=True),
                              K2C["mixed-dynamic"]()[1], WARM),
    "polygon-footprint": lambda: (dataclasses.replace(family_spec("polygon_footprint"),
                                                      nonuniform_dt=True), None, WARM),
}


# the other collocation rules (K2b, K2e): (spec, ensemble as ``_ensemble``
# takes it)
def _rule(spec, rule):
    return dataclasses.replace(spec, collocation=rule)


COLLOC = {
    "crank-nicolson-flagship": lambda: (_rule(config3_carlike_min_time(N=30, obstacle_cap=8),
                                              "crank_nicolson_differences"), None),
    "midpoint-flagship": lambda: (_rule(config3_carlike_min_time(N=30, obstacle_cap=8),
                                        "midpoint_differences"), None),
    "shooting-rk4-flagship": lambda: (_rule(config3_carlike_min_time(N=30, obstacle_cap=8),
                                            "shooting_rk4"), None),
    "shooting-rk7-2-flagship": lambda: (_rule(config3_carlike_min_time(N=30, obstacle_cap=8),
                                              "shooting_rk7_2"), None),
    "crank-nicolson-config2": lambda: (_rule(FAMILY["config2"](), "crank_nicolson_differences"),
                                       None),
    "midpoint-nonuniform": lambda: (_rule(family_spec("nonuniform"), "midpoint_differences"),
                                    None),
    "shooting-rk2-heun-mixed-dynamic": lambda: (_rule(K2C["mixed-dynamic"]()[0],
                                                      "shooting_rk2_heun"),
                                                K2C["mixed-dynamic"]()[1]),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel K2a has no CPU or interpret mode")
    return torch.device("cuda", 0)


def _ensemble(spec, batch, gen, dtype, dev, slots):
    """``random_ensemble``; a family's ensemble where ``slots`` names one,
    or ``case_ensemble``'s where it names a kind of that (``"random_via"``,
    ``"8_obstacles"``); its obstacles replaced by ``mixed_obstacles(**slots)``
    where it is a slot mix."""
    if slots in ("random_via", "8_obstacles"):
        return case_ensemble(slots, spec, batch, gen, dtype=dtype, device=dev)
    if isinstance(slots, str):
        return family_ensemble(slots, spec, batch, gen, dtype=dtype, device=dev)
    if slots is None:
        return random_ensemble(spec, batch, gen, dtype=dtype, device=dev)
    scen = random_ensemble(dataclasses.replace(spec, obstacle_cap=0), batch, gen,
                           dtype=dtype, device=dev)
    obs = mixed_obstacles(batch, gen, dtype=dtype, device=dev, **slots)
    return dataclasses.replace(scen, obstacles=obs)


def _warm_state(dev, dtype, settings, batch=300, spec=None, seed=1, cycles=0, slots=None):
    """``batch`` lanes (300 by default; ``EDGES`` adds batches that leave the
    last block of two teams partly empty) in the state of the fleet cycle's
    next warm solve:
    a cold solve (the plain version at the cold preset) and ``cycles``
    fleet cycles with the plain warm solve, then converged lanes advanced
    one stage, the primal resampled and the duals shifted. ``slots``: as
    ``_ensemble`` takes it."""
    spec = spec or config3_carlike_min_time(N=30, obstacle_cap=8)
    st = al_sqp.SolverSettings(**settings)
    cold = al_sqp.SolverSettings.for_spec(spec)
    gen = torch.Generator().manual_seed(seed)
    scen = _ensemble(spec, batch, gen, dtype, dev, slots)
    init, duals = al_sqp.default_init(spec, cold, scen, dtype=dtype)
    r = k2a.fused_solve_plain(spec, cold, scen, init, duals)
    if cycles:
        duals0 = al_sqp.init_duals(spec, st, dtype, dev, batch=(batch,))
        cycle = make_fleet_cycle(
            spec, st, duals0, device=dev,
            solve=lambda s, i, d: k2a.fused_solve_plain(spec, st, s, i, d),
        )
        for _ in range(cycles):
            scen, r = cycle(scen, r)
    x0n = torch.where(r.converged[:, None], r.primal.xs[:, 1, :], scen.x0)
    init = warm_start_resample(r.primal, x0n, steps=1, spec=spec)
    duals = al_sqp.shift_duals(r.duals, st, steps=1)
    return spec, st, dataclasses.replace(scen, x0=x0n), init, duals


def _check_f64(spec, st, scen, init, duals, floor=0.25):
    """agreement.f64_agreement at the whole budget (at least ``floor`` of
    the lanes converged on both) and after one SQP iteration, before
    rounding can grow on any lane."""
    for sp, short in ((st, False), (dataclasses.replace(st, n_al=1, n_sqp=1), True)):
        before = k2a.fused_solve_cuda.launches
        out_k = k2a.fused_solve_cuda(spec, sp, scen, init, duals)
        assert k2a.fused_solve_cuda.launches == before + 1
        out_p = k2a.fused_solve_plain(spec, sp, scen, init, duals)
        plain = lambda i, **kw: k2a.fused_solve_plain(spec, sp, scen, i, duals, **kw)  # noqa: E731,B023
        outs_q, outs_r, outs_t = agreement.plain_runs(plain, init)
        outs_s = agreement.spread_runs(plain, init) if short else ()
        torch.cuda.synchronize()
        assert out_k.primal.xs.dtype == torch.float64
        respread = agreement.lane_spread(
            lambda s, i, d, **kw: k2a.fused_solve_plain(spec, sp, s, i, d, **kw),  # noqa: B023
            scen, init, duals)
        info, passed, _, _ = agreement.f64_agreement(
            out_k, out_p, outs_q, outs_t, sp.rho_growth, 0.0 if short else floor,
            every_lane=short, outs_r=outs_r, outs_spread=outs_s, respread=respread,
        )
        assert passed, json.dumps(info)


def _check_f32(spec, st, scen, init, duals, floor=0.25):
    out_k = k2a.fused_solve_cuda(spec, st, scen, init, duals)
    out_p = k2a.fused_solve_plain(spec, st, scen, init, duals)
    torch.cuda.synchronize()
    info, passed = agreement.gate(out_k, out_p, st.n_al * st.n_sqp, floor)
    assert passed, json.dumps(info)
    both = out_k.converged & out_p.converged
    assert bool(torch.isfinite(out_k.primal.xs[both]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("settings", [WARM, RESCUE], ids=["warm3x4", "rescue4x4"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_k2a_kernel_matches_plain_on_the_flagship(dtype, settings):
    args = _warm_state(_card(), dtype, settings)
    (_check_f64 if dtype == torch.float64 else _check_f32)(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [0, 3])
def test_torch_k2a_kernel_matches_plain_on_a_point_footprint_with_a_free_heading(M):
    spec = dataclasses.replace(
        config3_carlike_min_time(N=12, obstacle_cap=M), footprint=PointFootprint(),
        xf_fixed=(True, True, False),
    )
    _check_f64(*_warm_state(_card(), torch.float64, dict(WARM, n_al=2, n_sqp=3), spec=spec))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(FAMILY))
def test_torch_fused_kernel_matches_plain_across_the_family(case, dtype):
    """From the live state of two fleet cycles (a single warm solve after
    the cold solve converges under a quarter of config #2's lanes)."""
    args = _warm_state(_card(), dtype, WARM, spec=FAMILY[case](), cycles=2)
    (_check_f64 if dtype == torch.float64 else _check_f32)(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(K2C))
def test_torch_fused_kernel_matches_plain_on_the_k2c_geometry(case, dtype):
    """The two-disc footprint, line and polygon slots (a varying vertex
    count) and dynamic obstacles, from the live state of two fleet cycles."""
    spec, slots = K2C[case]()
    args = _warm_state(_card(), dtype, WARM, spec=spec, cycles=2, slots=slots)
    (_check_f64 if dtype == torch.float64 else _check_f32)(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(BEYOND))
def test_torch_fused_kernel_matches_plain_on_via_points_and_beyond_the_old_caps(case, dtype):
    """Via points (path D's family; ordered with an orientation weight and
    masked slots), 30 obstacle slots, 17 candidates and N = 80, from the
    live state of two fleet cycles."""
    spec, slots, settings = BEYOND[case]()
    args = _warm_state(_card(), dtype, settings, spec=spec, cycles=2, slots=slots)
    (_check_f64 if dtype == torch.float64 else _check_f32)(*args)


@pytest.mark.gpu
def test_torch_make_solver_launches_the_kernel_for_the_wall_world():
    """Line slots are in the kernel's scope: the wall world's warm solve
    launches it."""
    dev = _card()
    spec, st, scen, init, duals = _warm_state(
        dev, torch.float32, WARM, batch=64, spec=family_spec("converter_lines"),
        slots="converter_lines",
    )
    before = k2a.fused_solve_cuda.launches
    out = al_sqp.make_solver(spec, st, dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1
    assert out.duals.mu_obs.shape == (64, 30, 6)


@pytest.mark.gpu
def test_torch_make_solver_launches_the_kernel_for_the_polygon_footprint():
    """The polygon footprint is in the kernel's scope: path C's warm solve
    launches it."""
    dev = _card()
    spec, st, scen, init, duals = _warm_state(
        dev, torch.float32, WARM, batch=64, spec=family_spec("polygon_footprint"),
        slots="polygon_footprint",
    )
    before = k2a.fused_solve_cuda.launches
    out = al_sqp.make_solver(spec, st, dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1
    assert out.duals.mu_obs.shape == (64, 30, 8)


@dataclasses.dataclass(frozen=True)
class _UserCar(SimpleCarModel):
    label: str = "user"


@dataclasses.dataclass(frozen=True)
class _UserDisc(CircularFootprint):
    label: str = "user"


@pytest.mark.gpu
def test_torch_make_solver_routes_user_types_as_jax_fused_supported():
    """A subclass of the simple car takes the un-fused path (JAX
    ``fused_supported`` takes a model by its exact type): no fused launch,
    one K1 launch per SQP iteration. A subclass of the disc footprint takes
    the kernel (``isinstance``) in one launch, bit-equal to the base
    class's."""
    dev = _card()
    spec, st, scen, init, duals = _warm_state(dev, torch.float32, WARM, batch=64)
    user_model = dataclasses.replace(spec, model=_UserCar(wheelbase=0.5))
    fused, k1 = k2a.fused_solve_cuda.launches, riccati_cuda.lqr_solve_cuda.launches
    al_sqp.make_solver(user_model, st, dev)(scen, init, duals)
    torch.cuda.synchronize()
    assert k2a.fused_solve_cuda.launches == fused
    assert riccati_cuda.lqr_solve_cuda.launches == k1 + st.n_al * st.n_sqp
    user_disc = dataclasses.replace(spec, footprint=_UserDisc(radius=0.2))
    out = al_sqp.make_solver(user_disc, st, dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == fused + 1
    base = al_sqp.make_solver(spec, st, dev)(scen, init, duals)
    for a, b in zip(_leaves(out), _leaves(base)):
        assert torch.equal(a, b)


def _leaves(tree):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, torch.Tensor):
        yield tree


@pytest.mark.gpu
def test_torch_make_solver_launches_the_kernel_for_config2s_warm_solve():
    dev = _card()
    spec, st, scen, init, duals = _warm_state(
        dev, torch.float32, WARM, batch=64, spec=FAMILY["config2"]()
    )
    before = k2a.fused_solve_cuda.launches
    out = al_sqp.make_solver(spec, st, dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1
    assert bool((out.primal.dt == torch.tensor(0.3, dtype=torch.float32)).all())
    al_sqp.make_solver(spec, dataclasses.replace(st, fused="off"), dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BEYOND))
def test_torch_make_solver_launches_the_kernel_beyond_the_old_caps(case):
    """Via points, 30 slots, 17 candidates and N = 80 are in the kernel's
    scope: the warm solve launches it once."""
    dev = _card()
    spec, slots, settings = BEYOND[case]()
    spec, st, scen, init, duals = _warm_state(dev, torch.float32, settings, batch=64, spec=spec,
                                              slots=slots)
    before = k2a.fused_solve_cuda.launches
    out = al_sqp.make_solver(spec, st, dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1
    assert out.duals.mu_obs.shape == (64, spec.N, spec.obstacle_cap)


@pytest.mark.gpu
def test_torch_make_solver_launches_k2a_for_the_warm_solve():
    dev = _card()
    spec, st, scen, init, duals = _warm_state(dev, torch.float32, WARM, batch=64)
    before = k2a.fused_solve_cuda.launches
    al_sqp.make_solver(spec, st, dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1
    al_sqp.make_solver(spec, dataclasses.replace(st, fused="off"), dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1


@pytest.mark.gpu
def test_torch_k2a_kernel_refuses_what_it_does_not_take():
    dev = _card()
    spec, st, scen, init, duals = _warm_state(dev, torch.float32, WARM, batch=8)
    cpu = lambda t: al_sqp.tree_map(lambda a: a.cpu(), t)  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        k2a.fused_solve_cuda(spec, st, cpu(scen), cpu(init), cpu(duals))
    short = dataclasses.replace(duals, mu_obs=duals.mu_obs[:, :, :2])
    with pytest.raises(ValueError, match="mu_obs has shape"):
        k2a.fused_solve_cuda(spec, st, scen, init, short)
    with pytest.raises(NotImplementedError, match="via_cap=9"):
        k2a.fused_solve_cuda(dataclasses.replace(spec, via_cap=9), st, scen, init, duals)
    strided = dataclasses.replace(init, us=init.us.mT.contiguous().mT)
    with pytest.raises(ValueError, match="us is not contiguous"):
        k2a.fused_solve_cuda(spec, st, scen, strided, duals)
    # a library launches its own group only: the flagship's refuses the
    # quadratic form, which its five instantiations do not hold
    quad = dataclasses.replace(spec, objective="quadratic_form")
    lib = k2a._load(k2a.group(spec, torch.float32))
    ins, outs = k2a.kernel_io(quad, scen, init, duals)
    with pytest.raises(RuntimeError, match="invalid argument"):
        k2a.launch(lib, quad, st, ins, outs, torch.cuda.current_stream(dev).cuda_stream,
                   scen.obstacles)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(K2F))
def test_torch_fused_kernel_matches_plain_on_the_nonuniform_grid(case, dtype):
    """The non-uniform grid's half of the kernel (K2f: a per-stage dt, a
    3x3 Quu, the interval dt boxes, cumulative prediction times) from the
    live state of two fleet cycles."""
    spec, slots, settings = K2F[case]()
    args = _warm_state(_card(), dtype, settings, spec=spec, cycles=2, slots=slots)
    assert tuple(args[3].dt.shape) == (300, spec.N)
    (_check_f64 if dtype == torch.float64 else _check_f32)(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_fused_kernel_matches_plain_on_the_nonuniform_trapezoidal_form(dtype):
    """Config #2's integral trapezoidal form on the grid (the dt_{k-1}
    coupling row). It converges few lanes at the warm 3×4, in JAX as in the
    port (tests/test_torch_nonuniform_solves.py), so it runs at 1024 lanes
    and is held to 64 of them converged on both versions (chip_smoke.py's
    ``CONVERGED_FLOOR``)."""
    spec = dataclasses.replace(
        config2_diffdrive_obstacles(N=30, obstacle_cap=10), integral_form=True,
        cost_integration="trapezoidal", hybrid_time_weight=0.4, variable_dt=True,
        nonuniform_dt=True, dt_min=1e-3, dt_max=0.5)
    args = _warm_state(_card(), dtype, WARM, batch=1024, spec=spec, cycles=2)
    init = args[3]
    assert bool((init.dt.max(dim=-1).values > init.dt.min(dim=-1).values).any())
    (_check_f64 if dtype == torch.float64 else _check_f32)(*args, floor=1 / 16)


@pytest.mark.gpu
def test_torch_nonuniform_warm_solve_launches_the_kernel_and_never_k1():
    """Path E's warm solve launches the fused kernel once; its un-fused
    solve runs the plain KKT solve on the card (δdt_k a third control
    column), not K1, which refuses that shape."""
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    dev = _card()
    spec, st, scen, init, duals = _warm_state(dev, torch.float32, WARM, batch=64,
                                              spec=family_spec("nonuniform"))
    before, k1 = k2a.fused_solve_cuda.launches, riccati_cuda.lqr_solve_cuda.launches
    out = al_sqp.make_solver(spec, st, dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1
    assert out.primal.dt.shape == (64, spec.N) and out.duals.mu_dt.shape == (64, 2 * spec.N)
    off = al_sqp.make_solver(spec, dataclasses.replace(st, fused="off"), dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1
    assert riccati_cuda.lqr_solve_cuda.launches == k1
    assert off.primal.dt.shape == (64, spec.N)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(COLLOC))
def test_torch_fused_kernel_matches_plain_under_the_collocation_rules(case, dtype):
    """The fold of midpoint and Crank–Nicolson (r = −E⁻¹c in the step, c in
    the merit and the duals) and the shooting grids' tableau walk, from the
    live state of two fleet cycles."""
    spec, slots = COLLOC[case]()
    args = _warm_state(_card(), dtype, WARM, spec=spec, cycles=2, slots=slots)
    (_check_f64 if dtype == torch.float64 else _check_f32)(*args)


@pytest.mark.gpu
def test_torch_crank_nicolson_warm_solve_launches_the_kernel_and_never_k1():
    """Path F's warm solve launches the fused kernel once, counted under its
    rule, and K1 never; its un-fused solve takes K1 once per SQP iteration."""
    from mpc_local_planner_tpu_torch.ops import riccati_cuda

    dev = _card()
    spec, st, scen, init, duals = _warm_state(dev, torch.float32, WARM, batch=64,
                                              spec=COLLOC["crank-nicolson-flagship"]()[0])
    before, k1 = k2a.fused_solve_cuda.launches, riccati_cuda.lqr_solve_cuda.launches
    rule = k2a.fused_solve_cuda.launches_by_rule[spec.collocation]
    al_sqp.make_solver(spec, st, dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1
    assert k2a.fused_solve_cuda.launches_by_rule[spec.collocation] == rule + 1
    assert riccati_cuda.lqr_solve_cuda.launches == k1
    al_sqp.make_solver(spec, dataclasses.replace(st, fused="off"), dev)(scen, init, duals)
    assert k2a.fused_solve_cuda.launches == before + 1
    assert riccati_cuda.lqr_solve_cuda.launches == k1 + st.n_al * st.n_sqp


# the team layout's edges: N at the edges of a chunk of stages and of the
# team (32 lanes: N + 1 items, the terminal one of them), batches that
# leave the last team or the last block (two teams) partly empty, no slots,
# 30 slots with 17 candidates: (spec, ensemble as ``_ensemble`` takes it,
# settings, batch)
EDGES = {
    **{f"N{n}": (lambda n=n: (config3_carlike_min_time(N=n, obstacle_cap=8), None, WARM, 300))
       for n in (31, 32, 33, 65)},
    **{f"B{b}": (lambda b=b: (config3_carlike_min_time(N=30, obstacle_cap=8), None, WARM, b))
       for b in (1, 3, 301)},
    "M0": lambda: (config3_carlike_min_time(N=30, obstacle_cap=0), None, WARM, 300),
    "30-slots-17-candidates": lambda: (dataclasses.replace(
        family_spec("canonical_carlike"), obstacle_cap=30), "8_obstacles", RESCUE17, 300),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(EDGES))
def test_torch_fused_kernel_matches_plain_at_the_team_layouts_edges(case, dtype):
    """The kernel against its plain version where the team layout has its
    edges; a batch of 1 or 3 lanes is held to the rule on every lane with
    no floor of converged lanes."""
    spec, slots, settings, batch = EDGES[case]()
    args = _warm_state(_card(), dtype, settings, batch=batch, spec=spec, slots=slots)
    floor = 0.25 if batch >= 300 else 0.0
    (_check_f64 if dtype == torch.float64 else _check_f32)(*args, floor=floor)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_fused_kernel_quarantines_a_lane_with_a_nan_state(dtype):
    """A NaN state makes every step of its lane non-finite: the team's vote
    zeroes the whole step each iteration, so the lane's controls never move,
    as in the plain version, and every other lane solves as it does without
    that lane."""
    dev = _card()
    spec, st, scen, init, duals = _warm_state(dev, dtype, WARM, batch=64)
    bad = 5
    xs = init.xs.clone()
    xs[bad, 7, 0] = float("nan")
    init_nan = dataclasses.replace(init, xs=xs)
    out = k2a.fused_solve_cuda(spec, st, scen, init_nan, duals)
    clean = k2a.fused_solve_cuda(spec, st, scen, init, duals)
    plain = k2a.fused_solve_plain(spec, st, scen, init_nan, duals)
    torch.cuda.synchronize()
    assert torch.equal(out.primal.us[bad], init.us[bad])
    assert torch.equal(plain.primal.us[bad], init.us[bad])
    assert not bool(out.converged[bad]) and not bool(plain.converged[bad])
    torch.testing.assert_close(out.primal.xs[bad], plain.primal.xs[bad], equal_nan=True)
    torch.testing.assert_close(out.primal.dt[bad], plain.primal.dt[bad])
    keep = torch.arange(64, device=dev) != bad
    for a, b in ((out.primal.xs, clean.primal.xs), (out.primal.us, clean.primal.us),
                 (out.primal.dt, clean.primal.dt), (out.duals.lam_def, clean.duals.lam_def),
                 (out.duals.mu_obs, clean.duals.mu_obs), (out.duals.rho, clean.duals.rho),
                 (out.cost, clean.cost), (out.converged, clean.converged)):
        assert torch.equal(a[keep], b[keep])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_torch_fused_kernel_matches_plain_on_via_ties_and_a_nan_stage(dtype):
    """The team's argmin over stages (path D's family): a via point at a
    position two stages share (an exact tie, which the first stage wins),
    held to the rule; and a NaN stage, which wins the assignment of every
    via point (a NaN is the least), the lane then quarantined as in the
    plain version."""
    dev = _card()
    spec, st, scen, init, duals = _warm_state(dev, dtype, WARM, batch=64,
                                              spec=family_spec("via_points"), slots="via_points")
    xs = init.xs.clone()
    xs[:, 10, :2] = xs[:, 9, :2]
    vp = scen.via_points.clone()
    vp[:, 0, :2] = xs[:, 9, :2]
    tied, scen_t = dataclasses.replace(init, xs=xs), dataclasses.replace(scen, via_points=vp)
    (_check_f64 if dtype == torch.float64 else _check_f32)(spec, st, scen_t, tied, duals,
                                                           floor=0.0)
    xs_nan = init.xs.clone()
    xs_nan[:32, 12, 0] = float("nan")
    init_nan = dataclasses.replace(init, xs=xs_nan)
    out = k2a.fused_solve_cuda(spec, st, scen, init_nan, duals)
    plain = k2a.fused_solve_plain(spec, st, scen, init_nan, duals)
    torch.cuda.synchronize()
    assert torch.equal(out.primal.us[:32], init.us[:32])
    assert torch.equal(out.converged[:32], plain.converged[:32])
    torch.testing.assert_close(out.primal.xs[:32], plain.primal.xs[:32], equal_nan=True)
    torch.testing.assert_close(out.cost[:32], plain.cost[:32], equal_nan=True)


@pytest.mark.gpu
def test_torch_fused_launch_geometry_matches_the_library():
    """``launch_geometry`` (tests/test_torch_fused_launch.py pins it on the
    CPU) against each library's own ``k2a_launch_geometry``, for the groups
    of the main paths in float and double."""
    _card()
    specs = (config3_carlike_min_time(N=30, obstacle_cap=8), FAMILY["config2"](),
             family_spec("nonuniform"), family_spec("via_points"),
             COLLOC["crank-nicolson-flagship"]()[0])
    groups = sorted({k2a.group(s, d) for s in specs for d in (torch.float32, torch.float64)})
    for g in groups:
        lib = k2a._load(g)
        for N in (1, 8, 30, 32, 33, 80, 200):
            for M in (0, 8, 30):
                geo = k2a.library_geometry(lib, N, M)
                assert geo == k2a.launch_geometry(g, N, M, lib.k2a_team), (g, N, M)
