"""The fused kernel's launch geometry (``ops/fused_al_sqp_cuda.py``
``launch_geometry``), on the CPU: the team of lanes that solves one
scenario, the teams of a block, the block's shared bytes and the workspace's
values per scenario, for every library group of the kernel.

- Every group at N ∈ {1, 8, 30, 32, 33, 80, 200} and M up to 30, float and
  double: the block's shared memory within the 227 KB a block can have, a
  team's within its budget; a team of 8, 16 or 32 lanes and 64 threads a
  block; the state of a short horizon all in shared memory, and every array
  of the working state in the team's shared slice, its output tensor or
  the workspace.
- The flagship's and path C's shapes, pinned.
- ``launch`` allocates the workspace the geometry names, scenario-major,
  and passes the library its pointer (a stand-in library that records the
  call: no card is needed).
- ``launched_geo`` names the instantiation ``launch_as`` picks.

The library's own numbers (``k2a_launch_geometry``) are held against this
function on the card, in ``tests/test_torch_k2a_gpu.py``.
"""

import dataclasses

import pytest
import torch

from mpc_local_planner_tpu_torch.benchmarks import (
    config2_diffdrive_obstacles,
    config3_carlike_min_time,
    family_ensemble,
    family_spec,
    random_ensemble,
)
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
from mpc_local_planner_tpu_torch.solvers import al_sqp

NS = (1, 8, 30, 32, 33, 80, 200)
MS = (0, 1, 8, 10, 30)
BLOCK_LIMIT = 232448  # 227 KB: the most shared memory an H100 block can have


def _budget(g):
    return min(k2a.SMEM_TEAM_F32 * (2 if g.double else 1), BLOCK_LIMIT // (k2a.BLOCK // k2a.TEAM))


@pytest.mark.parametrize("g", k2a.GROUPS, ids=lambda g: f"group{g.code():05d}")
def test_torch_fused_launch_geometry_fits_a_block_for_every_group(g):
    for team in (8, 16, 32):
        for N in NS:
            for M in MS:
                geo = k2a.launch_geometry(g, N, M, team)
                assert geo.team == team and geo.team * geo.teams_per_block == k2a.BLOCK
                assert geo.shared_bytes <= BLOCK_LIMIT
                per_team = geo.shared_bytes // geo.teams_per_block
                assert geo.shared_bytes == per_team * geo.teams_per_block
                assert per_team % 16 == 0
                assert per_team <= max(_budget(g) // 16 * 16, 16)
                tsize = 8 if g.double else 4
                assert per_team >= k2a.VKS_BYTES + k2a.SCRATCH * tsize
                assert geo.workspace >= 0
                if N <= 8 and team <= 16:
                    assert geo.workspace == 0  # a short horizon lives in shared memory
                # every array without an output tensor lives in the team's
                # shared slice or in the workspace, and nothing else does
                own = sum(n for n, has_output in k2a._arrays(N, M, g.nonu, team)
                          if not has_output)
                in_slice = (per_team - k2a.VKS_BYTES) // tsize - k2a.SCRATCH
                assert geo.workspace <= own <= geo.workspace + in_slice
        assert k2a.launch_geometry(g, 200, 30, team).workspace > 0


def test_torch_fused_launch_geometry_of_the_main_paths_is_pinned():
    """The flagship (N = 30, 8 slots) in float: a team's primal, chunk of
    stage terms, gain tape, step and the duals that fit in 18,800 shared
    bytes (two teams, 37,600 a block, six blocks an SM), the snapshot's 153
    values in the workspace; in double 37,552 a team; on the non-uniform
    grid (a 3-column step) the gain tape, the step's dus and ddt, the
    snapshot and the prediction times in the workspace."""
    flag32 = k2a.Group(False, 1, 0, False, 0)
    flag64 = flag32._replace(double=True)
    nonu32 = flag32._replace(nonu=True)
    assert k2a.launch_geometry(flag32, 30, 8) == k2a.LaunchGeometry(32, 2, 37600, 153)
    assert k2a.launch_geometry(flag64, 30, 8) == k2a.LaunchGeometry(32, 2, 75104, 153)
    assert k2a.launch_geometry(nonu32, 30, 8) == k2a.LaunchGeometry(
        32, 2, 37856, 30 * 21 + 30 * 2 + 30 + 31 * 3 + 30 * 2 + 30 + 31)
    # N = 200, 30 slots: the chunk of stage terms (32 slots of 115 values)
    # no longer fits beside the primal, so it goes to the workspace with
    # dus and the snapshot
    geo = k2a.launch_geometry(flag32, 200, 30)
    assert geo.workspace == 32 * 115 + 200 * 2 + 201 * 3 + 200 * 2
    assert geo.shared_bytes <= 2 * k2a.SMEM_TEAM_F32


class _Recorder:
    """A stand-in for a bound library: it records the launch's workspace
    pointer and the launch's batch."""

    def __init__(self, team):
        self.k2a_team = team
        self.calls = []

    def k2a_fused_solve(self, params, ins, outs, ws, B, stream):
        self.calls.append((ws, B, params._obj.N, params._obj.M))
        return 0


CASES = {
    "flagship": lambda: config3_carlike_min_time(N=30, obstacle_cap=8),
    "config2": lambda: config2_diffdrive_obstacles(N=30, obstacle_cap=10),
    "pathC": lambda: family_spec("polygon_footprint"),
    "pathE": lambda: family_spec("nonuniform"),
    "N80-30-slots": lambda: config3_carlike_min_time(N=80, obstacle_cap=30),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_fused_launch_allocates_the_geometrys_workspace(case, dtype, monkeypatch):
    spec = CASES[case]()
    B = 5
    scen = random_ensemble(spec, B, torch.Generator().manual_seed(0), dtype=dtype,
                           device="cpu")
    settings = al_sqp.SolverSettings(n_al=1, n_sqp=1)
    init, duals = al_sqp.default_init(spec, settings, scen, dtype=dtype)
    ins, outs = k2a.kernel_io(spec, scen, init, duals)
    made = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    for team in (8, 32):
        lib = _Recorder(team)
        made.clear()
        k2a.launch(lib, spec, settings, ins, outs, 0, scen.obstacles)
        geo = k2a.launch_geometry(k2a.group(spec, dtype), spec.N, spec.obstacle_cap, team)
        (ws_ptr, b, n, m), = lib.calls
        assert (b, n, m) == (B, spec.N, spec.obstacle_cap)
        ws = [t for t in made if t.data_ptr() == ws_ptr]
        assert len(ws) == 1, "the workspace the library gets is the one launch allocated"
        assert ws[0].dtype == dtype and ws[0].is_contiguous()
        assert tuple(ws[0].shape) == (B, max(geo.workspace, 1))  # scenario-major


def test_torch_fused_launched_geo_names_the_instantiation():
    settings = al_sqp.SolverSettings()

    def geo_of(spec, family=None):
        gen = torch.Generator().manual_seed(0)
        scen = (family_ensemble(family, spec, 2, gen, device="cpu") if family
                else random_ensemble(spec, 2, gen, device="cpu"))
        return k2a.launched_geo(k2a._params(spec, settings, scen.obstacles))

    flagship = config3_carlike_min_time(N=30, obstacle_cap=8)
    assert geo_of(flagship) == k2a.GEO_NONE
    assert geo_of(family_spec("canonical_carlike")) == k2a.GEO_ALL
    assert geo_of(family_spec("polygon_footprint")) == k2a.GEO_FP_POLYGON
    moving = dataclasses.replace(family_spec("polygon_footprint"), enable_dynamic_obstacles=True)
    assert geo_of(moving) == k2a.GEO_FP_POLYGON | k2a.GEO_SLOTS
    assert geo_of(dataclasses.replace(flagship, enable_dynamic_obstacles=True)) == k2a.GEO_ALL
    assert geo_of(family_spec("converter_lines"), "converter_lines") == k2a.GEO_ALL
