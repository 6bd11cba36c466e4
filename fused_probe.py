#!/usr/bin/env python3
"""Measurements of the fused kernel (``csrc/fused_al_sqp.cu``) and of K1 on
one NVIDIA GPU, beside ``chip_smoke.py``:

    python3 fused_probe.py [registers] [timing] [rounding[=CASE]] [times] [teams] [k1] [stamps]
    (the first three by default)

- registers: builds the kernel's ``<float, simple car, OBJ_MIN_TIME>`` and
  ``<float, unicycle, OBJ_QUADRATIC>`` instantiations with each part of the
  geometry (the ``GEO`` template parameter: a second disc, line slots,
  polygon slots, moving slots) compiled in alone, the launched ones
  (``GEO_NONE`` and ``GEO_ALL`` for disc footprints; a polygon footprint
  with static circle slots, ``GEO_FP_POLYGON``, and with every slot family,
  ``GEO_FP_POLYGON | GEO_SLOTS``; a line footprint, ``GEO_FP_LINE |
  GEO_SLOTS``), and the kinematic bicycle's ``GEO_FP_POLYGON`` pair
  (minimum time and quadratic, two rows that move with the library they
  are built in), and the flagship's launched instantiation (``GEO_NONE``)
  under each collocation family (the template parameter ``COLLOC``:
  forward differences; midpoint, Crank–Nicolson and shooting), and
  prints ptxas' registers, stack frame and spills for each; of the tree in
  the working directory, as ``times`` does (a tree from before the
  collocation families has the forward rows only). Where the tree has the
  team layout, also each main path's launched instantiation in float and
  double: its registers, stack and spills, a team's shared bytes and the
  teams per SM (``main_path_registers``).
- timing: the flagship's and config #2's warm solves at B=4096 from the
  straight-line seed, through the ``GEO_NONE`` instantiation and through
  ``GEO_ALL`` on the same inputs (the same spec with dynamic obstacles at zero
  velocity, which predicts every slot where it stands); CUDA events, median
  of 25 launches each, in the order none, all, all, none.
- rounding: ``chip_smoke.py``'s ``mixed-dynamic`` case at B=1024, float64,
  at the first two prefixes of the warm schedule (1×1, 1×2): for every lane
  whose error or sensitivity passes 1e-8, the kernel's error against the
  plain version's move under many sign patterns of one ulp on its KKT inputs
  (``agreement.KktRounding``) and under one ulp on its states.
  ``rounding=CASE`` runs another case of ``chip_smoke.family_state``, or
  ``polygon-footprint``: path C's family at B=1024 from its own ensemble.
- times: K1 on a flagship SQP iteration's Riccati inputs, and the fused
  kernel's launch of every main path's warm solve (B=4096) and rescue
  (1024; path B's 2048) from the straight-line seed (``main_path_cases``:
  the flagship, config #2, paths A-F; CUDA events, median of 25 launches),
  with each launch's team layout where the tree has one, for the tree in
  the working directory: its ``chip_smoke`` and package come first on the
  path. K1 is timed twice: around the wrapper's call (``k1_ms``, as before)
  and on the device alone (``device_ms``: the launches queued behind a
  busy-wait, so that the wrapper's host work is hidden), at B=4096 and
  1024, N=30, and B=4096, N=96, with K1's ptxas report and, where the tree
  has K1's launch geometry, its shared bytes and blocks per SM. To compare two commits on one card, unpack the parent with
  ``git archive`` into an ignored directory and run there and here in
  turns (parent, change, change, parent):
  ``(cd DIR && python3 ../fused_probe.py times)``.
- teams: the team size and a team's shared budget, measured on the
  simple-car group (``TEAM_VARIANTS``).
- k1: K1's design (``riccati_cuda.Design``: lanes per scenario, scenarios
  per block, the ring's chunk and slots, the budget per scenario) built at
  each of ``K1_VARIANTS`` with ``-D`` macros and timed on the device in
  turns at B=4096 and 1024, N=30 and 96 (``device_ms``, ``K1_SHAPES``), with each
  variant's ptxas report, geometry, blocks per SM and its error against
  the plain version.
- stamps: K1's cycles by phase at N=30 (the teams' first data, a backward
  stage, a rollout stage, a team's flush, the whole block) from clock64()
  stamps in a copy of the source, at B=528 (one block an SM), 1024 and
  4096.

Prints one JSON line per measurement. Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import sys

sys.path.insert(0, os.getcwd())  # the tree to measure: this one, or a parent's copy
import chip_smoke  # noqa: E402

PARTS = {"GEO_NONE": 0, "GEO_DISCS": 1, "GEO_LINES": 2, "GEO_POLYGONS": 4, "GEO_DYNAMIC": 8,
         "GEO_ALL": 15, "GEO_FP_POLYGON": 32, "GEO_FP_POLYGON | GEO_SLOTS": 46,
         "GEO_FP_LINE | GEO_SLOTS": 30}
ROUNDING_PATTERNS = 32


def registers():
    """ptxas' report for each part of the geometry compiled in alone: one
    source per instantiation, all built at once."""
    from concurrent.futures import ThreadPoolExecutor

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.ops import nvcc_build

    source = k2a.SOURCE.read_text()
    # the kernel templates without the entry points (which instantiate the
    # launched ones), then a pointer to the one probed instantiation: of the
    # uniform grid, where the kernel has the template parameter NONU
    body = source[: source.index('extern "C" {')]
    nonu = ", false" if "bool NONU" in body else ""
    families = ("COLLOC_FD", "COLLOC_OTHER") if "int COLLOC" in body else ()
    nvcc_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def build(case):
        model, quad, part, colloc = case
        name = f"fused_probe_{model}_{quad}_{PARTS[part]}_{colloc or 'FD'}"
        probe = nvcc_build.BUILD_DIR / f"{name}.cu"
        tail = nonu + (f", {colloc or 'COLLOC_FD'}" if families else "")
        probe.write_text(body + f"void* fused_probe_kernel = (void*)&k2a_kernel<float, {model}, "
                                f"{quad}, {part}{tail}>;\n")
        lib = nvcc_build.BUILD_DIR / f"lib{name}.so"
        lib.unlink(missing_ok=True)
        ptxas = nvcc_build.build_library(probe, lib)["ptxas"]
        row = {"model": model, "objective": quad, "geo": part, "colloc": colloc or "COLLOC_FD"}
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            found = re.search(pat, ptxas)
            row[key] = int(found.group(1)) if found else None
        return row

    cases = [(model, obj, part, None) for model, obj in (("SIMPLE_CAR", "OBJ_MIN_TIME"),
                                                         ("UNICYCLE", "OBJ_QUADRATIC"))
             for part in PARTS] + [("BICYCLE", obj, "GEO_FP_POLYGON", None)
                                   for obj in ("OBJ_MIN_TIME", "OBJ_QUADRATIC")]
    cases += [("SIMPLE_CAR", "OBJ_MIN_TIME", "GEO_NONE", f) for f in families[1:]]
    with ThreadPoolExecutor(max_workers=8) as pool:
        rows = list(pool.map(build, cases))
    print(json.dumps({"registers": rows}))
    if hasattr(k2a, "launch_geometry"):
        print(json.dumps({"main_path_registers": main_path_registers()}))


def _ptxas_rows(ptxas):
    """ptxas' registers, stack frame and spills of each k2a_kernel
    instantiation in one build's report, by its template arguments."""
    rows = {}
    for part in ptxas.split("Compiling entry function")[1:]:
        name = re.search(r"k2a_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d+)ELb([01])ELi(\d+)E", part)
        if not name:
            continue
        row = {}
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            found = re.search(pat, part)
            row[key] = int(found.group(1)) if found else None
        rows[int(name.group(4))] = row  # by GEO
    return rows


def device_ms(fn, reps=20, rounds=5):
    """The device time of one call of ``fn``, the host's share hidden: each
    round queues ``reps`` calls behind a busy-wait kernel on the stream and
    times them between CUDA events recorded after the wait, so that the
    device runs them back to back; the median of ``rounds`` rounds. The wait
    is lengthened until it outlasts the queueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles, per = 2_000_000, []
    while len(per) < rounds:
        gate = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        gate.record()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        hidden = not gate.query()  # still waiting when the last call was queued
        torch.cuda.synchronize()
        if hidden:
            per.append(start.elapsed_time(end) / reps)
        elif cycles > 2_000_000_000:
            raise RuntimeError("device_ms: the host did not queue the calls within the wait")
        else:
            cycles *= 4
    return statistics.median(per)


def k1_report(riccati_cuda, nvcc_build, tag="k1"):
    """ptxas' registers, stack and spills of the tree's K1 (its source built
    anew under a name of its own) and, where the tree has K1's launch
    geometry, the layout and blocks per SM of its flagship launches."""
    lib = nvcc_build.BUILD_DIR / f"libfused_probe_{tag}.so"
    lib.unlink(missing_ok=True)
    ptxas = nvcc_build.build_library(riccati_cuda.SOURCE, lib)["ptxas"]
    row = {"ptxas": chip_smoke.ptxas_rows(ptxas)}
    if hasattr(riccati_cuda, "launch_geometry"):
        import torch

        bound = riccati_cuda._load()
        row["layout"] = {
            f"{str(dt).removeprefix('torch.')} N={N}": {
                **riccati_cuda.library_geometry(bound, N, dt)._asdict(),
                "blocks_per_sm": riccati_cuda.occupancy(bound, N, dt)}
            for N in (30, chip_smoke.K1_LONG_N) for dt in (torch.float32, torch.float64)}
    return row


def main_path_registers():
    """Each main path's launched instantiation in float and double: ptxas'
    registers, stack and spills, the team's shared bytes and the teams per
    SM at the path's N and M (the CUDA occupancy calculator), from its
    group's library built here."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.ops import nvcc_build

    device = torch.device("cuda", 0)
    cases = [c for c in main_path_cases(device) if not c[0].endswith("_rescue")]
    groups = sorted({k2a.group(sp, dt) for _, sp, _, _, _ in cases
                     for dt in (torch.float32, torch.float64)})

    def build(g):
        lib = nvcc_build.BUILD_DIR / f"libfused_probe_group_{g.code()}.so"
        lib.unlink(missing_ok=True)
        return g, lib, nvcc_build.build_library(k2a.SOURCE, lib, g.defines())["ptxas"]

    with ThreadPoolExecutor(max_workers=16) as pool:
        built = {g: (lib, _ptxas_rows(ptxas)) for g, lib, ptxas in pool.map(build, groups)}
    rows = []
    for tag, sp, family, st, _ in cases:
        for dt in (torch.float32, torch.float64):
            g = k2a.group(sp, dt)
            path, ptx = built[g]
            lib = k2a.bind(path, g)
            scen = chip_smoke.ensemble(sp, 8, device, family=family)
            geo = k2a.library_geometry(lib, sp.N, sp.obstacle_cap)
            params = k2a._params(sp, st, scen.obstacles)
            blocks = k2a.occupancy(lib, sp, st, scen.obstacles)
            geo_id = k2a.launched_geo(params)
            rows.append({"path": tag, "dtype": str(dt).removeprefix("torch."), "geo": geo_id,
                         **ptx.get(geo_id, {}), "team": geo.team,
                         "shared_bytes_per_team": geo.shared_bytes // geo.teams_per_block,
                         "workspace_per_scenario": geo.workspace,
                         "teams_per_sm": blocks * geo.teams_per_block})
    return rows


def timing():
    """GEO_NONE against GEO_ALL on the same flagship and config #2 inputs."""
    import torch

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.solvers import al_sqp

    device = torch.device("cuda", 0)
    out = {}
    for tag, spec in (("flagship", chip_smoke.flagship()[0]), ("config2", chip_smoke.config2())):
        warm = dataclasses.replace(chip_smoke.fleet_settings(spec)[2], fused="auto")
        scen = chip_smoke.ensemble(spec, chip_smoke.BATCH, device)
        init, duals = al_sqp.default_init(spec, warm, scen)
        moving = dataclasses.replace(spec, enable_dynamic_obstacles=True)
        vels = [scen.obstacles.circle_vels, scen.obstacles.point_vels]
        assert all(not bool(v.any()) for v in vels), "the ensemble's slots must stand still"
        res = {s: k2a.fused_solve_cuda(s_, warm, scen, init, duals)
               for s, s_ in (("none", spec), ("all", moving))}
        diff = max(float(torch.max(torch.abs(a - b)))
                   for a, b in ((res["none"].primal.xs, res["all"].primal.xs),
                                (res["none"].primal.us, res["all"].primal.us)))
        times = {"none": [], "all": []}
        for s in ("none", "all", "all", "none"):
            s_ = spec if s == "none" else moving
            times[s].append(chip_smoke._cuda_ms(
                lambda: k2a.fused_solve_cuda(s_, warm, scen, init, duals), 25))
        out[tag] = {"geo_none_ms": times["none"], "geo_all_ms": times["all"],
                    "max_abs_diff_xs_us": diff,
                    "conv_identical": bool(torch.equal(res["none"].converged,
                                                       res["all"].converged))}
    print(json.dumps({"timing": out, "card": chip_smoke.card_line()}))


def rounding(case="mixed-dynamic"):
    """A case's lanes beyond 1e-8 at 1×1 and 1×2: the kernel's error against
    the plain version's moves under rounding."""
    import torch

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.solvers import agreement

    from mpc_local_planner_tpu_torch.benchmarks import family_spec

    own = {"polygon-footprint": (family_spec("polygon_footprint", N=30), None)}
    spec, warm, args32 = chip_smoke.family_state(case, case=own.get(case))
    scen, init, duals = chip_smoke._double(args32)
    for n_al, n_sqp in ((1, 1), (1, 2)):
        sp = dataclasses.replace(warm, n_al=n_al, n_sqp=n_sqp)
        plain = lambda i, **kw: k2a.fused_solve_plain(spec, sp, scen, i, duals, **kw)  # noqa: E731
        out_k = k2a.fused_solve_cuda(spec, sp, scen, init, duals)
        out_p = plain(init)
        move = lambda o: agreement._rel_errs(o, out_p).amax(dim=0)  # noqa: E731
        err = move(out_k)
        states = torch.stack([move(plain(q)) for q in agreement.ulp_perturbed(init)]).amax(dim=0)
        kkt = torch.stack([move(plain(init, kkt_rounding=agreement.KktRounding(seed)))
                           for seed in range(ROUNDING_PATTERNS)])
        torch.cuda.synchronize()
        rule = torch.maximum(states, kkt[:2].amax(dim=0))  # the sensitivity the rule takes
        lanes = []
        for b in torch.nonzero((err > 1e-8) | (rule > 1e-8)).flatten().tolist():
            moves = sorted(float(m) for m in kkt[:, b])
            lanes.append({
                "lane": b, "err": float(err[b]), "rule_sensitivity": float(rule[b]),
                "states_move": float(states[b]),
                "kkt_move_min": moves[0], "kkt_move_median": statistics.median(moves),
                "kkt_move_max": moves[-1],
                "patterns_moving_more_than_err": sum(m >= float(err[b]) for m in moves),
                "err_over_max_move": float(err[b]) / max(moves[-1], 1e-300),
            })
        print(json.dumps({"rounding": f"{case} B={args32[0].x0.shape[0]} "
                                      f"{n_al}x{n_sqp} f64", "patterns": ROUNDING_PATTERNS,
                          "lanes": lanes}))


def main_path_cases(device):
    """The fused kernel's launches of every main path's fleet cycle, from the
    straight-line seed: (tag, spec, family, settings, batch). The warm
    solves at B=4096 (paths B's at 4×4) and each path's rescue, at 1024
    slots (path B's at 2048, with the rescue's 8 candidates at 4×4)."""
    from mpc_local_planner_tpu_torch.benchmarks import family_spec

    spec, _, warm, rescue = chip_smoke.flagship()
    lines_warm = dataclasses.replace(warm, n_al=4)
    lines_rescue = dataclasses.replace(lines_warm, alphas=rescue.alphas)
    paths = [("k2a", spec, None), ("config2", chip_smoke.config2(), None)]
    paths += [(tag, family_spec(fam), fam) for tag, fam in (
        ("pathA", "canonical_carlike"), ("pathB", "converter_lines"),
        ("pathC", "polygon_footprint"), ("pathD", "via_points"), ("pathE", "nonuniform"))]
    if hasattr(chip_smoke, "crank_nicolson_flagship"):  # a tree with the rule
        paths.append(("pathF", chip_smoke.crank_nicolson_flagship(), None))
    cases = []
    for tag, sp, fam in paths:
        lines = tag == "pathB"
        cases.append((tag, sp, fam, lines_warm if lines else warm, chip_smoke.BATCH))
        cases.append((f"{tag}_rescue", sp, fam, lines_rescue if lines else rescue,
                      chip_smoke.LINES_RESCUE_SLOTS if lines else chip_smoke.RESCUE_SLOTS))
    return cases


def times():
    """K1 and the fused kernel's launches of every main path's fleet cycle
    from the seed (``main_path_cases``: the warm solves at B=4096 and the
    rescues at 1024 and 2048), in the working directory's tree (its
    ``chip_smoke`` and package); where the tree has the team layout, each
    launch's team, teams per block, shared bytes per team and teams per SM
    (the CUDA occupancy calculator) beside its time."""
    import torch

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.ops import nvcc_build, riccati_cuda
    from mpc_local_planner_tpu_torch.solvers import al_sqp

    device = torch.device("cuda", 0)
    cases = main_path_cases(device)
    riccati_cuda.build()
    k2a.build(tuple(sorted({k2a.group(sp, torch.float32) for _, sp, _, _, _ in cases})))
    spec, _, warm, _ = chip_smoke.flagship()
    scen = chip_smoke.ensemble(spec, chip_smoke.BATCH, device)
    args = chip_smoke.riccati_inputs(spec, warm, scen)
    out = {"tree": os.getcwd(), "k1_ms": chip_smoke._cuda_ms(
        lambda: riccati_cuda.lqr_solve_cuda(*args, nx=3, free_tau=True), 25)}
    k1 = {}
    for batch, N in K1_SHAPES:
        sp = chip_smoke.flagship(N=N)[0]
        a = chip_smoke.riccati_inputs(sp, warm, chip_smoke.ensemble(sp, batch, device))
        k1[f"B={batch} N={N}"] = {
            "ms": chip_smoke._cuda_ms(
                lambda: riccati_cuda.lqr_solve_cuda(*a, nx=3, free_tau=True), 25),  # noqa: B023
            "device_ms": device_ms(
                lambda: riccati_cuda.lqr_solve_cuda(*a, nx=3, free_tau=True))}  # noqa: B023
    out["k1"] = k1
    out["k1_build"] = k1_report(riccati_cuda, nvcc_build)
    layout = {}
    for tag, sp, family, st, batch in cases:
        st = dataclasses.replace(st, fused="auto")
        scen = chip_smoke.ensemble(sp, batch, device, family=family)
        init, duals = al_sqp.default_init(sp, st, scen)
        out[f"{tag}_ms"] = chip_smoke._cuda_ms(
            lambda: k2a.fused_solve_cuda(sp, st, scen, init, duals), 25)  # noqa: B023
        if hasattr(k2a, "launch_geometry"):
            lib = k2a._load(k2a.group(sp, torch.float32))
            geo = k2a.library_geometry(lib, sp.N, sp.obstacle_cap)
            layout[tag] = {"team": geo.team, "teams_per_block": geo.teams_per_block,
                           "shared_bytes_per_team": geo.shared_bytes // geo.teams_per_block,
                           "workspace_per_scenario": geo.workspace,
                           "teams_per_sm": geo.teams_per_block * k2a.occupancy(
                               lib, sp, st, scen.obstacles)}
    print(json.dumps({"times": out, "layout": layout or None, "card": chip_smoke.card_line()}))


# the team sizes and shared budgets ``teams`` builds: (lanes, float bytes)
TEAM_VARIANTS = ((32, 18944), (32, 20480), (16, 11264), (8, 6144))


def teams():
    """The kernel's team size and a team's shared budget, measured: the
    simple-car minimum-time group (the flagship's, paths A's, B's and C's
    instantiations) built from this tree's source with the two constants
    set to each of ``TEAM_VARIANTS``, those launches of the main paths
    timed in turns (CUDA events, median of 15 each, the variants in order
    and then in reverse), with each variant's ptxas rows and teams per SM
    and whether its converged flags agree with the first variant's."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda as k2a
    from mpc_local_planner_tpu_torch.ops import nvcc_build
    from mpc_local_planner_tpu_torch.solvers import al_sqp

    device = torch.device("cuda", 0)
    g = k2a.Group(False, 1, 0, False, 0)
    cases = [c for c in main_path_cases(device) if k2a.group(c[1], torch.float32) == g]
    source = k2a.SOURCE.read_text()
    nvcc_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def build(variant):
        team, budget = variant
        text = re.sub(r"constexpr int TEAM = \d+;", f"constexpr int TEAM = {team};", source)
        text = re.sub(r"constexpr int SMEM_TEAM_F32 = \d+;",
                      f"constexpr int SMEM_TEAM_F32 = {budget};", text)
        src = nvcc_build.BUILD_DIR / f"fused_probe_team{team}_{budget}.cu"
        src.write_text(text)
        lib = src.with_name(f"lib{src.stem}.so")
        lib.unlink(missing_ok=True)
        report = nvcc_build.build_library(src, lib, g.defines())
        return variant, k2a.bind(lib, g), _ptxas_rows(report["ptxas"])

    with ThreadPoolExecutor(max_workers=len(TEAM_VARIANTS)) as pool:
        built = {v: (lib, ptx) for v, lib, ptx in pool.map(build, TEAM_VARIANTS)}
    inputs = []
    for tag, sp, family, st, batch in cases:
        st = dataclasses.replace(st, fused="auto")
        scen = chip_smoke.ensemble(sp, batch, device, family=family)
        inputs.append((tag, sp, st, scen) + al_sqp.default_init(sp, st, scen))
    default_budget, first = k2a.SMEM_TEAM_F32, {}
    rows = {f"{t}x{b}": {"ptxas": built[(t, b)][1], "cases": {}} for t, b in TEAM_VARIANTS}
    try:
        for team, budget in TEAM_VARIANTS + TEAM_VARIANTS[::-1]:
            lib = built[(team, budget)][0]
            k2a._libs[g], k2a.SMEM_TEAM_F32 = lib, budget
            for tag, sp, st, scen, init, duals in inputs:
                assert k2a.library_geometry(lib, sp.N, sp.obstacle_cap) == k2a.launch_geometry(
                    g, sp.N, sp.obstacle_cap, team)
                out = k2a.fused_solve_cuda(sp, st, scen, init, duals)
                first.setdefault(tag, out.converged)
                row = rows[f"{team}x{budget}"]["cases"].setdefault(tag, {
                    "ms": [], "teams_per_sm": k2a.occupancy(lib, sp, st, scen.obstacles)
                    * k2a.BLOCK // team,
                    "conv_agrees": bool(torch.equal(out.converged, first[tag]))})
                row["ms"].append(chip_smoke._cuda_ms(
                    lambda: k2a.fused_solve_cuda(sp, st, scen, init, duals), 15))  # noqa: B023
    finally:
        k2a.SMEM_TEAM_F32 = default_budget
        k2a._libs.pop(g, None)
    print(json.dumps({"teams": rows, "card": chip_smoke.card_line()}))


# K1's shapes on the main paths: (batch, N) — the warm solve's and the
# rescue's Riccati sweeps at the flagship's horizon, and a long horizon
K1_SHAPES = ((4096, 30), (1024, 30), (4096, 96), (1024, 96))
# K1's designs ``k1`` builds: riccati_cuda.Design(team, spb, chunk, slots,
# smem_f32); the first is the source's own (riccati_cuda.DESIGN)
K1_VARIANTS = (
    (8, 4, 4, 2, 6656), (8, 4, 4, 2, 6144), (4, 8, 4, 2, 6656), (8, 4, 6, 2, 8192),
    (8, 4, 8, 4, 18432), (8, 2, 8, 4, 18432), (8, 8, 8, 2, 10240), (4, 8, 8, 2, 10240),
)
# and one block per SM at the default design (132 blocks of 4): one block's
# latency
K1_LATENCY_SHAPE = (528, 30)


def k1():
    """K1's design measured: the source built at each of ``K1_VARIANTS``
    (one nvcc each, all at once), each held to the plain version at every
    shape of ``K1_SHAPES`` in float, then timed on the device
    (``device_ms``) in turns, the variants in order and then in reverse."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from mpc_local_planner_tpu_torch.ops import nvcc_build, riccati_cuda
    from mpc_local_planner_tpu_torch.solvers.riccati import lqr_solve

    device = torch.device("cuda", 0)
    designs = [riccati_cuda.Design(*v) for v in K1_VARIANTS]
    nvcc_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def build(d):
        lib = nvcc_build.BUILD_DIR / f"libfused_probe_k1_{'_'.join(map(str, d))}.so"
        lib.unlink(missing_ok=True)
        report = nvcc_build.build_library(riccati_cuda.SOURCE, lib, d.defines())
        return d, riccati_cuda.bind(lib), chip_smoke.ptxas_rows(report["ptxas"])

    with ThreadPoolExecutor(max_workers=len(designs)) as pool:
        built = {d: (lib, ptx) for d, lib, ptx in pool.map(build, designs)}
    _, warm, _ = chip_smoke.flagship()[1:]
    inputs = {}
    for batch, N in K1_SHAPES + (K1_LATENCY_SHAPE,):
        sp = chip_smoke.flagship(N=N)[0]
        inputs[(batch, N)] = chip_smoke.riccati_inputs(
            sp, warm, chip_smoke.ensemble(sp, batch, device))
    stream = torch.cuda.current_stream(device).cuda_stream
    rows = {}
    for d in designs:
        lib, ptx = built[d]
        row = rows[",".join(map(str, d))] = {"ptxas": ptx, "shapes": {}}
        for (batch, N), args in inputs.items():
            plain = lqr_solve(*args, nx=3, free_tau=True)
            _, rel = chip_smoke._max_rel_err(riccati_cuda.launch(lib, args, True, stream), plain)
            row["shapes"][f"B={batch} N={N}"] = {
                "rel_err": rel, "device_ms": [],
                "geometry": riccati_cuda.library_geometry(lib, N, torch.float32)._asdict(),
                "blocks_per_sm": riccati_cuda.occupancy(lib, N, torch.float32)}
    for d in designs + designs[::-1]:
        lib = built[d][0]
        for (batch, N), args in inputs.items():
            rows[",".join(map(str, d))]["shapes"][f"B={batch} N={N}"]["device_ms"].append(
                device_ms(lambda: riccati_cuda.launch(lib, args, True, stream)))  # noqa: B023
    print(json.dumps({"k1_variants": rows, "card": chip_smoke.card_line()}))


# ``stamps``: where the copy of K1's source gets its clock64() stamps (text
# found once in the source, the lines put after it); slot 0 the teams' start,
# 1 + v each backward chunk's data landed, 10 + i the end of the i-th
# backward stage, 50 + f each rollout chunk's start, 60 + k the end of
# rollout stage k, 100 + f each team flush's end, 127 the end
K1_STAMPS = (
    ("  const bool live = b < a.B;\n",
     "  long long* stamp = reinterpret_cast<long long*>(a.tape) + blockIdx.x * 128;\n"
     "  const long long t0 = clock64();\n  int stage_no = 0;\n"
     "#define STAMP(i) do { if (!WS && threadIdx.x == 0 && (i) < 128) "
     "stamp[i] = clock64() - t0; } while (0)\n"),
    ("  if (threadIdx.x >= CT) return;  // the idle lanes of the last teams' warp\n",
     "  STAMP(0);\n"),
    ("    phases ^= 1u << (v % S);\n", "    STAMP(1 + v);\n"),
    ("          P[l][i] = s2;\n        }\n      }\n",
     "      STAMP(10 + stage_no + (P[0][0] != P[0][0]));\n      ++stage_no;\n"),
    ("    const int k0 = f * C;\n", "    STAMP(50 + f);\n"),
    ("      for (int i = 0; i < NA; ++i) z[i] = zn[i];\n",
     "      STAMP(60 + k + (z[0] != z[0]));\n"),
    ("        a.dxs[(static_cast<size_t>(b) * (N + 1) + k0 + 1) * NX + e] = ost[C * NU + e];\n"
     "    }\n    __syncwarp(warp_mask);\n", "    STAMP(100 + f);\n"),
)


def stamps():
    """K1's cycles at N=30, measured: a copy of the source with clock64()
    stamps by thread 0 of each block (``K1_STAMPS``), written into the
    buffer passed as the workspace's pointer (unused where the tape is in
    shared memory), at B=528 (one block an SM), 1024 and 4096; the median
    over blocks of each phase: the teams' first data, a backward stage, a
    rollout stage, a team's flush of a chunk, the whole block."""
    import torch

    from mpc_local_planner_tpu_torch.ops import nvcc_build, riccati_cuda

    N = 30
    source = riccati_cuda.SOURCE.read_text()
    for found, _ in K1_STAMPS:
        if source.count(found) != 1:
            raise RuntimeError(f"stamps: the source no longer has {found!r} once")
    for found, added in K1_STAMPS:
        source = source.replace(found, found + added)
    tail = "  }\n}\n\ntemplate <typename T>\nint launch("
    if source.count(tail) != 1:
        raise RuntimeError("stamps: the kernel's end is not where it was")
    source = source.replace(tail, "  }\n  STAMP(127);\n}\n\ntemplate <typename T>\nint launch(")
    nvcc_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = nvcc_build.BUILD_DIR / "fused_probe_k1_stamps.cu"
    src.write_text(source)
    path = src.with_name(f"lib{src.stem}.so")
    path.unlink(missing_ok=True)
    nvcc_build.build_library(src, path)
    lib = riccati_cuda.bind(path)
    geo = riccati_cuda.launch_geometry(N, torch.float32, lib.design)
    if geo.workspace:
        raise RuntimeError("stamps: the design keeps the tape in the workspace at N=30")
    device = torch.device("cuda", 0)
    warm = chip_smoke.flagship()[2]
    stream = torch.cuda.current_stream(device).cuda_stream
    spec = chip_smoke.flagship(N=N)[0]
    rows = {}
    for batch in (528, 1024, 4096):
        args = chip_smoke.riccati_inputs(spec, warm, chip_smoke.ensemble(spec, batch, device))
        blocks = -(-batch // geo.scenarios_per_block)
        buf = torch.zeros(blocks * 128, dtype=torch.int64, device=device)
        outs = [torch.empty(shape, dtype=torch.float32, device=device)
                for shape in ((batch, N + 1, 3), (batch, N, 2), (batch,), (batch,))]
        for _ in range(3):
            rc = lib.riccati_sweep_f32(*(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
                                       buf.data_ptr(), batch, N, 1, stream)
            if rc:
                raise RuntimeError(f"stamps: launch failed ({rc})")
        torch.cuda.synchronize()
        t = buf.view(blocks, 128).double().median(dim=0).values.tolist()
        nq = -(-N // geo.chunk)
        back = [t[10 + i] - t[9 + i] for i in range(1, N)]
        roll = [t[60 + k] - t[59 + k] for k in range(1, N) if k % geo.chunk]
        flush = [t[100 + f] - t[60 + min(N, (f + 1) * geo.chunk) - 1] for f in range(nq)]
        rows[f"B={batch}"] = {
            "first_data": t[1], "backward_stage": statistics.median(back),
            "backward_total": t[10 + N - 1] - t[1], "rollout_stage": statistics.median(roll),
            "rollout_total": t[100 + nq - 1] - t[50], "flush_per_chunk": statistics.median(flush),
            "block": t[127]}
    print(json.dumps({"k1_stamps_cycles": rows, "geometry": geo._asdict(),
                      "card": chip_smoke.card_line()}))


def main(names):
    import torch

    if not torch.cuda.is_available():
        chip_smoke._fail("torch.cuda.is_available() is false: this probe needs a CUDA card")
    print(f"device: {chip_smoke.card_line()}")
    for name in names or ("registers", "timing", "rounding"):
        name, _, case = name.partition("=")
        probe = {"registers": registers, "timing": timing, "rounding": rounding,
                 "times": times, "teams": teams, "k1": k1, "stamps": stamps}[name]
        probe(case) if case else probe()


if __name__ == "__main__":
    main(sys.argv[1:])
