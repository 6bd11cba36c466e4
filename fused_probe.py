#!/usr/bin/env python3
"""Measurements of the fused kernel (``csrc/fused_al_sqp.cu``) and of K1 on
one NVIDIA GPU, beside ``chip_smoke.py``:

    python3 fused_probe.py [registers] [timing] [rounding[=CASE]] [times] [teams]
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
  path. To compare two commits on one card, unpack the parent with
  ``git archive`` into an ignored directory and run there and here in
  turns (parent, change, change, parent):
  ``(cd DIR && python3 ../fused_probe.py times)``.
- teams: the team size and a team's shared budget, measured on the
  simple-car group (``TEAM_VARIANTS``).

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
    from mpc_local_planner_tpu_torch.ops import riccati_cuda
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


def main(names):
    import torch

    if not torch.cuda.is_available():
        chip_smoke._fail("torch.cuda.is_available() is false: this probe needs a CUDA card")
    print(f"device: {chip_smoke.card_line()}")
    for name in names or ("registers", "timing", "rounding"):
        name, _, case = name.partition("=")
        probe = {"registers": registers, "timing": timing, "rounding": rounding,
                 "times": times, "teams": teams}[name]
        probe(case) if case else probe()


if __name__ == "__main__":
    main(sys.argv[1:])
