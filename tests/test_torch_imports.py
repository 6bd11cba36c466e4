"""The port imports neither JAX nor anything of the JAX package.

Walks the AST of every module of ``mpc_local_planner_tpu_torch``, of
``chip_smoke.py``, ``fused_probe.py`` and ``trace_probe.py``. The JAX
package's name is a prefix of the port's, so the guard matches the exact
module name ``mpc_local_planner_tpu`` or its ``mpc_local_planner_tpu.``
submodules, never the bare prefix.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "mpc_local_planner_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _bad_imports(source: str):
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    return bad


def _port_files():
    files = sorted((ROOT / "mpc_local_planner_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "fused_probe.py", ROOT / "trace_probe.py"]


def test_torch_port_and_chip_smoke_import_no_jax():
    files = _port_files()
    assert len(files) > 20
    found = {str(f.relative_to(ROOT)): _bad_imports(f.read_text()) for f in files}
    assert {k: v for k, v in found.items() if v} == {}


@pytest.mark.parametrize(
    "module",
    [
        "utils/worlds.py",
        "planner/local_planner.py",
        "solvers/golden.py",
        "solvers/f64_fallback.py",
        "solvers/lsq_lm.py",
        "solvers/riccati_pscan.py",
        "planner/config.py",
        "planner/controller.py",
        "core/time_series.py",
        "native.py",
        "msgs.py",
        "planner/serving.py",
        "utils/conversion.py",
        "utils/publisher.py",
        "examples/demo_planner.py",
        "examples/demo_rooms.py",
        "examples/demo_dynamic_obstacle.py",
        "examples/demo_fleet.py",
        "examples/demo_serving.py",
        "parallel/sharding.py",
        "parallel/ensembles.py",
        "parallel/distributed.py",
        "parallel/dryrun.py",
        "core/value_comparison.py",
        "core/references.py",
        "core/signals.py",
        "numerics/finite_differences.py",
        "numerics/control_theory.py",
        "controllers/lqr.py",
        "controllers/simple_state.py",
        "controllers/pid.py",
        "controllers/dual_mode.py",
        "plants/simulated_plant.py",
        "tasks/closed_loop.py",
        "checkpoint.py",
        "profiling.py",
        "utils/compilation_cache.py",
    ],
)
def test_torch_host_and_solver_modules_import_no_jax(module):
    """The numpy-only, solver, parallel and aux modules keep their own copies
    of what they need (``Costmap``, ``inflate``, ``astar_plan``): none imports
    JAX or the JAX package (``parallel/dryrun.py`` also runs as a process of
    its own), and each is one of the files the walk above checks."""
    path = ROOT / "mpc_local_planner_tpu_torch" / module
    assert path in _port_files()
    assert _bad_imports(path.read_text()) == []


@pytest.mark.parametrize(
    "source, bad",
    [
        ("import jax.numpy as jnp", True),
        ("from jax import lax", True),
        ("import mpc_local_planner_tpu", True),
        ("from mpc_local_planner_tpu.native import load", True),
        ("from mpc_local_planner_tpu import benchmarks", True),
        ("def f():\n    import jax\n", True),
        ("import mpc_local_planner_tpu_torch.solvers", False),
        ("from mpc_local_planner_tpu_torch.ops import riccati_cuda", False),
        ("from . import so2", False),
        ("import jaxtyping", False),
    ],
)
def test_torch_import_guard_matches_exact_module_names(source, bad):
    assert bool(_bad_imports(source)) is bad
