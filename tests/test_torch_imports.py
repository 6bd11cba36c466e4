"""The port imports neither JAX nor anything of the JAX package.

Walks the AST of every module of ``mpc_local_planner_tpu_torch``, of
``chip_smoke.py`` and of ``fused_probe.py``. The JAX package's name is a
prefix of the port's, so the guard matches the exact module name
``mpc_local_planner_tpu`` or its ``mpc_local_planner_tpu.`` submodules, never
the bare prefix.
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
    return files + [ROOT / "chip_smoke.py", ROOT / "fused_probe.py"]


def test_torch_port_and_chip_smoke_import_no_jax():
    files = _port_files()
    assert len(files) > 20
    found = {str(f.relative_to(ROOT)): _bad_imports(f.read_text()) for f in files}
    assert {k: v for k, v in found.items() if v} == {}


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
