"""The port's public import surface and the pieces of it that JAX exports
beside its solvers (CPU).

- Every name that a JAX package ``__init__.py`` imports or lists in
  ``__all__`` (read by AST, without importing JAX's package) imports from
  the port's counterpart, and the port's ``__all__`` lists JAX's.
- Each subpackage of the port imports first and alone, with JAX blocked and
  no process started (no kernel build at import time).
- ``ops.smallmat``'s ``inv2`` (with ``eps``), ``solve2``, ``solve3`` and
  ``solve_unrolled`` against JAX's at 1e-12 in float64, on seeded inputs and
  on near-singular 2×2 blocks inside ``eps``.
- ``make_solver(batched=False)`` against JAX ``make_solver(spec, settings,
  batched=False)`` on one config #3 scenario (N=8, 2 slots, a 2×2 budget,
  which leaves the lane unconverged on both sides) in float32, at the
  tolerances of JAX ``tests/test_fused_solver.py``: xs and us
  5e-5, dt 5e-6, cost and eq_norm 1e-5, duals 5e-3 absolute or 1e-3
  relative.
"""

import ast
import dataclasses
import importlib
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu.benchmarks import config3_carlike_min_time as j_config3
from mpc_local_planner_tpu.benchmarks import random_ensemble as j_random_ensemble
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.ops import smallmat as j_sm
from mpc_local_planner_tpu.solvers import al_sqp as j_al

from mpc_local_planner_tpu_torch import convert
from mpc_local_planner_tpu_torch.benchmarks import config3_carlike_min_time as t_config3
from mpc_local_planner_tpu_torch.ocp.grid import Primal as TPrimal
from mpc_local_planner_tpu_torch.ocp.spec import Scenario as TScenario
from mpc_local_planner_tpu_torch.ops import fused_al_sqp_cuda, riccati_cuda
from mpc_local_planner_tpu_torch.ops import smallmat as t_sm
from mpc_local_planner_tpu_torch.solvers import al_sqp as t_al

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = ROOT / "mpc_local_planner_tpu"
INITS = sorted(p.relative_to(JAX_PACKAGE).as_posix()
               for p in JAX_PACKAGE.glob("**/__init__.py"))


def _surface(path: Path):
    """(names a package ``__init__.py`` imports, its ``__all__`` or None)."""
    names, listed = set(), None
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            listed = list(ast.literal_eval(node.value))
    return names - {"annotations"}, listed


def _port_module(init: str) -> str:
    parts = ["mpc_local_planner_tpu_torch"] + init.split("/")[:-1]
    return ".".join(parts)


@pytest.mark.parametrize("init", INITS)
def test_torch_package_exports_the_jax_surface(init):
    names, listed = _surface(JAX_PACKAGE / init)
    module = importlib.import_module(_port_module(init))
    assert sorted(n for n in names | set(listed or ()) if not hasattr(module, n)) == []
    if listed is not None:
        assert [n for n in listed if n not in module.__all__] == []


def test_torch_each_subpackage_imports_alone_without_jax_or_a_build():
    """Each subpackage imported first in a clean module table (an import
    cycle shows only then), with JAX blocked and process creation refused."""
    packages = [_port_module(i) for i in INITS]
    script = textwrap.dedent(f"""
        import importlib, subprocess, sys
        import torch  # noqa: F401
        for name in ("jax", "jaxlib", "mpc_local_planner_tpu"):
            sys.modules[name] = None
        def refuse(*args, **kwargs):
            raise RuntimeError(f"a process started at import time: {{args[:1]}}")
        subprocess.Popen.__init__ = refuse
        for pkg in {packages!r}:
            for name in [m for m in sys.modules if m.startswith("mpc_local_planner_tpu_torch")]:
                del sys.modules[name]
            importlib.import_module(pkg)
        print("ok", len({packages!r}))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split() == ["ok", str(len(packages))]


# --------------------------------------------------------------------------- #
# ops.smallmat


def _mats(n, shape=(64,), k=None, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal(shape + (n, n)) + n * np.eye(n)
    b = rng.standard_normal(shape + ((n,) if k is None else (n, k)))
    return A, b


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_torch_inv2_matches_jax(eps):
    A, _ = _mats(2, seed=1)
    # near-singular blocks, their determinants inside ±eps of 0 and of both signs
    rng = np.random.default_rng(2)
    row = rng.standard_normal((16, 1, 2))
    near = np.concatenate([row, row * (1 + 1e-4 * rng.standard_normal((16, 1, 1)))], axis=1)
    A = np.concatenate([A, near])
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    assert (np.abs(det[64:]) < 1e-3).all() and (det[64:] > 0).any() and (det[64:] < 0).any()
    _close(t_sm.inv2(torch.from_numpy(A), eps=eps), j_sm.inv2(jnp.asarray(A), eps=eps))


@pytest.mark.parametrize("k", [None, 1, 4])
def test_torch_solve2_solve3_match_jax(k):
    for n, t_solve, j_solve in ((2, t_sm.solve2, j_sm.solve2), (3, t_sm.solve3, j_sm.solve3)):
        A, b = _mats(n, k=k, seed=n)
        _close(t_solve(torch.from_numpy(A), torch.from_numpy(b)),
               j_solve(jnp.asarray(A), jnp.asarray(b)))


@pytest.mark.parametrize("n,m", [(1, 1), (3, 2), (6, 6)])
def test_torch_solve_unrolled_matches_jax(n, m):
    A, B = _mats(n, shape=(8, 5), k=m, seed=n + m)
    got = t_sm.solve_unrolled(torch.from_numpy(A), torch.from_numpy(B))
    _close(got, j_sm.solve_unrolled(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(A, B), rtol=1e-10, atol=1e-10)


# --------------------------------------------------------------------------- #
# make_solver(batched=False)

N, M = 8, 2
SETTINGS = dict(n_al=2, n_sqp=2, rho0=120.0, reg0=1.0, tol_eq=1e-2, tol_ineq=1e-2,
                alphas=(1.0, 0.5, 0.22))


def _np(tree):
    if dataclasses.is_dataclass(tree):
        return {f.name: _np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def test_torch_unbatched_make_solver_matches_jax():
    jspec = j_config3(N=N, obstacle_cap=M)
    scen = j_random_ensemble(jspec, 1, jax.random.PRNGKey(3), dtype=jnp.float32)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.3 * (scen.xf - scen.x0))
    scen = jax.tree_util.tree_map(lambda a: a[0], scen)
    init = j_initial_primal(jspec, scen)
    jst = j_al.SolverSettings(**SETTINGS)
    duals = j_al.init_duals(jspec, jst, jnp.float32)
    want = _np(j_al.make_solver(jspec, jst, batched=False)(scen, init, duals))

    solve = t_al.make_solver(t_config3(N=N, obstacle_cap=M), t_al.SolverSettings(**SETTINGS),
                             device="cpu", batched=False)
    launches = (riccati_cuda.lqr_solve_cuda.launches, fused_al_sqp_cuda.fused_solve_cuda.launches)
    got = convert.to_numpy(solve(
        convert.from_numpy(TScenario, _np(scen), "cpu"),
        convert.from_numpy(TPrimal, _np(init), "cpu"),
        convert.from_numpy(t_al.DualState, _np(duals), "cpu"),
    ))
    assert launches == (riccati_cuda.lqr_solve_cuda.launches,
                        fused_al_sqp_cuda.fused_solve_cuda.launches)
    assert got["primal"]["xs"].shape == want["primal"]["xs"].shape == (N + 1, 3)
    assert got["primal"]["xs"].dtype == np.float32
    assert got["converged"] == want["converged"]
    for k, atol in (("xs", 5e-5), ("us", 5e-5), ("dt", 5e-6)):
        np.testing.assert_allclose(got["primal"][k], want["primal"][k], atol=atol, rtol=0,
                                   err_msg=k)
    for k in ("cost", "eq_norm"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
    for k in want["duals"]:
        a, b = got["duals"][k], want["duals"][k]
        assert a.shape == b.shape and np.all(np.abs(a - b) <= np.maximum(5e-3, 1e-3 * np.abs(b))), k
