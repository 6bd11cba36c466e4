"""The port's multi-process cluster on the CPU (``parallel/distributed.py``,
``python -m mpc_local_planner_tpu_torch.parallel.dryrun``).

Two processes join one gloo process group on localhost, each solves its
``process_local_batch`` of one global ensemble (the flagship at N=5 with 2
circle slots, 8 lanes, float64: JAX's two-process worker's problem with the
goals pulled in to 40%, made by the JAX package and read from one ``.npz``
by both ranks) at the rank's budget (``dryrun.CHECK_SETTINGS``: 4×4, which
leaves some lanes converged and some not), and all-reduces
``ensemble_summary``. Both ``RESULT`` lines must be
equal and equal JAX's ``ensemble_summary`` of the same solve (the count
exactly, the rest at 1e-9). Each child runs one intra-op thread, joins
within a finite timeout and is waited for with a timeout, so that a hang
fails in seconds.
"""

import dataclasses
import json
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_local_planner_tpu import benchmarks as jb
from mpc_local_planner_tpu.ocp.grid import initial_primal as j_initial_primal
from mpc_local_planner_tpu.parallel.sharding import ensemble_summary as j_ensemble_summary
from mpc_local_planner_tpu.solvers.al_sqp import SolverSettings as JSettings
from mpc_local_planner_tpu.solvers.al_sqp import init_duals as j_init_duals
from mpc_local_planner_tpu.solvers.al_sqp import solve_single as j_solve_single

from mpc_local_planner_tpu_torch.parallel import distributed
from mpc_local_planner_tpu_torch.parallel.dryrun import CHECK_SETTINGS, load_ensemble

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SLOTS, LANES = 5, 2, 8


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _flat(tree, prefix=""):
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = np.asarray(v)
    return out


def _jax_ensemble_and_summary():
    spec = jb.config3_carlike_min_time(N=N, obstacle_cap=SLOTS)
    st = JSettings(**{f.name: getattr(CHECK_SETTINGS, f.name)
                      for f in dataclasses.fields(CHECK_SETTINGS)})
    scen = jb.random_ensemble(spec, LANES, jax.random.PRNGKey(7), dtype=jnp.float64)
    scen = dataclasses.replace(scen, xf=scen.x0 + 0.4 * (scen.xf - scen.x0))
    duals = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (LANES,) + a.shape),
                                   j_init_duals(spec, st, dtype=jnp.float64))
    res = jax.jit(jax.vmap(lambda s, i, d: j_solve_single(spec, st, s, i, d)))(
        scen, j_initial_primal(spec, scen), duals)
    return scen, [float(v) for v in j_ensemble_summary(res)]


def test_torch_two_rank_gloo_cluster_matches_jax_summary(tmp_path):
    scen, (n_conv, mean_cost, max_eq, max_viol) = _jax_ensemble_and_summary()
    path = tmp_path / "ensemble.npz"
    np.savez(path, **_flat(scen))
    loaded = load_ensemble(str(path), "cpu")
    np.testing.assert_array_equal(loaded.obstacles.circles.numpy(),
                                  np.asarray(scen.obstacles.circles))
    assert loaded.x0.dtype == torch.float64

    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mpc_local_planner_tpu_torch.parallel.dryrun", "--rank",
         str(rank), "--world-size", "2", "--coordinator", coord, "--device", "cpu",
         "--N", str(N), "--slots", str(SLOTS), "--ensemble", str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=tmp_path)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = {}
    for out in outs:
        assert "backend gloo" in out, out
        m = re.search(r"^RESULT rank=(\d) (\{.*\})$", out, re.M)
        assert m, out
        lines[m.group(1)] = m.group(2)
    assert set(lines) == {"0", "1"} and lines["0"] == lines["1"]
    got = json.loads(lines["0"])
    assert got["world_size"] == 2 and got["global_batch"] == LANES
    assert got["k1_launches"] == 0 and got["fused_launches"] == 0  # CPU: the plain solve
    assert got["n_converged"] == int(n_conv) and 0 < n_conv < LANES
    np.testing.assert_allclose(got["mean_cost"], mean_cost, rtol=1e-9)
    np.testing.assert_allclose(got["max_eq_norm"], max_eq, rtol=1e-9)
    np.testing.assert_allclose(got["max_ineq_viol"], max_viol, rtol=1e-9, atol=1e-15)


def test_torch_single_process_mesh_slice_and_initialize_arguments(monkeypatch):
    """Without a process group the cluster is this process alone; joining one
    needs its coordinator, size and rank, from the arguments or PyTorch's
    launcher variables."""
    mesh = distributed.global_mesh(local_devices=["cpu", "cpu"])
    assert mesh.shape == {"dcn": 1, "ici": 2} and len(mesh.local_devices()) == 2
    assert distributed.global_mesh(1, local_devices=["cpu", "cpu"]).shape == {"dcn": 2, "ici": 1}
    with pytest.raises(ValueError):
        distributed.global_mesh(3, local_devices=["cpu", "cpu"])
    assert distributed.process_local_batch(8) == slice(0, 8)
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError):
        distributed.initialize()
    with pytest.raises(ValueError):
        distributed.initialize("127.0.0.1:1", num_processes=2)
    assert not torch.distributed.is_initialized()
