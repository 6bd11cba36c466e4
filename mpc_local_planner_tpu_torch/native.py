"""ctypes bindings for the native (C++) costmap runtime (port of
``mpc_local_planner_tpu.native``).

The reference's native L7 path: costmap_2d scans, costmap_converter polygon,
line and blob extraction, the blob tracker and CostmapModel feasibility
(``native/costmap.cpp``). The library is built from that source at first use
by ``g++ -O3 -march=native -fPIC -shared -std=c++17`` into ``_build/``
(ignored by git; ``utils.compilation_cache.enable_persistent_cache`` points
it elsewhere), under a name keyed by the source's hash, the flags and
what ``-march=native`` means on this host, so a library built for another
host is never loaded.
``available()`` is false only when no C++ compiler is found; the planner
shell then takes the Python versions in ``planner/local_planner.py``. A
build that fails raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from mpc_local_planner_tpu_torch.utils.compilation_cache import DEFAULT_BUILD_DIR, build_dir

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "costmap.cpp"
BUILD_DIR = DEFAULT_BUILD_DIR  # the default of ``build_dir()``
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
_lib = None


def compiler() -> Optional[str]:
    """The C++ compiler (g++, else c++), or None."""
    return shutil.which("g++") or shutil.which("c++")


def _target_flags(cxx: str) -> str:
    """What ``-march=native`` means on this host, as the compiler expands it
    (the target and each instruction-set flag)."""
    proc = subprocess.run([cxx, "-march=native", "-E", "-v", "-x", "c++", os.devnull],
                          capture_output=True, text=True)
    return " ".join(tok for ln in proc.stderr.splitlines() if "cc1" in ln
                    for tok in ln.split() if tok.startswith("-m"))


def library_path(cxx: str) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_target_flags(cxx).encode())
    return build_dir() / f"libmpccostmap_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/costmap.cpp`` if its library is missing; returns the
    library's path. Raises when no compiler is found or the build fails."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found to build the native costmap runtime")
    lib = library_path(cxx)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> Optional[ctypes.CDLL]:
    """Build (at first use), load and memoize the native library; None when
    no compiler is found."""
    global _lib
    if _lib is not None:
        return _lib
    if compiler() is None:
        return None
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.mpc_costmap_extract_points.restype = ctypes.c_int
    lib.mpc_costmap_extract_points.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, dp, ctypes.c_double, ctypes.c_double, ctypes.c_uint8,
        dp, ctypes.c_int, ctypes.c_double,
    ]
    lib.mpc_costmap_extract_lines.restype = ctypes.c_int
    lib.mpc_costmap_extract_lines.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_uint8, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, dp, ctypes.c_int,
    ]
    lib.mpc_costmap_cluster_centroids.restype = ctypes.c_int
    lib.mpc_costmap_cluster_centroids.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_uint8, ctypes.c_int, dp, ctypes.c_int,
    ]
    lib.mpc_tracker_update.restype = ctypes.c_int
    lib.mpc_tracker_update.argtypes = [
        dp, ctypes.c_int, dp, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ip, dp, ctypes.c_int, ctypes.c_int,
    ]
    lib.mpc_costmap_extract_polygons.restype = ctypes.c_int
    lib.mpc_costmap_extract_polygons.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_uint8, ctypes.c_int, dp, ip, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.mpc_costmap_footprint_cost.restype = ctypes.c_double
    lib.mpc_costmap_footprint_cost.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ]
    lib.mpc_costmap_trajectory_feasible.restype = ctypes.c_int
    lib.mpc_costmap_trajectory_feasible.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, dp, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_double,
    ]
    _lib = lib
    return lib


def available() -> bool:
    """True unless no C++ compiler is found."""
    return compiler() is not None


def _grid(costmap):
    data = np.ascontiguousarray(costmap.data, dtype=np.uint8)
    H, W = data.shape
    return data, H, W, float(costmap.origin[0]), float(costmap.origin[1]), float(costmap.resolution)


def extract_points(
    costmap, robot_pose, behind_dist: float, cutoff_dist: float,
    threshold: int = 254, max_out: int = 4096,
    force_inclusion_dist: float = 0.0,
) -> np.ndarray:
    lib = load()
    data, H, W, ox, oy, res = _grid(costmap)
    pose = np.ascontiguousarray(np.asarray(robot_pose, dtype=np.float64)[:3])
    out = np.empty((max_out, 2), dtype=np.float64)
    n = lib.mpc_costmap_extract_points(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W, ox, oy, res,
        pose.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(behind_dist), float(cutoff_dist), threshold,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_out,
        float(force_inclusion_dist),
    )
    return out[:n].copy()


def extract_lines(
    costmap, threshold: int = 254, min_cluster: int = 2,
    inlier_dist: float = 0.08, min_inliers: int = 4, max_out: int = 64,
) -> np.ndarray:
    """Line-segment obstacles from the costmap (parity:
    CostmapToLinesDBSRANSAC). Returns (L, 2, 2) segment endpoints."""
    lib = load()
    data, H, W, ox, oy, res = _grid(costmap)
    out = np.empty((max_out, 4), dtype=np.float64)
    n = lib.mpc_costmap_extract_lines(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W, ox, oy, res,
        threshold, min_cluster, float(inlier_dist), min_inliers,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_out,
    )
    return out[:n].reshape(n, 2, 2).copy()


def cluster_centroids(
    costmap, threshold: int = 254, min_cluster: int = 2, max_out: int = 64,
) -> np.ndarray:
    """Blob detection: per-cluster (cx, cy, radius) — the front end of the
    dynamic-obstacle converter (parity: CostmapToDynamicObstacles)."""
    lib = load()
    data, H, W, ox, oy, res = _grid(costmap)
    out = np.empty((max_out, 3), dtype=np.float64)
    n = lib.mpc_costmap_cluster_centroids(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W, ox, oy, res,
        threshold, min_cluster,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_out,
    )
    return out[:n].copy()


def tracker_update(
    prev_tracks: np.ndarray, centroids: np.ndarray, dt: float,
    gate_dist: float = 0.6, vel_alpha: float = 0.5, next_id: int = 0,
    max_out: int = 64, max_missed: int = 2,
):
    """Frame-to-frame centroid tracking with velocity estimation and
    coasting through up to ``max_missed`` missed detections (parity:
    CostmapToDynamicObstacles blob tracker). Tracks are rows of
    (id, x, y, vx, vy, age, missed, radius); centroids (M, 2) xy or (M, 3)
    xy + radius. Returns (tracks (T, 8), next_id)."""
    lib = load()
    prev = np.ascontiguousarray(np.asarray(prev_tracks, dtype=np.float64).reshape(-1, 8))
    cur = np.asarray(centroids, dtype=np.float64)
    cur = cur.reshape(-1, cur.shape[-1] if cur.size else 2)
    if cur.shape[-1] == 2:
        cur = np.concatenate([cur, np.zeros((cur.shape[0], 1))], axis=1)
    cur = np.ascontiguousarray(cur)
    out = np.empty((max_out, 8), dtype=np.float64)
    nid = ctypes.c_int(int(next_id))
    n = lib.mpc_tracker_update(
        prev.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), prev.shape[0],
        cur.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cur.shape[0],
        float(dt), float(gate_dist), float(vel_alpha), ctypes.byref(nid),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_out,
        int(max_missed),
    )
    return out[:n].copy(), int(nid.value)


def extract_polygons(
    costmap, threshold: int = 254, min_cluster: int = 2,
    max_polys: int = 64, max_total_verts: int = 2048,
) -> Tuple[np.ndarray, ...]:
    """Cluster lethal cells into convex-hull polygon obstacles.

    Returns a tuple of (nv_i, 2) vertex arrays (parity:
    CostmapToPolygonsDBSMCCH output).
    """
    lib = load()
    data, H, W, ox, oy, res = _grid(costmap)
    verts = np.empty((max_total_verts, 2), dtype=np.float64)
    counts = np.empty((max_polys,), dtype=np.int32)
    n = lib.mpc_costmap_extract_polygons(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W, ox, oy, res,
        threshold, min_cluster,
        verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        max_polys, max_total_verts,
    )
    polys = []
    off = 0
    for i in range(n):
        polys.append(verts[off : off + counts[i]].copy())
        off += counts[i]
    return tuple(polys)


def footprint_cost(costmap, pose, footprint_radius: float = 0.0) -> float:
    lib = load()
    data, H, W, ox, oy, res = _grid(costmap)
    return lib.mpc_costmap_footprint_cost(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W, ox, oy, res,
        float(pose[0]), float(pose[1]), float(footprint_radius),
    )


def trajectory_feasible(
    costmap, xs: np.ndarray, footprint_radius: float = 0.0,
    check_poses: int = -1, min_resolution_angular: float = np.pi,
) -> bool:
    lib = load()
    data, H, W, ox, oy, res = _grid(costmap)
    xs = np.ascontiguousarray(np.asarray(xs, dtype=np.float64))
    return bool(
        lib.mpc_costmap_trajectory_feasible(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W, ox, oy,
            res, xs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            xs.shape[0], float(footprint_radius), int(check_poses),
            float(min_resolution_angular),
        )
    )
