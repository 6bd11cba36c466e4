"""Trajectory conversions (port of ``mpc_local_planner_tpu.utils.conversion``).

mpc_local_planner ``utils/conversion.h/.cpp``: corbo TimeSeries ⇄ ROS
pose/trajectory messages. Without ROS, the interchange formats are plain
numpy arrays: a "plan" is (P, 3) rows of (x, y, theta); a timed trajectory
is (times (T,), poses (T, 3)).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from mpc_local_planner_tpu_torch.core.tree import leaf_numpy


def time_series_to_poses(series) -> Tuple[np.ndarray, np.ndarray]:
    """TimeSeries(SE2) → (times (T,), poses (T, 3)).

    Parity: convert(TimeSeries → PoseStamped[]).
    """
    return leaf_numpy(series.times), leaf_numpy(series.values)[..., :3]


def poses_to_plan_array(poses: List) -> np.ndarray:
    """List of (x, y[, theta]) → (P, 3) plan array with heading fill-in.

    Missing headings are taken from successive segment directions (parity:
    the planner's plan preprocessing when pose orientations are absent).
    """
    arr = np.asarray([np.asarray(p, dtype=np.float64) for p in poses])
    if arr.shape[1] == 3:
        return arr
    out = np.zeros((arr.shape[0], 3))
    out[:, :2] = arr[:, :2]
    d = np.diff(arr[:, :2], axis=0)
    th = np.arctan2(d[:, 1], d[:, 0])
    out[:-1, 2] = th
    out[-1, 2] = th[-1] if th.size else 0.0
    return out


def ackermann_from_twist(twist, wheelbase: float, min_speed: float = 1e-6):
    """(vx, vy, omega) twist → (speed, steering_angle) Ackermann command.

    Parity: the examples' `cmd_vel_to_ackermann_drive` conversion script
    (mpc_local_planner_examples/scripts — geometry_msgs/Twist →
    ackermann_msgs/AckermannDrive): steering = atan(wheelbase · ω / v),
    with the steering held at zero below ``min_speed`` (the script's
    guard against the ω/v singularity at standstill).
    """
    t = np.asarray(twist, dtype=np.float64)
    v = t[..., 0]
    om = t[..., 2]
    # atan(L·ω/v) with the sign of v carried by the ratio (reverse driving
    # flips the steering direction for the same ω)
    safe_v = np.where(np.abs(v) > min_speed, v, 1.0)
    steer = np.where(
        np.abs(v) > min_speed, np.arctan(wheelbase * om / safe_v), 0.0
    )
    return np.stack([v, steer], axis=-1)
