"""Time / motion-gated sensor sampling (vectorized).

Equivalents of reference tools/sampling.py: uniform time decimation of sensor
timestamps and motion-gated odometry subsampling.  Both are inherently
sequential gates (each accepted sample resets the gate), so they run host-side
in numpy — they are O(N) over a few thousand rows, never a bottleneck.
"""

from __future__ import annotations

import numpy as np


def sample_times(sensor_times: np.ndarray, start_index: int = 10,
                 delta_time: float = 1e9) -> np.ndarray:
    """Decimate timestamps to a minimum spacing of delta_time (ns).

    Exact semantics of reference tools/sampling.py:39-58: start at
    ``start_index``, keep a time when >= delta_time elapsed since the last
    kept one, always append the final time, and unique-sort the result.
    """
    sensor_times = np.asarray(sensor_times)
    kept = [sensor_times[start_index]]
    t = sensor_times[start_index]
    for i in range(start_index, len(sensor_times)):
        current = sensor_times[i]
        if float(np.abs(current - t)) >= delta_time:
            kept.append(current)
            t = current
    kept.append(sensor_times[-1])
    return np.unique(np.array(kept))


def sample_odometry(df_odo, deltaxy: float = 0.5, deltath: float = 0.2):
    """Keep odometry rows spaced by >deltaxy meters or >deltath rad of yaw.

    Matches reference tools/sampling.py:8-36 (including always keeping row 0
    and gating on planar distance + yaw).  Returns (times, sampled table).
    """
    from lidar_slam_arvc_tpu.geom.hostmath import quat_to_yaw_np
    from lidar_slam_arvc_tpu.io.formats import columns, take_rows

    xy = columns(df_odo, ["x", "y"])
    yaw = quat_to_yaw_np(columns(df_odo, ["qw", "qx", "qy", "qz"]))
    times = np.asarray(df_odo["#timestamp [ns]"])

    keep = [0]
    ref_xy, ref_yaw = xy[0], yaw[0]
    for i in range(len(times)):
        dxy = np.linalg.norm(xy[i] - ref_xy)
        dth = abs(yaw[i] - ref_yaw)
        if dxy > deltaxy or dth > deltath:
            keep.append(i)
            ref_xy, ref_yaw = xy[i], yaw[i]
    keep = np.array(keep, dtype=np.int64)
    return times[keep], take_rows(df_odo, keep)
