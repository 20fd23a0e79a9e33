"""Dataset/solution diagnostics (reference viewers/ parity, headless).

  * :func:`check_timestamps`   — per-sensor rate/Δt report
    (reference viewers/check_timestamps.py:85-123)
  * :func:`view_solutions`     — solution vs GPS overlay + end-point error
    (reference viewers/view_solutions.py:15-34)
  * :func:`compare_solutions`  — per-step delta error MEAN/STD between a
    solution and GPS/ground truth
    (reference viewers/view_solutions_sm.py:160-175)
  * :func:`view_raw_data`      — raw odometry/GPS trajectory plots
    (reference viewers/data_viewer.py)

All return dict reports and save PNGs under <dataset>/robot0/viz/.
"""

from __future__ import annotations

import os

import numpy as np

from lidar_slam_arvc_tpu.io.formats import columns, n_rows

from lidar_slam_arvc_tpu.io import EurocDataset, filter_gps, gps2utm
from lidar_slam_arvc_tpu.viz.plots import _agg


def check_timestamps(directory: str) -> dict:
    """Per-sensor timestamp statistics + plot of inter-sample intervals."""
    euroc = EurocDataset(directory)
    sensors = {
        "lidar": "/robot0/lidar/data.csv",
        "odom": "/robot0/odom/data.csv",
        "gps0": "/robot0/gps0/data.csv",
        # IMU audited when present, skipped gracefully otherwise
        # (reference viewers/check_timestamps.py:59-72)
        "imu0": "/robot0/imu0/data.csv",
    }
    report = {}
    plt = _agg()
    fig, ax = plt.subplots(figsize=(9, 5))
    for name, path in sensors.items():
        try:
            df = euroc.read_csv(path)
        except FileNotFoundError:
            continue
        t = df["#timestamp [ns]"] / 1e9
        dt = np.diff(t)
        report[name] = {
            "count": int(len(t)),
            "duration_s": float(t[-1] - t[0]) if len(t) > 1 else 0.0,
            "mean_dt_s": float(dt.mean()) if len(dt) else None,
            "std_dt_s": float(dt.std()) if len(dt) else None,
            "max_dt_s": float(dt.max()) if len(dt) else None,
            "rate_hz": float(1.0 / dt.mean()) if len(dt) and dt.mean() > 0 else None,
        }
        if len(dt):
            ax.plot(t[1:] - t[0], dt, ".", markersize=2, label=name)
    ax.set_xlabel("experiment time (s)")
    ax.set_ylabel("inter-sample dt (s)")
    ax.legend()
    out_dir = f"{directory}/robot0/viz"
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(f"{out_dir}/timestamps.png", dpi=120, bbox_inches="tight")
    plt.close(fig)

    # odometry distance travelled (check_timestamps.py:10-16,55)
    try:
        df_odo = euroc.read_csv("/robot0/odom/data.csv")
        xy = columns(df_odo, ["x", "y"])
        report["odometry_distance_m"] = float(
            np.linalg.norm(np.diff(xy, axis=0), axis=1).sum())
    except FileNotFoundError:
        pass
    return report


def _load_gps_utm(euroc: EurocDataset):
    df_gps = euroc.read_csv("/robot0/gps0/data.csv")
    ref = euroc.read_utm_ref("gps0")
    df_gps = filter_gps(df_gps)
    return gps2utm(df_gps, ref)


def view_solutions(directory: str,
                   solution_csv: str = "/robot0/SLAM/solution_graphslam.csv") -> dict:
    """Solution-vs-GPS overlay + distance travelled + end-point error."""
    euroc = EurocDataset(directory)
    times, T = euroc.read_trajectory(solution_csv)
    p = T[:, :3, 3]
    dist = float(np.linalg.norm(np.diff(p[:, :2], axis=0), axis=1).sum())
    report = {"poses": len(T), "distance_travelled_m": dist,
              "end_point_error_m": None}
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(p[:, 0], p[:, 1], ".-", markersize=3, label="solution")
    try:
        df_gps = _load_gps_utm(euroc)
        ax.plot(df_gps["x"], df_gps["y"], "o", markersize=3, color="red",
                label="GPS UTM")
        # end-point error (view_solutions.py:29-34)
        report["end_point_error_m"] = float(np.linalg.norm(
            p[-1, :2] - np.array([df_gps["x"][-1], df_gps["y"][-1]])))
    except FileNotFoundError:
        pass
    ax.axis("equal")
    ax.legend()
    out_dir = f"{directory}/robot0/viz"
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(f"{out_dir}/solution_vs_gps.png", dpi=120,
                bbox_inches="tight")
    plt.close(fig)
    return report


def compare_solutions(directory: str,
                      solution_csv: str = "/robot0/SLAM/solution_graphslam.csv",
                      reference_csv: str | None = None) -> dict:
    """Per-step delta error statistics vs GPS (or a reference trajectory).

    Reproduces the MEAN/STD per-step delta report of reference
    viewers/view_solutions_sm.py:160-175: compare the norm of each
    consecutive-step displacement in the solution with the corresponding
    displacement in GPS/reference.
    """
    euroc = EurocDataset(directory)
    times, T = euroc.read_trajectory(solution_csv)
    p = T[:, :2, 3]

    if reference_csv is not None:
        _, T_ref = euroc.read_trajectory(reference_csv)
        q = T_ref[:, :2, 3]
        n = min(len(p), len(q))
        p, q = p[:n], q[:n]
    else:
        df_gps = _load_gps_utm(euroc)
        idx = EurocDataset.get_closest_times(times,
                                             df_gps["#timestamp [ns]"])
        q = columns(EurocDataset.get_df_at_times(df_gps, idx), ["x", "y"])

    dp = np.linalg.norm(np.diff(p, axis=0), axis=1)
    dq = np.linalg.norm(np.diff(q, axis=0), axis=1)
    delta = np.abs(dp - dq)
    return {"delta_error_mean_m": float(delta.mean()),
            "delta_error_std_m": float(delta.std()),
            "steps": int(len(delta))}


def view_raw_data(directory: str) -> dict:
    """Raw odometry + GPS plots (reference viewers/data_viewer.py)."""
    euroc = EurocDataset(directory)
    plt = _agg()
    fig, ax = plt.subplots(figsize=(8, 8))
    report = {}
    try:
        df_odo = euroc.read_csv("/robot0/odom/data.csv")
        ax.plot(df_odo["x"], df_odo["y"], ".-", markersize=2,
                label="odometry")
        report["odom_rows"] = n_rows(df_odo)
    except FileNotFoundError:
        pass
    try:
        df_gps = _load_gps_utm(euroc)
        ax.plot(df_gps["x"], df_gps["y"], "o", markersize=3, color="red",
                label="GPS UTM")
        report["gps_rows"] = n_rows(df_gps)
    except FileNotFoundError:
        pass
    ax.axis("equal")
    ax.legend()
    out_dir = f"{directory}/robot0/viz"
    os.makedirs(out_dir, exist_ok=True)
    fig.savefig(f"{out_dir}/raw_data.png", dpi=120, bbox_inches="tight")
    plt.close(fig)
    return report
