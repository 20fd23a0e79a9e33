"""EUROC/ASL-format dataset access (reference eurocreader/eurocreader.py).

Directory contract (identical to the reference, so datasets and artifacts
interoperate):

    <dir>/robot0/lidar/data.csv              '#timestamp [ns]' per scan
    <dir>/robot0/lidar/data/<t>.pcd          one PCD per scan timestamp
    <dir>/robot0/odom/data.csv               '#timestamp [ns]',x..qw odometry
    <dir>/robot0/gps0/data.csv               GPS fixes (latitude/longitude/altitude)
    <dir>/robot0/gps0/reference.yaml         UTM origin (latitude/longitude/altitude)
    <dir>/robot0/<sensor>/transform.yaml     4x4 sensor extrinsics
    <dir>/robot0/scanmatcher_parameters.yaml stage-1 parameters
    <dir>/robot0/slam_parameters.yaml        stage-2 parameters
    outputs: robot0/scanmatcher/{lidar_times,scanmatcher_relative,scanmatcher_global}.csv
             robot0/SLAM/{solution_graphslam,loop_closures}.csv

Differences from the reference implementation (behavior-preserving):
  * nearest-time association is vectorized (searchsorted) instead of the
    O(N*M) python loop in eurocreader.py:128-144;
  * trajectory CSV serialization is batched through geom instead of
    per-row HomogeneousMatrix objects (eurocreader.py:46-64);
  * CSV tables are column -> numpy array dicts (io.formats) instead of
    pandas DataFrames, written byte-identically to pandas' output.
"""

from __future__ import annotations

import os

import numpy as np

from lidar_slam_arvc_tpu.geom.hostmath import (
    pose_columns_from_transforms_np,
    transforms_from_pose_columns_np,
)
from lidar_slam_arvc_tpu.io.formats import (
    columns, load_yaml, read_csv, take_rows, write_csv)

TRAJECTORY_COLUMNS = ["#timestamp [ns]", "x", "y", "z", "qx", "qy", "qz", "qw"]


class EurocDataset:
    """Reader/writer for one EUROC-format dataset directory."""

    def __init__(self, directory: str):
        self.directory = directory

    # ---------------------------------------------------------------- reads

    def path(self, relative: str) -> str:
        return self.directory + relative

    def read_csv(self, filename: str) -> dict[str, np.ndarray]:
        return read_csv(self.directory + filename)

    def read_transform(self, sensor: str) -> np.ndarray:
        """4x4 extrinsics from robot0/<sensor>/transform.yaml
        (reference eurocreader.py:15-24)."""
        config = load_yaml(f"{self.directory}/robot0/{sensor}/transform.yaml")
        return np.asarray(config["transform"], dtype=np.float64).reshape(4, 4)

    def read_utm_ref(self, gpsname: str = "gps0") -> dict:
        """GPS origin from robot0/<gps>/reference.yaml (eurocreader.py:26-36)."""
        return load_yaml(f"{self.directory}/robot0/{gpsname}/reference.yaml")

    def read_scanmatcher_parameters(self) -> dict:
        return load_yaml(f"{self.directory}/robot0/scanmatcher_parameters.yaml")

    def read_slam_parameters(self) -> dict:
        return load_yaml(f"{self.directory}/robot0/slam_parameters.yaml")

    def scan_pcd_path(self, scan_time) -> str:
        return f"{self.directory}/robot0/lidar/data/{scan_time}.pcd"

    # ----------------------------------------------------- time association

    @staticmethod
    def get_closest_times(master_sensor_times: np.ndarray,
                          sensor_times: np.ndarray,
                          warning_max_time_dif_s: float = 0.5e9) -> np.ndarray:
        """For each master time, the nearest sensor time (vectorized).

        Same output as the argmin loop of reference eurocreader.py:128-144
        but O((N+M) log M) via searchsorted over the sorted sensor times.
        """
        master = np.asarray(master_sensor_times, dtype=np.int64)
        times = np.asarray(sensor_times, dtype=np.int64)
        order = np.argsort(times, kind="stable")
        sorted_times = times[order]
        pos = np.searchsorted(sorted_times, master)
        left = np.clip(pos - 1, 0, len(sorted_times) - 1)
        right = np.clip(pos, 0, len(sorted_times) - 1)
        choose_right = (np.abs(sorted_times[right] - master)
                        < np.abs(sorted_times[left] - master))
        idx = np.where(choose_right, right, left)
        out = sorted_times[idx]
        dif = np.abs(out - master)
        n_bad = int((dif > warning_max_time_dif_s).sum())
        if n_bad:
            print(f"CAUTION!!! {n_bad} associations exceed "
                  f"{warning_max_time_dif_s / 1e9:.2f}s time difference "
                  f"(max {dif.max() / 1e9:.2f}s)")
        return out

    @staticmethod
    def get_df_at_times(df_data, time_list: np.ndarray) -> dict:
        """Rows of the table at exactly the given timestamps, in list order
        (reference eurocreader.py:146-157); KeyError for a missing time."""
        stamps = np.asarray(df_data["#timestamp [ns]"])
        want = np.asarray(time_list)
        order = np.argsort(stamps, kind="stable")
        pos = np.clip(np.searchsorted(stamps, want, sorter=order), 0,
                      len(stamps) - 1)
        rows = order[pos]
        if not np.array_equal(stamps[rows], want):
            raise KeyError("timestamps not in the table: "
                           f"{want[stamps[rows] != want][:5].tolist()}")
        return take_rows(df_data, rows)

    # ---------------------------------------------------------------- writes

    def _ensure_dir(self, filename: str) -> str:
        full = self.directory + filename
        os.makedirs(os.path.dirname(os.path.abspath(full)), exist_ok=True)
        return full

    def save_transforms_as_csv(self, sensor_times, transforms,
                               filename: str) -> dict:
        """Write a trajectory CSV with the reference schema
        (eurocreader.py:46-64): index column + timestamp,x,y,z,qx,qy,qz,qw."""
        T = np.asarray(transforms)
        xyz, q = pose_columns_from_transforms_np(T)
        table = {
            "#timestamp [ns]": np.asarray(sensor_times)[: len(T)],
            "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
            "qx": q[:, 1], "qy": q[:, 2], "qz": q[:, 3], "qw": q[:, 0],
        }
        write_csv(self._ensure_dir(filename), table)
        return table

    def save_sensor_times_as_csv(self, sensor_times, filename: str) -> dict:
        table = {"#timestamp [ns]": np.asarray(sensor_times)}
        write_csv(self._ensure_dir(filename), table)
        return table

    def save_loop_closures_as_csv(self, loop_closures, filename: str) -> dict:
        """Flatten [[i,j],...] groups into an i,j CSV (eurocreader.py:81-97)."""
        pairs = [(int(p[0]), int(p[1])) for group in loop_closures
                 if group is not None for p in group]
        ij = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        table = {"i": ij[:, 0], "j": ij[:, 1]}
        write_csv(self._ensure_dir(filename), table)
        return table

    # ------------------------------------------------------- trajectory I/O

    def read_trajectory(self, filename: str):
        """Read a trajectory CSV -> (times (N,), transforms (N,4,4) np)."""
        df = self.read_csv(filename)
        return trajectory_from_df(df)


def trajectory_from_df(df):
    """(times, (N,4,4) transforms) from a trajectory table.

    Column convention of reference homogeneousmatrix.py:147-167: position
    x,y,z plus quaternion columns qw,qx,qy,qz (wxyz order in the math)."""
    times = np.asarray(df["#timestamp [ns]"])
    T = transforms_from_pose_columns_np(columns(df, ["x", "y", "z"]),
                                        columns(df, ["qw", "qx", "qy", "qz"]))
    return times, T
