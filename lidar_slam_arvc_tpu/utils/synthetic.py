"""Synthetic EUROC-format dataset generation.

The reference repo ships no data and no runnable test fixture (its simulator,
tools/simulate.py, is import-broken — SURVEY.md §4).  This module generates a
structured 3D world, renders LiDAR-like scans along a closed trajectory, and
writes a complete EUROC-format dataset directory (PCDs + odometry + GPS +
parameter YAMLs + ground truth) so the full pipeline runs hermetically in
tests and benchmarks.
"""

from __future__ import annotations

import os

import numpy as np

from lidar_slam_arvc_tpu.geom.hostmath import pose_columns_from_transforms_np
from lidar_slam_arvc_tpu.io.formats import dump_yaml, write_csv
from lidar_slam_arvc_tpu.io.pcd import write_pcd


def make_world(rng: np.random.Generator, extent: float = 30.0,
               n_ground: int = 12000, n_pillars: int = 30,
               pillar_pts: int = 400, n_boxes: int = 0,
               box_pts: int = 600) -> np.ndarray:
    """Ground plane + vertical pillars + perimeter walls (N, 3) float32.

    ``n_boxes`` adds axis-misaligned boxes of varied size — corner/edge
    geometry that feature descriptors (FPFH) can discriminate, unlike the
    rotationally-symmetric pillars.
    """
    ground = np.empty((n_ground, 3), dtype=np.float64)
    ground[:, 0] = rng.uniform(-extent, extent, n_ground)
    ground[:, 1] = rng.uniform(-extent, extent, n_ground)
    ground[:, 2] = rng.normal(scale=0.01, size=n_ground)

    pillars = []
    centers = rng.uniform(-extent * 0.9, extent * 0.9, size=(n_pillars, 2))
    for cx, cy in centers:
        theta = rng.uniform(0, 2 * np.pi, pillar_pts)
        radius = 0.3 + 0.2 * rng.random()
        z = rng.uniform(0.0, 3.0, pillar_pts)
        pillars.append(np.stack([
            cx + radius * np.cos(theta),
            cy + radius * np.sin(theta),
            z,
        ], axis=1))

    boxes = []
    for _ in range(n_boxes):
        cx, cy = rng.uniform(-extent * 0.8, extent * 0.8, size=2)
        sx, sy = rng.uniform(0.8, 3.0, size=2)
        h = rng.uniform(1.0, 3.5)
        yaw = rng.uniform(0, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        # sample the 4 side faces + top
        face = rng.integers(0, 5, box_pts)
        u = rng.uniform(-0.5, 0.5, box_pts)
        v = rng.uniform(0, 1, box_pts)
        lx = np.where(face == 0, 0.5, np.where(face == 1, -0.5, u)) * sx
        ly = np.where(face == 2, 0.5, np.where(face == 3, -0.5, u)) * sy
        lx = np.where((face == 2) | (face == 3) | (face == 4), u * sx, lx)
        ly = np.where((face == 0) | (face == 1), u * sy,
                      np.where(face == 4, rng.uniform(-0.5, 0.5, box_pts) * sy, ly))
        lz = np.where(face == 4, h, v * h)
        boxes.append(np.stack([cx + c * lx - s * ly,
                               cy + s * lx + c * ly, lz], axis=1))

    walls = []
    n_wall = 4000
    side = rng.integers(0, 4, n_wall)
    along = rng.uniform(-extent, extent, n_wall)
    height = rng.uniform(0.0, 2.5, n_wall)
    wx = np.where(side == 0, extent, np.where(side == 1, -extent, along))
    wy = np.where(side == 2, extent, np.where(side == 3, -extent, along))
    walls.append(np.stack([wx, wy, height], axis=1))

    world = np.concatenate([ground] + pillars + boxes + walls).astype(np.float32)
    return world


def make_trajectory(n_poses: int, radius: float = 12.0,
                    z_wobble: float = 0.0) -> np.ndarray:
    """Closed circular trajectory (returns near start -> loop closures).

    Heading is tangent to the circle; one full revolution over n_poses.
    Returns (n_poses, 4, 4) float64.
    """
    T = np.tile(np.eye(4), (n_poses, 1, 1))
    ang = np.linspace(0.0, 2 * np.pi, n_poses, endpoint=False)
    T[:, 0, 3] = radius * np.cos(ang)
    T[:, 1, 3] = radius * np.sin(ang)
    T[:, 2, 3] = z_wobble * np.sin(3 * ang)
    yaw = ang + np.pi / 2  # tangent heading
    c, s = np.cos(yaw), np.sin(yaw)
    T[:, 0, 0] = c
    T[:, 0, 1] = -s
    T[:, 1, 0] = s
    T[:, 1, 1] = c
    return T


def render_scan(world: np.ndarray, T_sensor: np.ndarray,
                rng: np.random.Generator, max_range: float = 25.0,
                max_points: int = 6000, noise: float = 0.01,
                sensor_height: float = 0.8) -> np.ndarray:
    """Points of the world visible from a sensor pose, in the sensor frame.

    A range-cropped subsample with additive Gaussian noise (no occlusion
    model — sufficient for registration/SLAM correctness testing).  The
    sensor sits ``sensor_height`` above the trajectory z, so the ground
    plane appears at negative z in the scan like a real robot-mounted LiDAR.
    """
    Ts = T_sensor.copy()
    Ts[2, 3] += sensor_height
    R = Ts[:3, :3]
    t = Ts[:3, 3]
    local = (world - t) @ R  # R^T (p - t)
    r = np.linalg.norm(local[:, :2], axis=1)
    keep = (r < max_range) & (r > 0.7)
    local = local[keep]
    if len(local) > max_points:
        idx = rng.choice(len(local), size=max_points, replace=False)
        local = local[idx]
    local = local + rng.normal(scale=noise, size=local.shape)
    return local.astype(np.float32)


def _yaw_T(x, y, yaw, z=0.0):
    T = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[0, 3], T[1, 3], T[2, 3] = x, y, z
    return T


def perturb_trajectory(T_gt: np.ndarray, rng: np.random.Generator,
                       xy_sigma: float = 0.01, yaw_sigma: float = 0.002,
                       xy_bias: float = 0.005, yaw_bias: float = 0.001):
    """Odometry-like drift: relative transforms with bias + noise, re-folded."""
    n = len(T_gt)
    T_odo = [T_gt[0].copy()]
    for i in range(n - 1):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
        dyaw = yaw_bias + rng.normal(scale=yaw_sigma)
        dxy = np.array([xy_bias + rng.normal(scale=xy_sigma),
                        rng.normal(scale=xy_sigma)])
        noise_T = _yaw_T(dxy[0], dxy[1], dyaw)
        T_odo.append(T_odo[-1] @ rel @ noise_T)
    return np.stack(T_odo)


def make_dataset(directory: str, n_scans: int = 40, seed: int = 0,
                 radius: float = 12.0, with_gps: bool = True,
                 scan_points: int = 6000, max_range: float = 25.0,
                 world_kwargs: dict | None = None,
                 scanmatcher_params: dict | None = None,
                 slam_params: dict | None = None) -> dict:
    """Write a complete synthetic EUROC-format dataset.

    Layout matches the reference contract (SURVEY.md §2.1 / io.euroc).
    Returns a dict with the ground-truth trajectory and timestamps.
    """
    rng = np.random.default_rng(seed)
    world = make_world(rng, **(world_kwargs or {}))
    T_gt = make_trajectory(n_scans, radius=radius)
    times = (1e9 * (1.0 + np.arange(n_scans))).astype(np.int64)

    os.makedirs(f"{directory}/robot0/lidar/data", exist_ok=True)

    # LiDAR scans + index CSV
    for i in range(n_scans):
        scan = render_scan(world, T_gt[i], rng, max_points=scan_points,
                           max_range=max_range)
        write_pcd(f"{directory}/robot0/lidar/data/{times[i]}.pcd", scan)
    write_csv(f"{directory}/robot0/lidar/data.csv",
              {"#timestamp [ns]": times}, index=False)

    # odometry (noisy), at 4x the scan rate for realistic association
    odo_times = (1e9 * (1.0 + 0.25 * np.arange(4 * n_scans))).astype(np.int64)
    T_gt_dense = _interp_traj(T_gt, times, odo_times)
    T_odo = perturb_trajectory(T_gt_dense, rng)
    _write_traj_csv(f"{directory}/robot0/odom/data.csv", odo_times, T_odo)

    # ground truth (not part of the reference contract; used for ATE)
    _write_traj_csv(f"{directory}/robot0/gt/data.csv", times, T_gt)

    if with_gps:
        lat_ref, lon_ref, alt_ref = 38.275, -0.685, 100.0
        lat_per_m = 1.0 / 111_132.0
        lon_per_m = 1.0 / (111_320.0 * np.cos(np.deg2rad(lat_ref)))
        xy = T_gt[:, :2, 3] + rng.normal(scale=0.05, size=(n_scans, 2))
        os.makedirs(f"{directory}/robot0/gps0", exist_ok=True)
        write_csv(f"{directory}/robot0/gps0/data.csv", {
            "#timestamp [ns]": times,
            "latitude": lat_ref + xy[:, 1] * lat_per_m,
            "longitude": lon_ref + xy[:, 0] * lon_per_m,
            "altitude": alt_ref + T_gt[:, 2, 3],
        }, index=False)
        dump_yaml({"latitude": lat_ref, "longitude": lon_ref,
                   "altitude": alt_ref},
                  f"{directory}/robot0/gps0/reference.yaml")
        dump_yaml({"transform": np.eye(4).reshape(-1).tolist()},
                  f"{directory}/robot0/gps0/transform.yaml")

    sm = {"start_index": 0, "delta_time": 1.0, "voxel_size": 0.2,
          "method": "icppointplane"}
    sm.update(scanmatcher_params or {})
    dump_yaml(sm, f"{directory}/robot0/scanmatcher_parameters.yaml")

    sl = {"perform_loop_closing": True, "method": "icppointplane",
          "skip_loop_closing": 10, "skip_optimization": 10,
          "number_of_triplets_loop_closing": 10, "radius_threshold": 3.0,
          "distance_backwards": 8.0, "visualization_keyframe_sampling": 10}
    sl.update(slam_params or {})
    dump_yaml(sl, f"{directory}/robot0/slam_parameters.yaml")

    return {"T_gt": T_gt, "times": times, "world": world}


def make_outdoor_loop_dataset(directory: str, n_scans: int = 200,
                              scan_points: int = 20000,
                              with_gps: bool = True) -> dict:
    """The reference's outdoor loop-closing regime as a synthetic dataset.

    A closed 16 m-radius circuit whose tail re-enters the head's
    neighbourhood, scans of ``scan_points`` points within 25 m, stage 1 and
    stage 2 at full resolution (voxel None, reference run_graphSLAM.py:224)
    and loop closing within 7 m (run_graphSLAM.py:153,168).
    """
    return make_dataset(
        directory, n_scans=n_scans, seed=11, radius=16.0,
        scan_points=scan_points, max_range=25.0, with_gps=with_gps,
        world_kwargs={"n_ground": 60000, "n_pillars": 120,
                      "pillar_pts": 500},
        scanmatcher_params={"voxel_size": None, "delta_time": 1.0,
                            "method": "icppointplane", "start_index": 0},
        slam_params={"perform_loop_closing": True,
                     "radius_threshold": 7.0, "distance_backwards": 7.0,
                     "skip_loop_closing": 8,
                     "number_of_triplets_loop_closing": 6,
                     "skip_optimization": 8})


def _interp_traj(T: np.ndarray, t_src: np.ndarray, t_dst: np.ndarray):
    """Piecewise interpolation of poses (linear pos, slerp-free nearest yaw)."""
    out = np.tile(np.eye(4), (len(t_dst), 1, 1))
    pos = T[:, :3, 3]
    for k in range(3):
        out[:, k, 3] = np.interp(t_dst, t_src, pos[:, k])
    # nearest rotation (adequate for odometry simulation granularity)
    idx = np.clip(np.searchsorted(t_src, t_dst), 0, len(t_src) - 1)
    out[:, :3, :3] = T[idx, :3, :3]
    return out


def _write_traj_csv(path: str, times: np.ndarray, T: np.ndarray):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    xyz, q = pose_columns_from_transforms_np(T)
    write_csv(path, {
        "#timestamp [ns]": times,
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "qx": q[:, 1], "qy": q[:, 2], "qz": q[:, 3], "qw": q[:, 0],
    }, index=False)
