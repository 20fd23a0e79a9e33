"""Quickstart: generate a synthetic EUROC dataset and run the full pipeline.

    python examples/quickstart.py [output_dir]

Writes the dataset, runs scan matching + graph SLAM, prints ATE against the
generator's ground truth, and exports trajectory/map artifacts.
"""

import sys
import tempfile

import numpy as np

from lidar_slam_arvc_tpu.io import EurocDataset
from lidar_slam_arvc_tpu.pipeline.graphslam import run_graphslam
from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher
from lidar_slam_arvc_tpu.utils import synthetic
from lidar_slam_arvc_tpu.utils.config import IcpConfig
from lidar_slam_arvc_tpu.utils.metrics import ate, rpe
from lidar_slam_arvc_tpu.viz.viewer import view_dataset


def main():
    directory = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(
        prefix="slam_quickstart_")
    print(f"dataset directory: {directory}")

    import jax
    on_gpu = jax.default_backend() == "gpu"
    n_scans, pts, cap_raw, cap = ((40, 8000, 16384, 8192) if on_gpu
                                  else (24, 4000, 8192, 4096))
    info = synthetic.make_dataset(
        directory, n_scans=n_scans, seed=0, radius=10.0, scan_points=pts,
        scanmatcher_params={"voxel_size": 0.2, "method": "icppointplane",
                            "delta_time": 1.0, "start_index": 0},
        slam_params={"skip_loop_closing": 10, "skip_optimization": 10,
                     "radius_threshold": 3.0, "distance_backwards": 8.0,
                     "number_of_triplets_loop_closing": 10})

    cfg = IcpConfig(raw_capacity=cap_raw, capacity=cap, batch_size=8)
    sm = run_scanmatcher(directory, cfg=cfg)
    print(f"scanmatcher: {sm['frames_per_second']:.1f} frames/s, "
          f"ATE {ate(sm['global'], info['T_gt'])['rmse'] * 100:.1f} cm")

    slam = run_graphslam(directory, cfg=cfg)
    euroc = EurocDataset(directory)
    _, T_sol = euroc.read_trajectory("/robot0/SLAM/solution_graphslam.csv")
    print(f"graphSLAM: {slam['n_loop_closures']} loop closures, "
          f"ATE {ate(T_sol, info['T_gt'])['rmse'] * 100:.1f} cm, "
          f"RPE {rpe(T_sol, info['T_gt'])['trans_rmse'] * 100:.1f} cm/step")

    out = view_dataset(directory, keyframe_sampling=4)
    print(f"artifacts in {out['out_dir']}")


if __name__ == "__main__":
    main()
