"""End-to-end pipeline run (scanmatch -> graphSLAM) on the local device.

Generates a hermetic synthetic EUROC dataset with ground truth, runs both
pipeline stages exactly as the CLI does, and reports wall time per stage
plus SLAM ATE against ground truth.  The first repetition pays the
one-time compiles; the steady-state numbers are the second.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from lidar_slam_arvc_tpu.io.formats import read_csv, take_rows
from lidar_slam_arvc_tpu.utils import synthetic

N_SCANS = int(os.environ.get("E2E_SCANS", "25"))

d = os.environ.get("E2E_DIR") or tempfile.mkdtemp(prefix="e2e_")
if not os.path.exists(os.path.join(d, "robot0", "lidar", "data.csv")):
    synthetic.make_dataset(d, n_scans=N_SCANS)
print(f"dataset: {d} ({N_SCANS} scans)", flush=True)

from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher
from lidar_slam_arvc_tpu.pipeline.graphslam import run_graphslam

for rep in range(2):   # rep 0 pays compiles; rep 1 is steady state
    t0 = time.time()
    run_scanmatcher(d, progress=False)
    t1 = time.time()
    res2 = run_graphslam(d, progress=False)
    t2 = time.time()
    print(f"rep {rep}: scanmatch {t1 - t0:.2f}s, "
          f"graphslam {t2 - t1:.2f}s "
          f"({res2['n_loop_closures']} loop closures)", flush=True)

slam = read_csv(d + "/robot0/SLAM/solution_graphslam.csv")
gt = read_csv(d + "/robot0/gt/data.csv")
from lidar_slam_arvc_tpu.io.euroc import trajectory_from_df
from lidar_slam_arvc_tpu.utils.metrics import ate, rpe

_, T_est = trajectory_from_df(slam)
scan_t = read_csv(
    d + "/robot0/scanmatcher/lidar_times.csv")["#timestamp [ns]"]
gt_t = gt["#timestamp [ns]"]
idx = np.argmin(np.abs(gt_t[None, :] - scan_t[:, None]), axis=1)
_, T_gt = trajectory_from_df(take_rows(gt, idx))
a = ate(T_est, T_gt)
r = rpe(T_est, T_gt)
print(f"SLAM ATE rmse {a['rmse']*1000:.1f} mm (max {a['max']*1000:.1f}), "
      f"RPE trans rmse {r.get('trans_rmse', float('nan'))}", flush=True)
