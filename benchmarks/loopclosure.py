"""Reference-scale loop closing (stage 2) on the local device.

This benchmark runs the regime reference run_graphSLAM.py:153,168 targets: 200+ scans,
radius_threshold 2-7 m, the FULL-RESOLUTION keyframe store (voxel None,
run_graphSLAM.py:224) at the default capacities (raw 65536 / capacity
16384), triangle-consistency loop closing against hundreds of candidates.

The trajectory is a closed circuit whose tail re-enters the head's
neighborhood, so genuine closures exist; scans carry ~LC_POINTS points
(reference outdoor scans are 20-60k).  Reports per-stage wall, closures
accepted, and the ATE improvement closures give over open-loop scan
matching with deliberately drifted odometry.

Usage:  python benchmarks/loopclosure.py
Env: LC_SCANS (default 220), LC_POINTS (20000); LC_CAP_RAW / LC_CAP
shrink the capacities for smoke tests on the CPU (LC_CPU=1).
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N_SCANS = int(os.environ.get("LC_SCANS", 220))
SCAN_POINTS = int(os.environ.get("LC_POINTS", 20000))
# CPU smoke-test shrinkers; leave unset for the default capacities
CAP_RAW = int(os.environ.get("LC_CAP_RAW", 65536))
CAP = int(os.environ.get("LC_CAP", 16384))


def main():
    if os.environ.get("LC_CPU") == "1":     # smoke-testing on the dev box
        import jax
        jax.config.update("jax_platforms", "cpu")
    from lidar_slam_arvc_tpu.io.formats import dump_yaml, load_yaml
    from lidar_slam_arvc_tpu.pipeline.graphslam import run_graphslam
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher
    from lidar_slam_arvc_tpu.utils import synthetic
    from lidar_slam_arvc_tpu.utils.config import IcpConfig
    from lidar_slam_arvc_tpu.utils.metrics import ate
    from lidar_slam_arvc_tpu.utils.profiling import (
        CompileCounter, setup_compile_cache)

    setup_compile_cache()

    d = os.environ.get("LC_DIR") or tempfile.mkdtemp(prefix="lc_")
    if not os.path.exists(os.path.join(d, "robot0", "lidar", "data.csv")):
        # no GPS anchors: closures are the only drift correction, so the
        # ATE delta isolates the loop-closure path
        info = synthetic.make_outdoor_loop_dataset(
            d, n_scans=N_SCANS, scan_points=SCAN_POINTS, with_gps=False)
        np.save(f"{d}/T_gt.npy", info["T_gt"])
    T_gt = np.load(f"{d}/T_gt.npy")
    print(f"dataset: {d} ({N_SCANS} scans x {SCAN_POINTS} pts)", flush=True)

    cfg = IcpConfig(raw_capacity=CAP_RAW, capacity=CAP)
    # defaults: capacities 65536/16384, voxel None — the reference regime
    counter = CompileCounter()
    with counter.scope():
        t0 = time.time()
        # fused two-stage mode (SURVEY §2.3 row 5): stage 2 reuses stage
        # 1's preprocessed device tensors — both stages run voxel None at
        # the same capacity, so re-loading 20k-point PCDs would be pure
        # duplicated work (LC_FUSED=0 to force the filesystem round trip)
        fused = os.environ.get("LC_FUSED", "1") == "1"
        out_sm = run_scanmatcher(d, cfg=cfg, progress=False,
                                 return_preprocessed=fused)
        t1 = time.time()
        out_g = run_graphslam(d, cfg=cfg, progress=False,
                              preprocessed=out_sm.get("preprocessed"))
        t2 = time.time()

    with open(f"{d}/robot0/viz/graphslam_profile.json") as f:
        prof = json.load(f)
    with open(f"{d}/robot0/viz/scanmatcher_profile.json") as f:
        prof_sm = json.load(f)

    # CONTROL: the same stage 2 with loop closing off isolates what the
    # closures buy — the graph also fuses the (drifty) odometry edges at
    # the reference's equal SM/ODO xyz sigmas (graphSLAM.py:17,21), so
    # comparing against the scanmatcher ATE alone conflates the two.
    ypath = f"{d}/robot0/slam_parameters.yaml"
    slam_params = load_yaml(ypath)
    slam_params["perform_loop_closing"] = False
    dump_yaml(slam_params, ypath)
    out_nl = run_graphslam(d, cfg=cfg, progress=False)
    slam_params["perform_loop_closing"] = True
    dump_yaml(slam_params, ypath)

    e_sm = ate(out_sm["global"], T_gt)["rmse"]
    e_slam = ate(np.asarray(out_g["solution"]), T_gt)["rmse"]
    e_noloop = ate(np.asarray(out_nl["solution"]), T_gt)["rmse"]
    print(json.dumps({
        "metric": "loopclosure_reference_scale",
        "scans": N_SCANS, "scan_points": SCAN_POINTS,
        "capacity": cfg.capacity, "voxel": None,
        "radius_threshold": 7.0, "distance_backwards": 7.0,
        "stage1_seconds": round(t1 - t0, 2),
        "stage2_seconds": round(t2 - t1, 2),
        "store_load_preprocess_seconds":
            prof["store_load_preprocess_seconds"],
        "solve_loop_seconds": prof["solve_loop_seconds"],
        # per-phase breakdown (r5): where the solve+loop wall actually goes
        "optimize_seconds": prof["optimize_seconds"],
        "loop_candidate_search_seconds":
            prof["loop_candidate_search_seconds"],
        "loop_icp_seconds": prof["loop_icp_seconds"],
        "loop_icp_dispatches": prof["loop_icp_dispatches"],
        "loop_icp_pairs": prof["loop_icp_pairs"],
        "marginals_seconds": prof["marginals_seconds"],
        "host_other_seconds": prof["host_other_seconds"],
        "store_reused_stage1": prof["store_reused_stage1"],
        "solver": prof["solver"],
        "optimizations": prof["optimizations"],
        "loop_closing_rounds": prof["loop_closing_rounds"],
        "loop_closures_accepted": prof["loop_closures_accepted"],
        "scans_over_capacity": prof_sm["scans_over_capacity"],
        "ate_scanmatcher_mm": round(e_sm * 1e3, 1),
        "ate_graphslam_mm": round(e_slam * 1e3, 1),
        "ate_graphslam_noloops_mm": round(e_noloop * 1e3, 1),
        "programs_compiled": counter.count,
    }), flush=True)


if __name__ == "__main__":
    main()
