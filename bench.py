"""Benchmark: LiDAR scan-matching throughput (frames/s) on the local device.

Prints ONE JSON line:
    {"metric": "scanmatch_frames_per_second", "value": N, "unit": "frames/s",
     "vs_baseline": R, "icp_phase_fps": ..., "preprocess_seconds": ...}

The workload is BASELINE.json config 2: odometry-seeded point-to-plane ICP
over consecutive pairs of voxel-downsampled synthetic LiDAR scans
(reference regime: 10 m correspondence gate, 0.2 m voxels, ~6-16k points
per cloud after preprocessing).

``value`` is END-TO-END stage-1 frames/s: device preprocessing
(crop+voxel+normals, steady-state) PLUS the ICP phase, matching the window
the reference's own per-frame timer covers (run_scanmatcher.py:194,
209-210).  The ICP-phase-only figure (the r1-r3 headline) is reported as
``icp_phase_fps``.

``vs_baseline`` divides like by like: the CPU baseline window also spans
preprocessing (crop/voxel/normals) + ICP, re-created faithfully from the
reference's per-pair pipeline with scipy cKDTree nearest neighbors + numpy
point-to-plane Gauss-Newton at the same iteration count (the reference's
own Open3D C++ ICP, unavailable here, is the same algorithm; see
BASELINE.md for the caveat).  The baseline is timed on a few pairs and
extrapolated.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

# 257 scans (256 pairs): the reference's sequences are hundreds of scans
# (automate.sh datasets), and the ICP phase has a fixed dispatch cost on
# top of its per-pair cost, which a short sequence would mostly measure.
# The CPU baseline is per-pair-extrapolated so vs_baseline stays
# apples-to-apples at any scan count.
N_SCANS = int(os.environ.get("BENCH_SCANS", 257))         # pairs = N-1
SCAN_POINTS = int(os.environ.get("BENCH_POINTS", 12000))
VOXEL = 0.2
# pairs per vmapped group: a group runs until every member converges, so
# smaller groups waste fewer post-convergence iterations
BATCH = int(os.environ.get("BENCH_BATCH", 4))
ICP_ITERS = 30
BASELINE_PAIRS = int(os.environ.get("BENCH_BASELINE_PAIRS", 3))
CAP_RAW = int(os.environ.get("BENCH_CAP_RAW", 16384))
CAP = int(os.environ.get("BENCH_CAP", 8192))
# persistent source subsampling (registration/icp.py source_stride), applied
# to BOTH the device ICP and the CPU baseline so vs_baseline stays
# apples-to-apples; the accuracy guard below reports its deviation from
# the ground-truth relatives.  Default 4; 1 = all sources (reference
# parity).
STRIDE = int(os.environ.get("BENCH_STRIDE", 4))
# se(3)-update-norm early-exit tolerance (registration/icp.py
# ICPParams.convergence_tol); exposed for tolerance/iteration sweeps
TOL = float(os.environ.get("BENCH_TOL", 1e-4))
# timed repetitions; the MIN is reported
REPS = int(os.environ.get("BENCH_REPS", 3))


def build_workload():
    from lidar_slam_arvc_tpu import cloud as cl
    from lidar_slam_arvc_tpu.utils import synthetic

    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng, extent=30.0, n_ground=20000,
                                 n_pillars=40, pillar_pts=500)
    T = synthetic.make_trajectory(N_SCANS, radius=12.0)
    scans = [synthetic.render_scan(world, T[i], rng, max_range=25.0,
                                   max_points=SCAN_POINTS)
             for i in range(N_SCANS)]
    seeds = np.stack([np.linalg.inv(T[i]) @ T[i + 1]
                      for i in range(N_SCANS - 1)]).astype(np.float32)
    return scans, seeds


def run_device(scans, seeds):
    """Each timed window ends in a host transfer of its result."""
    import jax
    import jax.numpy as jnp
    from lidar_slam_arvc_tpu import cloud as cl
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import _match_all_fused
    from lidar_slam_arvc_tpu.registration import ICPParams

    cap_raw = CAP_RAW
    cap = CAP
    params = ICPParams(max_correspondence_distance=10.0,
                       max_iterations=ICP_ITERS,
                       source_stride=STRIDE, convergence_tol=TOL)

    # one jitted program for the whole batched preprocess
    @jax.jit
    def prep_all(raw_pts, raw_mask):
        def one(p, m):
            c = cl.Cloud(p, m)
            c = cl.crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
            c = cl.voxel_downsample(c, VOXEL, out_capacity=cap)
            c = cl.estimate_normals(c, radius=0.3)
            return c.points, c.mask, c.normals
        return jax.vmap(one)(raw_pts, raw_mask)

    t_pre0 = time.time()
    stacked = [cl.from_numpy(s, cap_raw) for s in scans]
    raw_pts = jnp.stack([c.points for c in stacked])
    raw_mask = jnp.stack([c.mask for c in stacked])
    pts, mask, normals = prep_all(raw_pts, raw_mask)
    np.asarray(normals[0, 0])  # force completion
    t_pre = time.time() - t_pre0          # includes the one-time compile
    t_pre_run = float("inf")              # steady-state preprocess runtime
    for _ in range(REPS):
        t0 = time.time()
        pts, mask, normals = prep_all(raw_pts, raw_mask)
        np.asarray(normals[0, 0])
        t_pre_run = min(t_pre_run, time.time() - t0)

    n_pairs = N_SCANS - 1
    pad = (-n_pairs) % BATCH
    idx_src = jnp.asarray(np.concatenate(
        [np.arange(1, n_pairs + 1), np.full(pad, n_pairs)]))
    idx_tgt = jnp.asarray(np.concatenate(
        [np.arange(0, n_pairs), np.full(pad, n_pairs)]))
    seeds_j = jnp.asarray(np.concatenate(
        [seeds, np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))]))

    def run_all():
        T, fit, iters, _ = _match_all_fused(pts, mask, normals, idx_src,
                                            idx_tgt, seeds_j, params,
                                            "point_to_plane", BATCH)
        return np.asarray(T), iters  # host transfer = completion barrier

    run_all()               # warmup/compile
    t_icp = float("inf")
    for _ in range(REPS):
        t0 = time.time()
        T_out, iters = run_all()
        t_icp = min(t_icp, time.time() - t0)
    iters = np.asarray(iters)[:n_pairs]
    sys.stderr.write(f"icp iterations/pair: mean {iters.mean():.1f}, "
                     f"max {int(iters.max())} "
                     f"(group size {BATCH}: a group iterates until its "
                     f"slowest member converges)\n")
    fps = n_pairs / t_icp
    return fps, t_icp, (t_pre, t_pre_run), T_out[:n_pairs]


def run_cpu_baseline(scans, seeds):
    """Reference-equivalent CPU pipeline: cKDTree NN + numpy p2pl GN."""
    from scipy.spatial import cKDTree

    def crop_voxel(scan):
        r2 = scan[:, 0] ** 2 + scan[:, 1] ** 2
        keep = (r2 > 0.25) & (r2 < 35.0 ** 2) & (scan[:, 2] > -1) & (scan[:, 2] < 50)
        p = scan[keep]
        keys = np.floor((p - p.min(0)) / VOXEL).astype(np.int64)
        key = keys[:, 0] * 4_000_000 + keys[:, 1] * 2000 + keys[:, 2]
        order = np.argsort(key)
        key_s = key[order]
        p_s = p[order]
        first = np.concatenate([[True], key_s[1:] != key_s[:-1]])
        slot = np.cumsum(first) - 1
        sums = np.zeros((slot[-1] + 1, 3))
        np.add.at(sums, slot, p_s)
        counts = np.bincount(slot)
        return sums / counts[:, None]

    def normals_for(p, tree, radius=0.3):
        n = np.zeros_like(p)
        # vectorized-ish: query_ball on a subsample of the work per point is
        # inherent to the reference's per-point KD-tree usage
        idx_lists = tree.query_ball_point(p, radius, workers=-1)
        for i, nb in enumerate(idx_lists):
            if len(nb) < 3:
                n[i] = (0, 0, 1)
                continue
            q = p[nb]
            q = q - q.mean(0)
            cov = q.T @ q
            w, V = np.linalg.eigh(cov)
            n[i] = V[:, 0]
        return n

    def icp_pair(src, tgt, tgt_n, T0):
        tree = cKDTree(tgt)
        src = src[::STRIDE]  # same source subsampling as the device path
        T = T0.astype(np.float64).copy()
        for _ in range(ICP_ITERS):
            p = src @ T[:3, :3].T + T[:3, 3]
            d, j = tree.query(p, workers=-1)
            ok = d < 10.0
            pp, qq, nn = p[ok], tgt[j[ok]], tgt_n[j[ok]]
            r = np.sum(nn * (pp - qq), axis=1)
            Jw = np.cross(pp, nn)
            J = np.concatenate([Jw, nn], axis=1)
            H = J.T @ J
            b = -J.T @ r
            xi = np.linalg.solve(H + 1e-6 * np.eye(6), b)
            # se3 exp (small angle adequate for benchmark baseline)
            from scipy.spatial.transform import Rotation as SR
            dT = np.eye(4)
            dT[:3, :3] = SR.from_rotvec(xi[:3]).as_matrix()
            dT[:3, 3] = xi[3:]
            T = dT @ T
        return T

    t0 = time.time()
    pre = []
    for s in scans[: BASELINE_PAIRS + 1]:
        p = crop_voxel(s)
        tree = cKDTree(p)
        pre.append((p, normals_for(p, tree)))
    for i in range(BASELINE_PAIRS):
        src = pre[i + 1][0]
        tgt, tgt_n = pre[i]
        icp_pair(src, tgt, tgt_n, seeds[i])
    dt = time.time() - t0
    return BASELINE_PAIRS / dt


def pinned_baseline_fps():
    """The pinned per-pair CPU baseline from BASELINE.json, or None.

    r4 verdict weak-point 3: live-re-timing 3 pairs on the shared 2-core
    box made vs_baseline swing +-40% run to run.  The constant is measured
    in isolation by benchmarks/cpu_baseline_pin.py (protocol recorded
    alongside); it only applies when the workload matches the pinned
    configuration.  BENCH_LIVE_BASELINE=1 forces a live re-measure.
    """
    if os.environ.get("BENCH_LIVE_BASELINE") == "1":
        return None
    try:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "BASELINE.json")) as f:
            pin = json.load(f).get("cpu_baseline")
    except (FileNotFoundError, json.JSONDecodeError):
        return None
    try:
        if (pin["scan_points"] != SCAN_POINTS
                or pin["voxel"] != VOXEL
                or pin["icp_iterations"] != ICP_ITERS):
            return None
        return pin["frames_per_second_by_stride"].get(str(STRIDE))
    except (KeyError, TypeError, AttributeError):
        # malformed cpu_baseline entry -> fall back to the live measure
        return None


def main():
    from lidar_slam_arvc_tpu.utils.profiling import (
        CompileCounter, setup_compile_cache)
    setup_compile_cache()
    scans, seeds = build_workload()
    counter = CompileCounter()
    with counter.scope():
        fps, t_icp, (t_pre, t_pre_run), T_out = run_device(scans, seeds)
    sys.stderr.write(f"compiled programs: {counter.count} "
                     f"({counter.seconds:.1f}s client-side compile)\n")

    skip_baseline = os.environ.get("BENCH_SKIP_BASELINE") == "1"
    if skip_baseline:
        baseline_fps = float("nan")
        vs = float("nan")
    else:
        baseline_fps = pinned_baseline_fps()
        if baseline_fps is not None:
            sys.stderr.write(f"cpu baseline: pinned constant "
                             f"{baseline_fps} fps at stride {STRIDE} "
                             f"(BASELINE.json cpu_baseline; "
                             f"BENCH_LIVE_BASELINE=1 to re-measure)\n")
        else:
            baseline_fps = run_cpu_baseline(scans, seeds)
        vs = fps / baseline_fps

    # accuracy guard: the odometry seeds ARE the exact ground-truth relative
    # transforms (build_workload), so refined ICP output should sit within
    # the scan-noise floor of them at ANY source_stride setting
    dev = np.linalg.norm(T_out[:, :3, 3] - seeds[:, :3, 3], axis=1)
    n_pairs = len(T_out)
    fps_e2e = n_pairs / (t_pre_run + t_icp)
    vs_e2e = float("nan") if skip_baseline else fps_e2e / baseline_fps
    sys.stderr.write(
        f"device icp: {t_icp:.3f}s for {n_pairs} pairs "
        f"(preprocess {t_pre:.2f}s incl compile, {t_pre_run:.3f}s steady-state); "
        f"end-to-end {fps_e2e:.1f} frames/s, icp-phase {fps:.1f}; "
        f"stride {STRIDE} deviation from ground-truth relatives: "
        f"rmse {float(np.sqrt(np.mean(dev ** 2))) * 1000:.1f} mm, "
        f"max {float(dev.max()) * 1000:.1f} mm; "
        f"cpu-reference baseline "
        f"{baseline_fps:.3f} frames/s\n")
    print(json.dumps({
        "metric": "scanmatch_frames_per_second",
        "value": round(fps_e2e, 3),
        "unit": "frames/s",
        "vs_baseline": round(vs_e2e, 3) if vs_e2e == vs_e2e else None,
        "icp_phase_fps": round(fps, 3),
        "preprocess_seconds": round(t_pre_run, 4),
        "icp_seconds": round(t_icp, 4),
    }))


if __name__ == "__main__":
    main()
