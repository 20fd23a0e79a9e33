"""Device timing of the FPFH global-registration path.

The reference treats `fpfh` as a selectable but non-recommended method
(run_scanmatcher.py:166-171); it ships here with full parity
(registration/global_reg.py) and this benchmark provides the device-side
evidence BASELINE.md cites: per-pair cost of descriptor computation +
mutual/ratio matching + batched MSAC + point-to-plane refinement at
pipeline capacities.

The descriptor stage is O(N^2) neighborhood sweeps twice (SPFH then
neighbor-weighted FPFH), so per-pair cost is dominated by four (N,N)
passes; num_hypotheses only affects the (cheap) batched RANSAC scoring.

Usage:  python benchmarks/fpfh.py [CAP] [REPS]
Prints one JSON line.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CAP = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
REPS = int(sys.argv[2]) if len(sys.argv) > 2 else 3
N_PAIRS = int(os.environ.get("FPFH_PAIRS", 4))


def main():
    import jax
    import jax.numpy as jnp
    from lidar_slam_arvc_tpu import cloud as cl
    from lidar_slam_arvc_tpu.cloud import Cloud
    from lidar_slam_arvc_tpu.registration import ICPParams
    from lidar_slam_arvc_tpu.registration.global_reg import (
        GlobalRegParams, global_registration)
    from lidar_slam_arvc_tpu.utils import synthetic
    from lidar_slam_arvc_tpu.utils.profiling import (
        CompileCounter, setup_compile_cache)

    setup_compile_cache()

    rng = np.random.default_rng(0)
    # boxes give FPFH discriminative corner/edge geometry (synthetic.py)
    world = synthetic.make_world(rng, extent=20.0, n_ground=20000,
                                 n_pillars=25, pillar_pts=500,
                                 n_boxes=20, box_pts=800)
    # consecutive poses ~1.26 m apart (40 around the circle): the overlap
    # regime global registration exists for
    T = synthetic.make_trajectory(40, radius=8.0)[: N_PAIRS + 1]

    def prep(i):
        scan = synthetic.render_scan(world, T[i], rng, max_range=20.0,
                                     max_points=4 * CAP)
        c = cl.from_numpy(scan, 4 * CAP)
        c = cl.crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
        c = cl.voxel_downsample(c, 0.2, out_capacity=CAP)
        c = cl.estimate_normals(c, 0.5)
        key = jax.random.PRNGKey(i)
        plane = cl.ransac_ground_plane(c, key, seed_height=-0.5,
                                       distance_threshold=0.01,
                                       num_iterations=1000)
        _, ng = cl.split_by_plane(c, plane, 0.4)
        return c, ng

    clouds = [prep(i) for i in range(N_PAIRS + 1)]
    gp = GlobalRegParams(
        fpfh_radius=1.0,
        icp=ICPParams(max_correspondence_distance=10.0, max_iterations=15))

    def one(sp, sm, sngm, tp, tm, tngm, tn, sn, key):
        return global_registration(
            Cloud(sp, sm, sn), Cloud(tp, tm, tn), key, gp,
            src_nonground=Cloud(sp, sngm, sn),
            tgt_nonground=Cloud(tp, tngm, tn))

    batched = jax.jit(jax.vmap(one))
    stack = lambda f: jnp.stack([f(i) for i in range(1, N_PAIRS + 1)])
    src = stack(lambda i: clouds[i][0].points)
    sm = stack(lambda i: clouds[i][0].mask)
    sngm = stack(lambda i: clouds[i][1].mask)
    sn = stack(lambda i: clouds[i][0].normals)
    tgt = stack(lambda i: clouds[i - 1][0].points)
    tm = stack(lambda i: clouds[i - 1][0].mask)
    tngm = stack(lambda i: clouds[i - 1][1].mask)
    tn = stack(lambda i: clouds[i - 1][0].normals)
    keys = jax.random.split(jax.random.PRNGKey(7), N_PAIRS)

    counter = CompileCounter()
    with counter.scope():
        t0 = time.time()
        res = batched(src, sm, sngm, tgt, tm, tngm, tn, sn, keys)
        np.asarray(res.transform)
        t_compile = time.time() - t0

    t = float("inf")
    for _ in range(REPS):
        t0 = time.time()
        res = batched(src, sm, sngm, tgt, tm, tngm, tn, sn, keys)
        T_out = np.asarray(res.transform, dtype=np.float64)
        t = min(t, time.time() - t0)

    # accuracy: against ground-truth relatives (NO odometry seed was given)
    T_ref = np.stack([np.linalg.inv(T[i - 1]) @ T[i]
                      for i in range(1, N_PAIRS + 1)])
    dt = np.linalg.norm(T_out[:, :3, 3] - T_ref[:, :3, 3], axis=1)
    print(json.dumps({
        "metric": "fpfh_global_registration_ms_per_pair",
        "value": round(t / N_PAIRS * 1e3, 2),
        "unit": "ms/pair",
        "capacity": CAP, "pairs": N_PAIRS,
        "first_call_seconds": round(t_compile, 1),
        "programs_compiled": counter.count,
        "trans_err_mm": [round(float(x) * 1e3, 1) for x in dt],
    }))


if __name__ == "__main__":
    main()
