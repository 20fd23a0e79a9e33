"""Weak-scaling harness for the mesh-sharded scan-matching stage.

BASELINE.md's third north-star row (>=80% scaling efficiency to N devices)
is measured by this harness on real multi-device hardware; it also runs on
the virtual CPU mesh to validate the methodology end-to-end.

Weak scaling: each device gets the same number of scan pairs (PAIRS_PER_DEV),
so ideal scaling keeps wall time flat as devices grow.  Efficiency(D) =
T(1) / T(D).  The measured program is pipeline/scanmatcher._mesh_matcher —
the exact code path `--devices D` runs, not a synthetic kernel.

Usage:
    python benchmarks/weak_scaling.py                # all D in 1,2,4,...,N
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS='' python benchmarks/weak_scaling.py   # virtual mesh

Prints one JSON line per mesh width plus a summary line.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PAIRS_PER_DEV = int(os.environ.get("WS_PAIRS_PER_DEV", 8))
CAP = int(os.environ.get("WS_CAP", 4096))
BATCH = int(os.environ.get("WS_BATCH", 4))
ITERS = int(os.environ.get("WS_ITERS", 8))
REPS = int(os.environ.get("WS_REPS", 3))
# WS_SHARDED=1: shard the scan stack itself (ppermute halo exchange,
# --shard-scans) instead of replicating it — the memory-scaling layout
SHARDED = os.environ.get("WS_SHARDED", "0") == "1"
# sharded slots/device = ceil(P/B)*B: keep P a batch multiple so both
# layouts do identical per-device work
PAIRS_PER_DEV = -(-PAIRS_PER_DEV // BATCH) * BATCH


def main():
    import jax
    if os.environ.get("JAX_PLATFORMS") == "":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from lidar_slam_arvc_tpu.parallel import data_mesh
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import (
        _match_all_fused, _mesh_matcher, _sharded_stack_dispatch)
    from lidar_slam_arvc_tpu.registration import ICPParams
    from lidar_slam_arvc_tpu.utils import synthetic
    from lidar_slam_arvc_tpu import cloud as cl

    n_dev = len(jax.devices())
    widths = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    max_pairs = widths[-1] * PAIRS_PER_DEV
    n_scans = max_pairs + 1

    rng = np.random.default_rng(0)
    world = synthetic.make_world(rng, extent=20.0, n_ground=8000,
                                 n_pillars=20, pillar_pts=300)
    T = synthetic.make_trajectory(n_scans, radius=10.0)

    def prep(i):
        scan = synthetic.render_scan(world, T[i], rng, max_range=18.0,
                                     max_points=CAP)
        c = cl.from_numpy(scan, CAP)
        c = cl.voxel_downsample(c, 0.2)
        return cl.estimate_normals(c, 0.5)

    clouds = [prep(i) for i in range(n_scans)]
    points = jnp.stack([c.points for c in clouds])
    mask = jnp.stack([c.mask for c in clouds])
    normals = jnp.stack([c.normals for c in clouds])
    seeds_all = np.stack([np.linalg.inv(T[i]) @ T[i + 1]
                          for i in range(max_pairs)]).astype(np.float32)

    params = ICPParams(max_correspondence_distance=10.0,
                       max_iterations=ITERS, convergence_tol=0.0)

    t1 = None
    results = []
    for D in widths:
        n_pairs = D * PAIRS_PER_DEV
        idx_src = jnp.asarray(np.arange(1, n_pairs + 1))
        idx_tgt = jnp.asarray(np.arange(0, n_pairs))
        seeds = jnp.asarray(seeds_all[:n_pairs])

        if D == 1:
            run = lambda: _match_all_fused(points, mask, normals, idx_src,
                                           idx_tgt, seeds, params,
                                           "point_to_plane", BATCH)
        elif SHARDED:
            # n_scans = D*PAIRS_PER_DEV exactly -> K = PAIRS_PER_DEV slots
            # per device with NO padding: same per-device work as the
            # replicated layout (the single cyclic-wrap slot is a self-pair,
            # 1/(D*P) of the work), so efficiency measures communication,
            # not padding
            mesh_d, ns = data_mesh(D), n_pairs
            run = lambda: _sharded_stack_dispatch(
                mesh_d, points[:ns], mask[:ns], normals[:ns],
                seeds_all[: ns - 1], params, "point_to_plane", BATCH)
        else:
            matcher = _mesh_matcher(data_mesh(D), params, "point_to_plane",
                                    BATCH)
            run = lambda: matcher(points, mask, normals, idx_src, idx_tgt,
                                  seeds)

        np.asarray(run()[0])                # compile + warmup
        t = float("inf")
        for _ in range(REPS):
            t0 = time.time()
            np.asarray(run()[0])            # host transfer = barrier
            t = min(t, time.time() - t0)
        if D == 1:
            t1 = t
        eff = t1 / t
        results.append({"devices": D, "pairs": n_pairs,
                        "seconds": round(t, 4),
                        "pairs_per_second": round(n_pairs / t, 1),
                        "weak_scaling_efficiency": round(eff, 3)})
        print(json.dumps(results[-1]))

    summary = {"metric": "weak_scaling_efficiency",
               "value": results[-1]["weak_scaling_efficiency"],
               "unit": "fraction_of_ideal",
               "devices": results[-1]["devices"],
               "backend": jax.default_backend()}
    if jax.default_backend() == "cpu":
        # virtual devices TIME-SHARE the physical cores: D virtual devices
        # on C cores bound weak-scaling efficiency by C/D, so numbers here
        # validate the harness, not the hardware (run on a real slice for
        # the BASELINE.md >=80% target)
        summary["physical_cores"] = os.cpu_count()
        summary["virtual_mesh_efficiency_ceiling"] = round(
            min(1.0, os.cpu_count() / results[-1]["devices"]), 3)

    # --- communication/compute model for projecting real-hardware scaling
    # (BASELINE.md >=80% north star).
    # Sharded stage 1 communicates exactly ONE scan per device per stage
    # (the ppermute halo: points f32x3 + normals f32x3 + mask bool) plus the
    # per-pair result allgather (4x4 f32 + 2 scalars).  Efficiency(D) =
    # compute / (compute + comm) with compute = pairs_per_device x the
    # single-device per-pair ICP time (WS_COMPUTE_MS_PER_PAIR; not
    # measured on the GPU yet) — both terms scale per device,
    # so the projection is D-independent until the allgather's log(D) term
    # matters.  Override via WS_COMPUTE_MS_PER_PAIR / WS_ICI_BYTES_PER_S.
    halo_bytes = CAP * (3 * 4 + 3 * 4 + 1)
    result_bytes_per_pair = 16 * 4 + 8
    compute_ms_per_pair = float(os.environ.get("WS_COMPUTE_MS_PER_PAIR",
                                               0.4))
    ici = float(os.environ.get("WS_ICI_BYTES_PER_S", 4.5e10))
    t_compute = PAIRS_PER_DEV * compute_ms_per_pair * 1e-3
    t_comm = (halo_bytes + PAIRS_PER_DEV * result_bytes_per_pair) / ici
    summary["comm_model"] = {
        "halo_bytes_per_device_per_stage": int(halo_bytes),
        "result_allgather_bytes_per_pair": int(result_bytes_per_pair),
        "assumed_compute_ms_per_pair": compute_ms_per_pair,
        "assumed_ici_bytes_per_s": ici,
        "pairs_per_device": int(PAIRS_PER_DEV),
        "projected_efficiency_real_hardware": round(
            t_compute / (t_compute + t_comm), 4),
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
