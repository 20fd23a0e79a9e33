"""Stage 2: pose-graph SLAM with loop closing and optional GPS fusion.

Pipeline parity with reference run_graphSLAM.py:123-289: consume the
scanmatcher CSVs + odometry + GPS, build a pose graph with SM and ODO
between-factors and GPS unary factors, optimize every ``skip_optimization``
poses, attempt triangle loop closures every ``skip_loop_closing`` poses, and
write the SLAM solution + accepted loop closures.

The ISAM2 incremental updates of the reference become batch LM re-solves at
the same cadence (graph/solver.py); per-triplet loop-closure ICPs are
batched on device (loop/loopclosing.py).
"""

from __future__ import annotations

import time

import numpy as np

from lidar_slam_arvc_tpu.graph import PoseGraph
from lidar_slam_arvc_tpu.io import EurocDataset, filter_gps, gps2utm
from lidar_slam_arvc_tpu.io.euroc import trajectory_from_df
from lidar_slam_arvc_tpu.loop import LoopCloser
from lidar_slam_arvc_tpu.utils.config import IcpConfig


def prepare_experiment_data(euroc: EurocDataset):
    """(reference run_graphSLAM.py:38-74)."""
    df_scan_times = euroc.read_csv("/robot0/scanmatcher/lidar_times.csv")
    scan_times = df_scan_times["#timestamp [ns]"]
    df_sm_global = euroc.read_csv("/robot0/scanmatcher/scanmatcher_global.csv")
    try:
        df_odo = euroc.read_csv("/robot0/odom/data.csv")
        odo_times = euroc.get_closest_times(
            scan_times, df_odo["#timestamp [ns]"])
        df_odo = euroc.get_df_at_times(df_odo, odo_times)
    except FileNotFoundError:
        df_odo = None
    try:
        df_gps = euroc.read_csv("/robot0/gps0/data.csv")
        latlonref = euroc.read_utm_ref("gps0")
        df_gps = filter_gps(df_gps)
        df_gps = gps2utm(df_gps, latlonref)
        gps_times = df_gps["#timestamp [ns]"]
        T0_gps = euroc.read_transform("gps0")
    except FileNotFoundError:
        df_gps, gps_times, T0_gps = None, None, None
    return scan_times, df_sm_global, df_odo, df_gps, gps_times, T0_gps


def get_current_gps_reading(current_time, gps_times,
                            max_delta_time_s: float = 0.1):
    """(reference run_graphSLAM.py:77-85)."""
    if gps_times is None:
        return None
    diff = np.abs((gps_times - current_time) / 1e9)
    i = int(np.argmin(diff))
    return i if diff[i] < max_delta_time_s else None


def _relative(T: np.ndarray) -> np.ndarray:
    return np.einsum("nij,njk->nik", np.linalg.inv(T[:-1]), T[1:])


def run_graphslam(directory: str, cfg: IcpConfig | None = None,
                  progress: bool = True, preprocessed: dict | None = None) -> dict:
    """Full stage 2; writes solution_graphslam.csv + loop_closures.csv.

    ``preprocessed``: the ``"preprocessed"`` dict from
    ``run_scanmatcher(return_preprocessed=True)`` — a fused two-stage run
    reuses stage 1's on-device scan tensors for the loop-closure store
    instead of re-loading and re-preprocessing every PCD, when the
    configurations match (voxel None, same method/capacity/scan times);
    otherwise it is ignored and the store loads from disk as usual.
    """
    from lidar_slam_arvc_tpu.utils.profiling import CompileCounter
    compiles = CompileCounter()
    with compiles.scope():
        return _run_graphslam(directory, cfg, progress, compiles,
                              preprocessed)


def _run_graphslam(directory, cfg, progress, compiles, preprocessed=None):
    import jax
    euroc = EurocDataset(directory)
    params = euroc.read_slam_parameters()
    perform_loop_closing = params.get("perform_loop_closing", True)
    method = params.get("method", "icppointplane")
    skip_loop_closing = params.get("skip_loop_closing", 50)
    skip_optimization = params.get("skip_optimization", 50)
    n_triplets = params.get("number_of_triplets_loop_closing", 20)
    radius_threshold = params.get("radius_threshold", 2.0)
    distance_backwards = params.get("distance_backwards", 9.0)
    if cfg is None:
        cfg = IcpConfig()

    (scan_times, df_sm_global, df_odo, df_gps, gps_times,
     T0_gps) = prepare_experiment_data(euroc)
    if T0_gps is None:
        T0_gps = np.eye(4)

    # rebase trajectories into the GPS frame (run_graphSLAM.py:207-215)
    _, sm_global = trajectory_from_df(df_sm_global)
    sm_global = np.einsum("nij,jk->nik", sm_global, T0_gps)
    sm_rel = _relative(sm_global)
    odo_T = trajectory_from_df(df_odo)[1] if df_odo is not None else None
    if odo_T is not None:
        odo_T = np.einsum("nij,jk->nik", odo_T, T0_gps)
        odo_rel = _relative(odo_T)
    else:
        odo_rel = None

    n = len(sm_rel) + 1
    from lidar_slam_arvc_tpu.parallel.mesh import resolve_mesh
    mesh = resolve_mesh(cfg.mesh_devices)
    if mesh is not None and _next_pow2(n) < 2 * mesh.size:
        mesh = None  # graph too small to split across devices
    # explicit factor-buffer partition: 2*max_poses chain slots (SM+ODO
    # consecutive edges — assembled scatter-free as a block-tridiagonal
    # band) + a loop-closure budget sized from the closing cadence
    max_poses = _next_pow2(n)
    chain_cap = 2 * max_poses
    loop_cap = _next_pow2(8 * n_triplets
                          * max(n // max(skip_loop_closing, 1), 1) + 64)
    graph = PoseGraph(T0=np.eye(4), T0_gps=T0_gps, mesh=mesh,
                      max_poses=max_poses,
                      max_between=chain_cap + loop_cap,
                      chain_capacity=chain_cap,
                      max_gps=_next_pow2(n))
    graph.init_graph()

    loops_enabled = perform_loop_closing
    t_store0 = time.time()
    if loops_enabled:
        # full-resolution clouds for loop-closure ICP (voxel None —
        # run_graphSLAM.py:224); preprocessed once, batched.  The store
        # carries the CONFIGURED registration method — loop closures
        # dispatch it exactly as the reference's inherit it through
        # keyframe_manager.compute_transformation (loopclosing.py:180 ->
        # keyframemanager.py:60-72), incl. icp2planes ground/non-ground
        # masks and fpfh.
        from lidar_slam_arvc_tpu.keyframes import KeyframeStore
        store_reused = (
            preprocessed is not None
            and jax.process_count() == 1
            and preprocessed.get("voxel_size") is None      # stage-2 regime
            and preprocessed.get("method") == method
            and preprocessed.get("capacity") == cfg.capacity
            and preprocessed.get("raw_capacity") == cfg.raw_capacity
            and preprocessed.get("crop") == (
                float(cfg.min_radius), float(cfg.max_radius),
                float(cfg.min_height), float(cfg.max_height))
            and preprocessed.get("normal_radius") == float(cfg.normal_radius)
            and np.array_equal(preprocessed.get("scan_times"), scan_times))
        if store_reused:
            # fused in-memory mode: stage 1 already preprocessed these
            # scans with the identical configuration — reuse its device
            # tensors instead of re-loading every PCD
            store = KeyframeStore.from_arrays(
                preprocessed["points"], preprocessed["mask"],
                preprocessed["normals"], method=method, cfg=cfg,
                ground_mask=preprocessed.get("ground_mask"),
                nonground_mask=preprocessed.get("nonground_mask"))
            store.scan_times = scan_times
            store.n_loaded_locally = 0     # zero PCDs read from disk
        else:
            store = KeyframeStore(directory, scan_times, voxel_size=None,
                                  method=method, cfg=cfg)
            # multi-controller: loads only this host's scan block and holds
            # globally sharded tensors (KeyframeStore.load_and_preprocess)
            store.load_and_preprocess()
        if mesh is not None and not store.sharded:
            # scan axis sharded over the mesh: each device holds N/D
            # keyframes; candidate-pair gathers become XLA collectives
            store.shard(mesh)
        closer = LoopCloser(
            graph, store,
            distance_backwards=distance_backwards,
            radius_threshold=radius_threshold)
        store_loaded_locally = store.n_loaded_locally
    else:
        closer = None
        store_loaded_locally = 0
        store_reused = False
    store_seconds = time.time() - t_store0

    corr_indexes = []
    loop_closures = []
    n_optimizations = 0
    optimize_seconds = 0.0
    t0 = time.time()
    for i in range(len(sm_rel)):
        current_time = scan_times[i]
        gps_index = get_current_gps_reading(current_time, gps_times,
                                            max_delta_time_s=0.05)
        if gps_index is not None:
            graph.add_gps_factor(df_gps["x"][gps_index],
                                 df_gps["y"][gps_index],
                                 df_gps["altitude"][gps_index], i)
            corr_indexes.append([i, gps_index])

        graph.add_initial_estimate(sm_rel[i], i + 1)
        graph.add_edge(sm_rel[i], i, i + 1, "SM")
        if odo_rel is not None:
            graph.add_edge(odo_rel[i], i, i + 1, "ODO")

        if i % skip_optimization == 0:
            t_opt = time.time()
            graph.optimize()
            optimize_seconds += time.time() - t_opt
            n_optimizations += 1

        if loops_enabled and ((i % skip_loop_closing) == 0
                              or (len(sm_rel) - i) < 2):
            part = closer.loop_closing_triangle(i, n_triplets)
            loop_closures.append(part)
            # NO re-optimize after closures: the reference only plots here
            # (run_graphSLAM.py:259-268); accepted closure edges take
            # effect at the next cadence optimize (and the final one)
        if progress:
            print(f"\rgraphSLAM step {i + 1}/{len(sm_rel)} "
                  f"({(i + 1) / max(time.time() - t0, 1e-9):.1f} steps/s)",
                  end="")
    if progress:
        print()

    t_opt = time.time()
    graph.optimize(max_iterations=30)
    optimize_seconds += time.time() - t_opt
    n_optimizations += 1

    solution_lidar = graph.get_solution_transforms_lidar()[:n]
    # multi-controller runs share the dataset directory: one writer; a
    # writer failure is deferred so the end-of-stage barrier is reached
    is_writer = jax.process_index() == 0
    csv_error = None
    if is_writer:
        try:
            euroc.save_transforms_as_csv(
                scan_times, solution_lidar,
                "/robot0/SLAM/solution_graphslam.csv")
            euroc.save_loop_closures_as_csv(
                loop_closures, "/robot0/SLAM/loop_closures.csv")
        except Exception as exc:
            csv_error = exc
    # uncertainty-ellipse artifact = the reference's live GraphSLAM.plot
    # with plot_uncertainty_ellipse=True (graphSLAM.py:115-145), headless.
    # Only the plotted (skip-sampled) poses need marginals: chunked dense
    # back-substitution up to the dense-solver capacity, matrix-free PCG
    # blocks beyond — the artifact is produced at ANY graph size.
    # Marginals errors PROPAGATE — a broken uncertainty path must fail the
    # run, not ship a silent artifact gap (round-2 regression pattern).
    # Only the optional matplotlib rendering is allowed to degrade, and the
    # degradation is recorded in the profile JSON.
    uncertainty_error = None
    t_marg = time.time()
    skip = max(n // 64, 1)
    if graph.max_poses <= 256:
        # small graphs: dense chunked back-substitution for ALL poses is
        # cheap (one Cholesky + 4 chunk solves)
        covs = graph.marginal_covariances()
    else:
        # the artifact only plots skip-sampled ellipses, so compute ONLY
        # those blocks (vmapped BCR-preconditioned CG, graph/pcg.py)
        # instead of dense all-pose marginals
        idx = np.arange(0, graph.n_poses, skip)
        blocks = graph.marginal_covariances(indices=idx)
        covs = np.zeros((graph.n_poses, 6, 6))
        covs[idx] = blocks
    marginals_seconds = time.time() - t_marg
    if is_writer:
        try:
            from lidar_slam_arvc_tpu.viz import (
                plot_trajectory_with_uncertainty)
            plot_trajectory_with_uncertainty(
                graph.current_estimate, covs,
                f"{directory}/robot0/SLAM/uncertainty.png", skip=skip)
            # GPS-vs-estimate comparison with correspondence segments —
            # the reference renders this live during optimization
            # (graphSLAM.py:183-209 plot_compare_GPS, called at
            # run_graphSLAM.py:256-267); shipped as the end-of-stage
            # artifact beside uncertainty.png
            if df_gps is not None:
                from lidar_slam_arvc_tpu.viz import plot_gps_comparison
                plot_gps_comparison(
                    graph.current_estimate, df_gps, corr_indexes,
                    f"{directory}/robot0/SLAM/gps_comparison.png")
        except (ImportError, OSError) as exc:  # headless plotting only
            uncertainty_error = f"{type(exc).__name__}: {exc}"
            if progress:
                print(f"uncertainty plot skipped: {uncertainty_error}")
    n_loops = sum(len(g) for g in loop_closures if g)
    seconds = time.time() - t0

    # per-stage profile artifact, mirroring stage 1's
    # scanmatcher_profile.json (SURVEY.md §5: tracing as first-class)
    import json
    import os
    loop_t = closer.timings if closer is not None else {
        "candidate_search_seconds": 0.0, "icp_seconds": 0.0,
        "icp_dispatches": 0, "icp_pairs": 0}
    # per-phase cost breakdown of the solve+loop wall (VERDICT r4 ask 1:
    # which of candidate search / loop ICP / LM optimizes / marginals /
    # host bookkeeping dominates stage 2)
    host_other = (seconds - optimize_seconds - marginals_seconds
                  - loop_t["candidate_search_seconds"]
                  - loop_t["icp_seconds"])
    profile = {
        "store_load_preprocess_seconds": round(store_seconds, 4),
        "solve_loop_seconds": round(seconds, 4),
        "optimize_seconds": round(optimize_seconds, 4),
        "loop_candidate_search_seconds":
            round(loop_t["candidate_search_seconds"], 4),
        "loop_icp_seconds": round(loop_t["icp_seconds"], 4),
        "loop_icp_dispatches": int(loop_t["icp_dispatches"]),
        "loop_icp_pairs": int(loop_t["icp_pairs"]),
        "marginals_seconds": round(marginals_seconds, 4),
        "host_other_seconds": round(host_other, 4),
        "poses": int(n),
        "optimizations": int(n_optimizations),
        "loop_closing_rounds": int(len(loop_closures)),
        "loop_closures_accepted": int(n_loops),
        "gps_factors": int(len(corr_indexes)),
        "solver": graph.auto_solver(),
        "method": method,
        "uncertainty_error": uncertainty_error,
        # record the ACTUAL mesh size (1 when no mesh was attached — a 0
        # "all devices" request that resolved to nothing must not be
        # echoed back as if a mesh had run; same fix as stage 1's profile)
        "mesh_devices": int(mesh.size) if mesh is not None else 1,
        "process_count": int(jax.process_count()),
        "store_scans_loaded_locally": int(store_loaded_locally),
        "store_reused_stage1": bool(store_reused),
        **compiles.report(),
    }
    write_error = csv_error
    if is_writer and write_error is None:
        try:
            os.makedirs(f"{directory}/robot0/viz", exist_ok=True)
            with open(f"{directory}/robot0/viz/graphslam_profile.json",
                      "w") as f:
                json.dump(profile, f, indent=2)
        except Exception as exc:
            write_error = exc
    if jax.process_count() > 1:
        # downstream stages (map viewer / diag) and callers read the
        # SLAM CSVs + profile: no process may return before the writer is
        # done — and a writer failure must reach the barrier first so
        # peers don't hang until the collective timeout (same contract as
        # stage 1's scanmatcher_csvs_written barrier)
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("graphslam_outputs_written")
    if write_error is not None:
        raise write_error
    return {"solution": solution_lidar, "scan_times": scan_times,
            "loop_closures": loop_closures, "n_loop_closures": n_loops,
            "gps_correspondences": corr_indexes,
            "store_scans_loaded_locally": int(store_loaded_locally),
            "seconds": seconds}


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p
