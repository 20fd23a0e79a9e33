"""Stage 1: odometry-seeded sequential scan matching (batched on device).

Pipeline parity with reference run_scanmatcher.py:128-242 (scanmatcher):
read + time-sample LiDAR scans, associate odometry, seed each consecutive
pair's ICP with the relative odometry transform, fold the refined relative
transforms into a global trajectory, and write the three scanmatcher CSVs.

Device restructuring (SURVEY.md §2.3): the reference's sequential
per-pair loop (run_scanmatcher.py:196-213, one Open3D C++ call per pair)
becomes (a) batched preprocessing of all scans, (b) batched ICP over
``batch_size`` independent scan pairs per dispatch — the unit that
parallel.sharded_icp shards across a device mesh.
"""

from __future__ import annotations

import concurrent.futures
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu.cloud import from_numpy
from lidar_slam_arvc_tpu.geom.hostmath import transforms_from_pose_columns_np
from lidar_slam_arvc_tpu.io import EurocDataset, read_pcd, sample_times
from lidar_slam_arvc_tpu.io.formats import columns
from lidar_slam_arvc_tpu.pipeline.preprocess import preprocess_batch
from lidar_slam_arvc_tpu.registration import ICPParams, icp_batch, icp_two_planes
from lidar_slam_arvc_tpu.utils.config import IcpConfig


def prepare_experiment_data(euroc: EurocDataset, start_index: int,
                            delta_time: float):
    """Scan-time sampling + odometry/GPS association
    (reference run_scanmatcher.py:101-125)."""
    df_lidar = euroc.read_csv("/robot0/lidar/data.csv")
    scan_times = df_lidar["#timestamp [ns]"]
    scan_times = sample_times(scan_times, start_index=start_index,
                              delta_time=delta_time * 1e9)
    df_odo = euroc.read_csv("/robot0/odom/data.csv")
    odo_times = euroc.get_closest_times(
        scan_times, df_odo["#timestamp [ns]"])
    df_odo = euroc.get_df_at_times(df_odo, odo_times)
    try:
        df_gps = euroc.read_csv("/robot0/gps0/data.csv")
        gps_times = euroc.get_closest_times(
            scan_times, df_gps["#timestamp [ns]"])
        df_gps = euroc.get_df_at_times(df_gps, gps_times)
    except FileNotFoundError:
        gps_times, df_gps = None, None
    return scan_times, odo_times, gps_times, df_odo, df_gps


def relative_odometry(df_odo) -> np.ndarray:
    """(N-1,4,4) relative transforms from odometry rows
    (reference run_scanmatcher.py:92-98)."""
    T = transforms_from_pose_columns_np(
        columns(df_odo, ["x", "y", "z"]),
        columns(df_odo, ["qw", "qx", "qy", "qz"]))
    return np.einsum("nij,njk->nik", np.linalg.inv(T[:-1]), T[1:])


def load_scans(euroc: EurocDataset, scan_times, raw_capacity: int,
               max_workers: int = 4):
    """Read all PCDs into a padded (N, raw_capacity, 3) stack + mask.

    Uses the native threaded batch loader (native/pcd_native.cpp via
    io.native) for binary/compressed files, with a python fallback per file
    (ascii PCDs, parse failures, or no toolchain)."""
    return _load_paths([euroc.scan_pcd_path(t) for t in scan_times],
                       raw_capacity, max_workers)


def _load_paths(paths, raw_capacity: int, max_workers: int = 4):
    from lidar_slam_arvc_tpu.io import native

    n = len(paths)
    pts = mask = None
    if native.available():
        batch = native.read_pcd_batch(paths, raw_capacity)
        if batch is not None:
            pts, counts = batch
            mask = (np.arange(raw_capacity)[None, :] < counts[:, None])
            fallback = np.nonzero(counts < 0)[0]
        else:
            fallback = np.arange(n)
    else:
        fallback = np.arange(n)
    if pts is None:
        pts = np.zeros((n, raw_capacity, 3), dtype=np.float32)
        mask = np.zeros((n, raw_capacity), dtype=bool)

    if len(fallback):
        def load_one(i):
            c = from_numpy(read_pcd(paths[i]), raw_capacity)
            return i, np.asarray(c.points), np.asarray(c.mask)

        with concurrent.futures.ThreadPoolExecutor(
                max_workers=max_workers) as ex:
            for i, p, m in ex.map(load_one, fallback):
                pts[i] = p
                mask[i] = m
    return pts, mask


def preprocess_all(raw_pts, raw_mask, cfg: IcpConfig, method: str,
                   voxel_size, seed: int = 0):
    """Batched device preprocessing of all scans (static batch shape)."""
    n = raw_pts.shape[0]
    B = cfg.batch_size
    n_pad = (-n) % B
    if n_pad:
        raw_pts = np.concatenate([raw_pts, raw_pts[-1:].repeat(n_pad, 0)])
        raw_mask = np.concatenate([raw_mask, raw_mask[-1:].repeat(n_pad, 0)])
    keys = jax.random.split(jax.random.PRNGKey(seed), raw_pts.shape[0])

    outs = []
    for b in range(raw_pts.shape[0] // B):
        sl = slice(b * B, (b + 1) * B)
        out = preprocess_batch(jnp.asarray(raw_pts[sl]),
                               jnp.asarray(raw_mask[sl]), keys[sl],
                               cfg, method, voxel_size)
        outs.append(out)
    return _assemble_preprocessed(outs, n, cfg)


def load_and_preprocess_streamed(euroc: EurocDataset, scan_times,
                                 cfg: IcpConfig, method: str, voxel_size,
                                 seed: int = 0, chunk_scans: int | None = None):
    """Chunked PCD loading pipelined with device preprocessing.

    ``load_scans`` + ``preprocess_all`` serialize the two phases: every PCD
    is decoded before the first preprocess dispatch.  Here scans stream in
    chunks with ONE-CHUNK LOOKAHEAD — a single IO thread decodes chunk k+1
    (native batch loader) while the device preprocesses chunk k (JAX
    dispatches are asynchronous, so the Python thread is free to block on
    IO) — hiding whichever of host IO or device compute is cheaper.  Output
    is identical to the two-phase path (same per-scan programs, same keys).
    """
    B = cfg.batch_size
    if chunk_scans is None:
        chunk_scans = max(8 * B, 32)
    chunk_scans = -(-chunk_scans // B) * B
    paths = [euroc.scan_pcd_path(t) for t in scan_times]
    n = len(paths)
    n_pad = (-n) % B
    keys = jax.random.split(jax.random.PRNGKey(seed), n + n_pad)
    chunks = [paths[i: i + chunk_scans] for i in range(0, n, chunk_scans)]

    outs = []
    base = 0
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(_load_paths, chunks[0], cfg.raw_capacity)
        for ci in range(len(chunks)):
            pts, mask = fut.result()
            if ci + 1 < len(chunks):
                fut = ex.submit(_load_paths, chunks[ci + 1],
                                cfg.raw_capacity)
            if ci == len(chunks) - 1 and n_pad:
                pts = np.concatenate([pts, pts[-1:].repeat(n_pad, 0)])
                mask = np.concatenate([mask, mask[-1:].repeat(n_pad, 0)])
            for b in range(pts.shape[0] // B):
                sl = slice(b * B, (b + 1) * B)
                outs.append(preprocess_batch(
                    jnp.asarray(pts[sl]), jnp.asarray(mask[sl]),
                    keys[base + b * B: base + (b + 1) * B],
                    cfg, method, voxel_size))
            base += pts.shape[0]
    return _assemble_preprocessed(outs, n, cfg)


def _assemble_preprocessed(outs, n, cfg: IcpConfig):
    cat = lambda xs: jnp.concatenate(xs, axis=0)[:n]
    points = cat([o.points for o in outs])
    mask = cat([o.mask for o in outs])
    normals = cat([o.normals for o in outs])
    g = (cat([o.ground_mask for o in outs])
         if outs[0].ground_mask is not None else None)
    ng = (cat([o.nonground_mask for o in outs])
          if outs[0].nonground_mask is not None else None)
    n_vox = np.asarray(cat([o.n_voxels for o in outs]))
    overflow = np.maximum(n_vox - cfg.capacity, 0)
    if overflow.any():
        # never silent: the densest-tail voxels were dropped (cloud/voxel.py)
        print(f"WARNING: {int((overflow > 0).sum())}/{n} scans exceed "
              f"capacity {cfg.capacity} (max occupied voxels "
              f"{int(n_vox.max())}, {int(overflow.sum())} voxels dropped) — "
              f"raise IcpConfig.capacity or coarsen voxel_size")
    return points, mask, normals, g, ng, overflow


import functools


def _match_groups(points, mask, normals, idx_src, idx_tgt, seeds,
                  params, method, batch):
    """lax.map over batch-size groups of icp_batch (gathers into the full
    scan stack by index).  Shared body of the fused single-device program
    and the per-device shard of the mesh program."""
    gs = idx_src.reshape(-1, batch)
    gt = idx_tgt.reshape(-1, batch)
    gseeds = seeds.reshape(-1, batch, 4, 4)

    def per_group(args):
        si, ti, sd = args
        res = icp_batch(points[si], mask[si], points[ti], mask[ti],
                        normals[ti], sd, params, method)
        return res.transform, res.fitness, res.iterations, res.final_delta

    T, fit, iters, delta = jax.lax.map(per_group, (gs, gt, gseeds))
    return (T.reshape(-1, 4, 4), fit.reshape(-1), iters.reshape(-1),
            delta.reshape(-1))


@functools.partial(jax.jit, static_argnames=("params", "method", "batch"))
def _match_all_fused(points, mask, normals, idx_src, idx_tgt, seeds,
                     params, method, batch):
    """All scan pairs in one program: lax.map over batch groups of icp_batch."""
    return _match_groups(points, mask, normals, idx_src, idx_tgt, seeds,
                         params, method, batch)


@functools.lru_cache(maxsize=8)
def _mesh_matcher(mesh, params, method, batch, axis="data"):
    """Jitted shard_map matcher: the pair list sharded over the mesh's
    ``data`` axis, the scan stack replicated, each device lax.map-ing its
    own batch groups (SURVEY.md §2.3 row 1 — data parallelism over scan
    pairs replacing the reference's sequential loop,
    run_scanmatcher.py:196-213).  One dispatch for the whole stage, D-way
    parallel."""
    from jax.sharding import PartitionSpec as P

    def local(points, mask, normals, idx_src, idx_tgt, seeds):
        return _match_groups(points, mask, normals, idx_src, idx_tgt, seeds,
                             params, method, batch)

    # check_vma=False: the ICP while_loop carries start replicated and
    # become device-varying, which the static varying-axes checker rejects;
    # the body is ordinary per-device code with no collectives, so the
    # check has nothing to protect here.
    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis), P(axis)),
        out_specs=(P(axis),) * 4, check_vma=False)
    return jax.jit(fn)


@functools.lru_cache(maxsize=8)
def _mesh_matcher_sharded(mesh, params, method, batch, axis="data"):
    """Jitted shard_map matcher with the SCAN STACK sharded over the mesh.

    The replicated-stack matcher above is right when n_scans x capacity fits
    every device; for long trajectories the stack itself must shard.  Layout:
    device d holds the contiguous scans [d*K, (d+1)*K) and owns the K pairs
    whose TARGET scan it holds.  The only remote datum is each device's last
    pair's source — the NEXT device's first scan — fetched with one
    ``ppermute`` halo exchange (the cyclic wrap row feeds a self-pair that is
    discarded).  Communication is one scan per device per stage, O(capacity),
    independent of trajectory length; everything else is local exactly like
    the replicated path (SURVEY.md §2.3 row 2's "gather only what the pair
    needs", here static and compiler-scheduled over ICI).
    """
    from jax.sharding import PartitionSpec as P
    D = mesh.shape[axis]
    # device d receives the first local row of device d+1 (cyclic)
    perm = [((d + 1) % D, d) for d in range(D)]

    def local(points, mask, normals, idx_src, idx_tgt, seeds):
        halo_p = jax.lax.ppermute(points[:1], axis, perm)
        halo_m = jax.lax.ppermute(mask[:1], axis, perm)
        halo_n = jax.lax.ppermute(normals[:1], axis, perm)
        pts = jnp.concatenate([points, halo_p])
        msk = jnp.concatenate([mask, halo_m])
        nrm = jnp.concatenate([normals, halo_n])
        return _match_groups(pts, msk, nrm, idx_src, idx_tgt, seeds,
                             params, method, batch)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis),) * 6, out_specs=(P(axis),) * 4, check_vma=False)
    return jax.jit(fn)


def _to_host(*arrays):
    """Mesh-sharded device results -> full host arrays on every process.

    Single-process (incl. the virtual CPU mesh): plain transfers.  Multi-host
    (jax.distributed): shards living on other processes are not addressable,
    so all-gather them first — ONE collective for all arrays (each gather is
    a blocking cross-process round-trip) — and every host gets the full
    result, matching the reference's single-host output contract."""
    import jax
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        arrays = multihost_utils.process_allgather(tuple(arrays), tiled=True)
    return tuple(np.asarray(a) for a in arrays)


def _sharded_stack_dispatch(mesh, points, mask, normals, T_seeds, params,
                            icp_method, B):
    """Host-side layout for _mesh_matcher_sharded: pad scans to D*K, build
    device-LOCAL pair indices (self-pairs for padding — they converge on the
    first early-exit check), shard, dispatch.  Returns (T, fit, delta)
    truncated to the real pairs."""
    D = mesh.size
    n_scans = points.shape[0]
    n_pairs = n_scans - 1
    K = -(-n_scans // (D * B)) * B          # scans (= pairs) per device
    pad_s = D * K - n_scans

    def pad(a):
        return (jnp.concatenate([a, jnp.repeat(a[-1:], pad_s, axis=0)])
                if pad_s else a)

    glob = np.arange(D * K)
    tgt_local = np.tile(np.arange(K), D)
    # local source = target + 1 (index K = the halo row) for real pairs;
    # padding pairs (incl. the cyclic-wrap row) are self-pairs
    src_local = tgt_local + (glob < n_pairs)
    seeds = np.tile(np.eye(4, dtype=np.float32), (D * K, 1, 1))
    seeds[:n_pairs] = T_seeds.astype(np.float32)

    matcher = _mesh_matcher_sharded(mesh, params, icp_method, B)
    T_all, fit, _, delta = matcher(
        pad(points), pad(mask), pad(normals), jnp.asarray(src_local),
        jnp.asarray(tgt_local), jnp.asarray(seeds))
    T_all, fit, delta = _to_host(T_all, fit, delta)
    return (T_all.astype(np.float64)[:n_pairs], fit[:n_pairs],
            delta[:n_pairs])


def match_consecutive(points, mask, normals, T_seeds: np.ndarray,
                      cfg: IcpConfig, method: str,
                      ground_mask=None, nonground_mask=None,
                      progress: bool = True,
                      checkpoint_path: str | None = None,
                      checkpoint_key: int | None = None) -> np.ndarray:
    """Batched ICP over consecutive pairs; returns (N-1,4,4) refined T_i_i+1.

    Source = scan i+1, target = scan i (reference keyframemanager.py:52-75
    direction: result maps source j into target i's frame).

    With ``checkpoint_path``, completed batches are persisted after each
    dispatch and a matching checkpoint (same ``checkpoint_key``, derived
    from the scan times) resumes mid-stage — finer-grained than the
    reference's stage-level CSV durability (SURVEY.md §5).
    """
    n_pairs = points.shape[0] - 1
    B = cfg.batch_size
    params = ICPParams(
        max_correspondence_distance=cfg.distance_threshold,
        max_iterations=cfg.max_iterations,
        source_stride=cfg.source_stride)
    icp_method = ("point_to_point" if method == "icppointpoint"
                  else "point_to_plane")

    from lidar_slam_arvc_tpu.parallel.mesh import resolve_mesh
    mesh = (resolve_mesh(cfg.mesh_devices)
            if method in ("icppointplane", "icppointpoint") else None)

    # pad the pair list to a batch multiple with self-pairs (discarded);
    # under a mesh every device needs the same number of whole groups
    pad = (-n_pairs) % (B * (mesh.size if mesh is not None else 1))
    idx_src = np.concatenate([np.arange(1, n_pairs + 1),
                              np.full(pad, n_pairs)])
    idx_tgt = np.concatenate([np.arange(0, n_pairs),
                              np.full(pad, n_pairs)])
    seeds = np.concatenate(
        [T_seeds, np.tile(np.eye(4), (pad, 1, 1))]).astype(np.float32)

    # Fast path: without checkpointing, plain ICP methods run the WHOLE
    # stage as one device dispatch (lax.map over batch groups inside jit).
    # One program saves a dispatch and host sync per batch and gives XLA
    # the full pipeline to overlap.
    if (checkpoint_path is None
            and method in ("icppointplane", "icppointpoint")):
        if mesh is not None and cfg.shard_scans:
            T_all, fit, delta = _sharded_stack_dispatch(
                mesh, points, mask, normals, T_seeds, params, icp_method, B)
        elif mesh is not None:
            matcher = _mesh_matcher(mesh, params, icp_method, B)
            T_all, fit, _, delta = matcher(
                points, mask, normals, jnp.asarray(idx_src),
                jnp.asarray(idx_tgt), jnp.asarray(seeds))
            T_all, fit, delta = _to_host(T_all, fit, delta)
            T_all = T_all.astype(np.float64)[:n_pairs]
            fit = fit[:n_pairs]
            delta = delta[:n_pairs]
        else:
            T_all, fit, _, delta = _match_all_fused(
                points, mask, normals, jnp.asarray(idx_src),
                jnp.asarray(idx_tgt), jnp.asarray(seeds), params,
                icp_method, B)
            T_all = np.asarray(T_all, dtype=np.float64)[:n_pairs]
            fit = np.asarray(fit)[:n_pairs]
            delta = np.asarray(delta)[:n_pairs]
        # fallback gate: low inlier fraction, or still moving by >=100x the
        # convergence tol when max_iterations ran out (with carried metrics
        # the fitness predates the last update, so divergence on the final
        # iteration is caught by final_delta, not fitness)
        bad = fit < cfg.min_fitness
        if params.convergence_tol > 0:
            bad |= delta > 100 * params.convergence_tol
        if bad.any():
            T_all[bad] = seeds[:n_pairs][bad].astype(np.float64)
        if progress:
            tag = ("fused dispatch" if mesh is None else
                   f"mesh dispatch, {mesh.size} devices"
                   + (", sharded scan stack" if cfg.shard_scans else ""))
            print(f"scanmatch pairs {n_pairs}/{n_pairs} ({tag})")
        return T_all

    out = np.empty((n_pairs, 4, 4), dtype=np.float64)
    start_batch = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        try:
            ck = np.load(checkpoint_path)
            if (int(ck["key"]) == int(checkpoint_key)
                    and int(ck["n_pairs"]) == n_pairs
                    and int(ck["batch_size"]) == B):
                done = int(ck["batches_done"])
                out[: min(done * B, n_pairs)] = ck["transforms"][
                    : min(done * B, n_pairs)]
                start_batch = done
                if progress:
                    print(f"resuming scanmatch from batch {done} "
                          f"({min(done * B, n_pairs)}/{n_pairs} pairs)")
        except Exception:
            pass  # unreadable checkpoint: recompute from scratch

    t0 = time.time()
    for b in range(start_batch, len(idx_src) // B):
        sl = slice(b * B, (b + 1) * B)
        si, ti = idx_src[sl], idx_tgt[sl]
        if method == "fpfh":
            from lidar_slam_arvc_tpu.cloud import Cloud
            from lidar_slam_arvc_tpu.registration.global_reg import (
                GlobalRegParams, global_registration)
            gp = GlobalRegParams(fpfh_radius=cfg.fpfh_radius, icp=params)
            keys = jax.random.split(jax.random.PRNGKey(b), B)

            def one(sp, sm, sngm, tp, tm, tngm, tn, sn, key):
                return global_registration(
                    Cloud(sp, sm, sn), Cloud(tp, tm, tn), key, gp,
                    src_nonground=Cloud(sp, sngm, sn),
                    tgt_nonground=Cloud(tp, tngm, tn))
            res = jax.vmap(one)(points[si], mask[si], nonground_mask[si],
                                points[ti], mask[ti], nonground_mask[ti],
                                normals[ti], normals[si], keys)
        elif method == "icp2planes":
            def one(sp, sgm, sngm, tp, tgm, tngm, tn, sn, T0):
                from lidar_slam_arvc_tpu.cloud import Cloud
                return icp_two_planes(
                    Cloud(sp, sgm, sn), Cloud(tp, tgm, tn),
                    Cloud(sp, sngm, sn), Cloud(tp, tngm, tn), T0, params)
            res = jax.vmap(one)(points[si], ground_mask[si],
                                nonground_mask[si], points[ti],
                                ground_mask[ti], nonground_mask[ti],
                                normals[ti], normals[si],
                                jnp.asarray(seeds[sl]))
        else:
            res = icp_batch(points[si], mask[si], points[ti], mask[ti],
                            normals[ti], jnp.asarray(seeds[sl]),
                            params, icp_method)
        Tb = np.asarray(res.transform, dtype=np.float64)
        fit = np.asarray(res.fitness)
        # failure detection: diverged/void registrations fall back to the
        # odometry seed rather than corrupting the trajectory (final_delta
        # catches divergence on the last iteration, which carried metrics
        # cannot — see ICPParams.exact_metrics)
        bad = fit < cfg.min_fitness
        if params.convergence_tol > 0:
            bad |= np.asarray(res.final_delta) > 100 * params.convergence_tol
        if bad.any():
            Tb[bad] = seeds[sl][bad].astype(np.float64)
        hi = min((b + 1) * B, n_pairs)
        out[b * B:hi] = Tb[: hi - b * B]
        if checkpoint_path is not None:
            np.savez(checkpoint_path, key=checkpoint_key, n_pairs=n_pairs,
                     batch_size=B, batches_done=b + 1, transforms=out)
        if progress:
            done = hi
            dt = time.time() - t0
            print(f"\rscanmatch pairs {done}/{n_pairs} "
                  f"({done / max(dt, 1e-9):.1f} pairs/s)", end="")
    if progress:
        print()
    return out


def run_scanmatcher(directory: str, cfg: IcpConfig | None = None,
                    progress: bool = True,
                    return_preprocessed: bool = False) -> dict:
    """Full stage 1; writes the scanmatcher CSVs and returns the trajectory.

    ``return_preprocessed=True`` additionally returns the preprocessed scan
    tensors under the ``"preprocessed"`` key so a fused two-stage run
    (``slam run``, benchmarks) can hand them to
    ``run_graphslam(preprocessed=...)`` instead of re-loading and
    re-preprocessing every scan — the in-memory execution mode of the
    two-stage contract (SURVEY §2.3 row 5; the reference always round-trips
    through the filesystem, automate.sh:14-15).  Holding the tensors keeps
    them alive in HBM, hence opt-in.
    """
    from lidar_slam_arvc_tpu.utils.profiling import CompileCounter
    compiles = CompileCounter()
    with compiles.scope():
        return _run_scanmatcher(directory, cfg, progress, compiles,
                                return_preprocessed)


def _run_scanmatcher(directory, cfg, progress, compiles,
                     return_preprocessed=False):
    euroc = EurocDataset(directory)
    params = euroc.read_scanmatcher_parameters()
    start_index = params.get("start_index", 0)
    delta_time = params.get("delta_time", 0.5)
    voxel_size = params.get("voxel_size", None)
    method = params.get("method", "icppointplane")
    if cfg is None:
        cfg = IcpConfig()

    scan_times, _, _, df_odo, _ = prepare_experiment_data(
        euroc, start_index, delta_time)
    rel_odo = relative_odometry(df_odo)
    n = len(scan_times)

    # Multi-controller run (jax.distributed): per-host I/O.  Each process
    # loads and preprocesses ONLY its contiguous scan block; the global
    # stack is assembled as a mesh-sharded jax.Array and stage 1 runs the
    # sharded-stack matcher (the ppermute halo covers shard-boundary pairs,
    # so no overlap scan is loaded twice).  This is SURVEY §2.3 row 2 as a
    # pipeline property — the reference's analogue is the in-RAM keyframe
    # list + manual unload (keyframemanager.py:15,30, run_scanmatcher.py:213).
    multihost_mode = (jax.process_count() > 1
                      and method in ("icppointplane", "icppointpoint"))
    n_loaded_locally = n
    t_load = time.time()
    if multihost_mode:
        import dataclasses

        from jax.experimental import multihost_utils
        from lidar_slam_arvc_tpu.parallel import multihost as mh
        from lidar_slam_arvc_tpu.parallel.mesh import data_mesh
        # mid-stage checkpoints are per-process files and would race; the
        # stage-level CSV durability contract still holds
        cfg = dataclasses.replace(cfg, mesh_devices=0, shard_scans=True,
                                  checkpoint_batches=0)
        mesh = data_mesh()
        D, B = mesh.size, cfg.batch_size
        # pad the SCAN LIST with copies of the last scan so the global
        # stack is an exact (devices x batch) multiple: padding rows form
        # identity-seeded self-pairs that are computed and discarded
        K = -(-n // (D * B)) * B
        n_total = D * K
        times_padded = np.concatenate(
            [scan_times, np.repeat(scan_times[-1:], n_total - n)])
        pc = jax.process_count()
        bounds = np.linspace(0, n_total, pc + 1).astype(int)
        lo, hi = int(bounds[jax.process_index()]), \
            int(bounds[jax.process_index() + 1])
        n_loaded_locally = hi - lo
        pts_l, mask_l, normals_l, _, _, ovf_l = load_and_preprocess_streamed(
            euroc, times_padded[lo:hi], cfg, method, voxel_size)
        glob = mh.assemble_global_scans(
            mesh, {"points": np.asarray(pts_l), "mask": np.asarray(mask_l),
                   "normals": np.asarray(normals_l)}, n_total)
        points, mask, normals = (glob["points"], glob["mask"],
                                 glob["normals"])
        g = ng = None
        overflow = multihost_utils.process_allgather(
            np.asarray(ovf_l), tiled=True)[:n]
        rel_odo = np.concatenate(
            [rel_odo, np.tile(np.eye(4), (n_total - n, 1, 1))])
    else:
        points, mask, normals, g, ng, overflow = load_and_preprocess_streamed(
            euroc, scan_times, cfg, method, voxel_size)
    preprocess_seconds = time.time() - t_load
    if progress:
        print(f"loaded+preprocessed {n_loaded_locally} scans "
              f"{'locally ' if multihost_mode else ''}"
              f"in {preprocess_seconds:.2f}s")

    t_icp = time.time()
    if cfg.checkpoint_batches > 0:
        ck_dir = f"{directory}/robot0/scanmatcher"
        os.makedirs(ck_dir, exist_ok=True)
        ck_path = f"{ck_dir}/checkpoint.npz"
        ck_key = int(np.int64(np.sum(scan_times)) & 0x7FFFFFFF)
    else:
        ck_path, ck_key = None, None
    rel_sm = match_consecutive(points, mask, normals, rel_odo, cfg, method,
                               ground_mask=g, nonground_mask=ng,
                               progress=progress,
                               checkpoint_path=ck_path,
                               checkpoint_key=ck_key)[: n - 1]
    icp_seconds = time.time() - t_icp
    # stage complete: remove the mid-stage checkpoint
    if ck_path is not None:
        try:
            os.remove(ck_path)
        except FileNotFoundError:
            pass

    # fold to global in float64 on host (long-trajectory accuracy; cheap)
    T_global = np.empty((len(rel_sm) + 1, 4, 4))
    T_global[0] = np.eye(4)
    for i, Tij in enumerate(rel_sm):
        T_global[i + 1] = T_global[i] @ Tij

    # per-stage profile artifact (utils/profiling.py; SURVEY.md §5)
    import json
    profile = {
        "load_preprocess_seconds": round(preprocess_seconds, 4),
        "icp_seconds": round(icp_seconds, 4),
        "pairs": int(len(rel_sm)),
        "frames_per_second": round(len(rel_sm) / max(icp_seconds, 1e-9), 3),
        # capacity accounting (never silent — cloud/voxel.py drops the tail
        # when a scan's occupied voxels exceed IcpConfig.capacity)
        "capacity": int(cfg.capacity),
        "scans_over_capacity": int((overflow > 0).sum()),
        "voxels_dropped_total": int(overflow.sum()),
        # multihost runs replace cfg.mesh_devices with the 0 ("all
        # devices") sentinel; record the ACTUAL mesh size
        "mesh_devices": int(mesh.size) if multihost_mode
        else int(cfg.mesh_devices),
        "shard_scans": bool(cfg.shard_scans),
        "process_count": int(jax.process_count()),
        "scans_loaded_locally": int(n_loaded_locally),
        # distinct-program accounting (compilation is the dominant
        # one-time cost of a run)
        **compiles.report(),
    }
    # multi-controller runs share the dataset directory: one writer
    write_error = None
    if jax.process_index() == 0:
        try:
            euroc.save_sensor_times_as_csv(
                scan_times, "/robot0/scanmatcher/lidar_times.csv")
            euroc.save_transforms_as_csv(
                scan_times, rel_sm,
                "/robot0/scanmatcher/scanmatcher_relative.csv")
            euroc.save_transforms_as_csv(
                scan_times, T_global,
                "/robot0/scanmatcher/scanmatcher_global.csv")
            os.makedirs(f"{directory}/robot0/viz", exist_ok=True)
            with open(f"{directory}/robot0/viz/scanmatcher_profile.json",
                      "w") as f:
                json.dump(profile, f, indent=2)
        except Exception as exc:
            # a writer failure must not leave the other processes hanging
            # in the barrier until the collective timeout — reach it, then
            # re-raise (non-writers fail fast on the missing CSVs instead)
            write_error = exc
    if jax.process_count() > 1:
        # other processes must not race ahead into stage 2 (which READS
        # these CSVs) before the writer finishes
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("scanmatcher_csvs_written")
    if write_error is not None:
        raise write_error
    out = {"scan_times": scan_times, "relative": rel_sm,
           "global": T_global, "icp_seconds": icp_seconds,
           "scans_loaded_locally": int(n_loaded_locally),
           "frames_per_second": profile["frames_per_second"]}
    if return_preprocessed and not multihost_mode:
        # config fingerprint travels with the tensors so run_graphslam can
        # verify the stage-2 store wants the same preprocessing
        out["preprocessed"] = {
            "points": points, "mask": mask, "normals": normals,
            "ground_mask": g, "nonground_mask": ng,
            "scan_times": scan_times, "voxel_size": voxel_size,
            "method": method,
            # EVERY cfg field the preprocessing consumed must travel in
            # the fingerprint, or a stage-2 cfg mismatch would silently
            # reuse differently cropped/truncated/normal-estimated clouds
            "capacity": int(cfg.capacity),
            "raw_capacity": int(cfg.raw_capacity),
            "crop": (float(cfg.min_radius), float(cfg.max_radius),
                     float(cfg.min_height), float(cfg.max_height)),
            "normal_radius": float(cfg.normal_radius)}
    return out
