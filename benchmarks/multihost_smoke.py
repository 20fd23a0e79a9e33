"""MULTI-PROCESS multi-host validation of the distributed pipeline (CPU/gloo).

A CPU-only harness: every process runs on virtual CPU devices, and it
needs no accelerator.  One process drives all cards of a GPU host, so the
multi-GPU path is checked by ``chip_smoke.py --devices 4`` instead.

The virtual 8-device mesh (tests/conftest.py) proves sharding numerics but
runs in ONE process — it cannot catch multi-controller bugs (non-addressable
shards, per-host IO, process_allgather, jax.distributed bring-up).  This
script runs the REAL multi-host code path: MH_PROCS OS processes,
MH_LOCAL_DEVICES virtual CPU devices each, joined by jax.distributed over
localhost (Gloo collectives — the same JAX machinery a multi-host
accelerator job uses):

  1. parallel.multihost.initialize           (jax.distributed bring-up)
  2. run_scanmatcher(directory) — THE REAL CLI STAGE-1 ENTRY POINT — which
     under jax.process_count() > 1 loads only this host's scan block,
     assembles the global mesh-sharded stack, and dispatches the
     sharded-stack matcher (ppermute halo crosses the process boundary;
     results process_allgather-ed to every host, CSVs written by process 0)
  3. run_graphslam(directory) — THE REAL CLI STAGE-2 ENTRY POINT — whose
     full-resolution keyframe store also loads per-host (globally sharded
     tensors; loop-closure candidate ICPs run through a replicated-output
     jitted gather)
  4. run_graphslam AGAIN with cfg.mesh_devices=0: the pose graph carries
     the global mesh, auto_solver picks 'schur', and the distributed
     Schur elimination's psum CROSSES THE PROCESS BOUNDARY (r4 verdict
     weak-point 4: this path had never left one process)
  5. a distributed LM step over the global mesh (parallel/dist_solver.py)

Every process must reproduce the single-process stage-1 result (<=1e-4),
the replicated stage-2 solution (<=1e-3), the schur stage-2 solution
(<=3e-2 — independent f32 solver over a cond~1e8 system), load only
n_scans/P PCDs in BOTH stages, and the dense LM solve; the parent
additionally compares the multi-process CSVs against single-process.

Usage:  python benchmarks/multihost_smoke.py            # 2 procs x 4 devs
        MH_PROCS=4 MH_LOCAL_DEVICES=2 python benchmarks/multihost_smoke.py
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROCS = int(os.environ.get("MH_PROCS", 2))
LOCAL_DEVICES = int(os.environ.get("MH_LOCAL_DEVICES", 8 // N_PROCS))
GLOBAL_DEVICES = N_PROCS * LOCAL_DEVICES
N_SCANS = 16          # global devices x K scans/device, no padding
BATCH = 2


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def child(process_id: int, directory: str, port: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from lidar_slam_arvc_tpu.parallel import multihost
    topo = multihost.initialize(f"localhost:{port}", num_processes=N_PROCS,
                                process_id=process_id)
    assert topo["process_count"] == N_PROCS, topo
    assert topo["global_devices"] == GLOBAL_DEVICES, topo

    from jax.sharding import Mesh
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher
    from lidar_slam_arvc_tpu.utils.config import IcpConfig

    cfg = IcpConfig(raw_capacity=4096, capacity=4096, batch_size=BATCH,
                    max_iterations=15)
    pi = jax.process_index()

    # THE REAL CLI ENTRY POINT: run_scanmatcher detects process_count > 1
    # and takes the per-host-I/O + sharded-global-stack path itself
    out = run_scanmatcher(directory, cfg=cfg, progress=False)
    assert out["scans_loaded_locally"] == N_SCANS // N_PROCS, (
        f"proc {pi}: loaded {out['scans_loaded_locally']} scans, "
        f"expected its {N_SCANS // N_PROCS}-scan shard only")
    T = out["relative"]
    assert T.shape == (N_SCANS - 1, 4, 4)

    T_ref = np.load(f"{directory}/single_process_relative.npy")
    dev = float(np.abs(T - T_ref).max())
    assert dev < 1e-4, f"proc {pi}: stage-1 dev vs single-process {dev}"

    # stage 2 through the real entry point: per-host store loading +
    # sharded-store candidate ICPs + replicated graph solve
    from lidar_slam_arvc_tpu.pipeline.graphslam import run_graphslam
    out_g = run_graphslam(directory, cfg=cfg, progress=False)
    assert out_g["store_scans_loaded_locally"] == N_SCANS // N_PROCS, (
        f"proc {pi}: store loaded {out_g['store_scans_loaded_locally']}")
    sol = np.asarray(out_g["solution"])
    sol_ref = np.load(f"{directory}/single_process_solution.npy")
    dev_g = float(np.abs(sol[:, :3, 3] - sol_ref[:, :3, 3]).max())
    assert dev_g < 1e-3, f"proc {pi}: stage-2 dev vs single-process {dev_g}"

    # stage 2 AGAIN with the global mesh attached: auto_solver picks the
    # distributed Schur elimination, whose psum now crosses the process
    # boundary (cfg.mesh_devices=0 = all global devices)
    import dataclasses
    cfg_mesh = dataclasses.replace(cfg, mesh_devices=0)
    out_s = run_graphslam(directory, cfg=cfg_mesh, progress=False)
    import json as _json
    with open(f"{directory}/robot0/viz/graphslam_profile.json") as f:
        prof_s = _json.load(f)
    assert prof_s["solver"] == "schur", prof_s["solver"]
    sol_s = np.asarray(out_s["solution"])
    dev_s = float(np.abs(sol_s[:, :3, 3] - sol_ref[:, :3, 3]).max())
    # independent f32 solver over a cond~1e8 system: trajectories agree to
    # the conditioning floor (same bound as the distributed-LM check)
    assert dev_s < 3e-2, f"proc {pi}: schur stage-2 dev {dev_s}"

    mesh = Mesh(np.array(jax.devices()), ("data",))

    # distributed LM step across all processes (psum over gloo)
    import jax.numpy as jnp
    from lidar_slam_arvc_tpu.graph import PoseGraph
    from lidar_slam_arvc_tpu.graph.solver import graph_cost, lm_drive, solve_graph
    from lidar_slam_arvc_tpu.parallel import distributed_lm_step
    from lidar_slam_arvc_tpu.utils import synthetic

    rng = np.random.default_rng(4)
    n = 32
    T_gt = synthetic.make_trajectory(n, radius=5.0)
    gph = PoseGraph(max_poses=n, max_between=2 * n, max_gps=n)
    gph.init_graph()
    for i in range(n - 1):
        rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
        rel[:3, 3] += rng.normal(scale=0.03, size=3)
        gph.add_initial_estimate(rel, i + 1)
        gph.add_edge(rel, i, i + 1, "SM")
    gph.add_edge(np.linalg.inv(T_gt[2]) @ T_gt[n - 2], 2, n - 2, "SM")
    poses0 = jnp.asarray(gph.poses)
    fd = gph._factor_data()
    cost0 = float(graph_cost(poses0, fd))
    p_dense, c_dense = solve_graph(poses0, fd, gph.n_poses, max_iterations=8)
    p_dist, c_dist = lm_drive(
        lambda p, lam: distributed_lm_step(mesh, p, fd, gph.n_poses, lam=lam),
        poses0, cost0, max_iterations=8)
    dev_lm = float(np.abs(np.asarray(p_dist[:n, :3, 3])
                          - np.asarray(p_dense[:n, :3, 3])).max())
    assert float(c_dist) < 0.5 * cost0, (cost0, float(c_dist))
    # the two solvers are independent f32 paths over a cond~1e8 system:
    # their COSTS must agree tightly (same optimum), but the per-pose
    # trajectories may differ by the f32 conditioning floor (~1e-2 m here;
    # the same correlated-rounding trap as the r4 marginals test)
    assert abs(float(c_dist) - float(c_dense)) < 0.02 * max(
        float(c_dense), 1.0), (float(c_dense), float(c_dist))
    assert dev_lm < 3e-2, f"proc {pi}: distributed vs dense max|dt| {dev_lm}"

    print(json.dumps({"process": pi, "stage1_max_dev": dev,
                      "stage2_schur_max_dev": round(dev_s, 6),
                      "lm_cost": [round(cost0, 4), round(float(c_dist), 4)],
                      "lm_max_dt_vs_dense": round(dev_lm, 6), "ok": True}),
          flush=True)


def parent() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher
    from lidar_slam_arvc_tpu.utils import synthetic
    from lidar_slam_arvc_tpu.utils.config import IcpConfig

    assert N_SCANS % N_PROCS == 0, (N_SCANS, N_PROCS)
    with tempfile.TemporaryDirectory() as d:
        synthetic.make_dataset(
            d, n_scans=N_SCANS, seed=21, radius=7.0, scan_points=2500,
            scanmatcher_params={"voxel_size": 0.2, "method": "icppointplane",
                                "delta_time": 1.0, "start_index": 0},
            # loop closing ON: stage 2 must exercise the full-resolution
            # store (per-host loaded in the children)
            slam_params={"perform_loop_closing": True,
                         "radius_threshold": 5.0, "distance_backwards": 5.0,
                         "skip_loop_closing": 4, "skip_optimization": 4,
                         "number_of_triplets_loop_closing": 2})
        from lidar_slam_arvc_tpu.pipeline.graphslam import run_graphslam
        cfg0 = IcpConfig(raw_capacity=4096, capacity=4096, batch_size=BATCH,
                         max_iterations=15)
        out = run_scanmatcher(d, cfg=cfg0, progress=False)
        np.save(f"{d}/single_process_relative.npy", out["relative"])
        out_g = run_graphslam(d, cfg=cfg0, progress=False)
        np.save(f"{d}/single_process_solution.npy",
                np.asarray(out_g["solution"]))
        import shutil
        shutil.copy(f"{d}/robot0/scanmatcher/scanmatcher_relative.csv",
                    f"{d}/golden_relative.csv")

        port = int(os.environ.get("MH_PORT", 0)) or _free_port()
        env = dict(
            os.environ,
            XLA_FLAGS=f"--xla_force_host_platform_device_count="
                      f"{LOCAL_DEVICES}")
        # children write to files, not pipes: sequential pipe draining can
        # deadlock collective-synchronized processes on full buffers
        logs = [open(f"{d}/child{i}.log", "w+") for i in range(N_PROCS)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(i),
             d, str(port)],
            env=env, stdout=logs[i], stderr=subprocess.STDOUT, text=True)
            for i in range(N_PROCS)]
        try:
            for p in procs:
                p.wait(timeout=1800)
        finally:
            for p in procs:        # a hung child must not outlive the run
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        ok = all(p.returncode == 0 for p in procs)
        for i, o in enumerate(outs):
            for line in o.splitlines():
                if line.startswith("{"):
                    print(line)
        if not ok:
            for i, o in enumerate(outs):
                sys.stderr.write(f"--- child {i} ---\n{o}\n")
            return 1
        # the multi-process run's CSV (written by child process 0) must
        # match the single-process CSV
        import pandas as pd
        a = pd.read_csv(f"{d}/golden_relative.csv")
        b = pd.read_csv(f"{d}/robot0/scanmatcher/scanmatcher_relative.csv")
        assert list(a.columns) == list(b.columns)
        dev_csv = float(np.abs(a.to_numpy() - b.to_numpy()).max())
        assert dev_csv < 1e-4, f"CSV dev multi vs single process: {dev_csv}"
        print(json.dumps({"metric": "multihost_smoke", "processes": N_PROCS,
                          "global_devices": GLOBAL_DEVICES,
                          "csv_max_dev": dev_csv, "ok": True}))
        return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
    else:
        sys.exit(parent())
