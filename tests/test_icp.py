"""ICP registration tests on synthetic world renders."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu import cloud as cl
from lidar_slam_arvc_tpu import geom
from lidar_slam_arvc_tpu.registration import ICPParams, icp, icp_batch, icp_two_planes
from lidar_slam_arvc_tpu.utils import synthetic

CAP = 4096
PARAMS = ICPParams(max_correspondence_distance=5.0, max_iterations=25,
                   src_block=512, tgt_block=512)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(42)
    world = synthetic.make_world(rng, extent=20.0, n_ground=6000,
                                 n_pillars=20, pillar_pts=300)
    T_i = synthetic._yaw_T(0.0, 0.0, 0.0)
    T_j = synthetic._yaw_T(0.6, 0.25, 0.08)  # ground-truth pose of scan j
    scan_i = synthetic.render_scan(world, T_i, rng, max_points=3500)
    scan_j = synthetic.render_scan(world, T_j, rng, max_points=3500)
    # T_i_j maps scan j points into scan i's frame
    T_ij_gt = np.linalg.inv(T_i) @ T_j
    return scan_i, scan_j, T_ij_gt


def prep(scan, with_normals=True):
    c = cl.from_numpy(scan, CAP)
    c = cl.crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
    c = cl.voxel_downsample(c, 0.15)
    if with_normals:
        c = cl.estimate_normals(c, radius=0.4)
    return c


def pose_err(T_est, T_gt):
    delta = np.linalg.inv(np.asarray(T_est)) @ T_gt
    dpos = np.linalg.norm(delta[:3, 3])
    drot = np.arccos(np.clip((np.trace(delta[:3, :3]) - 1) / 2, -1, 1))
    return dpos, drot


class TestPointToPlane:
    def test_recovers_transform(self, scene):
        scan_i, scan_j, T_ij_gt = scene
        ci = prep(scan_i)
        cj = prep(scan_j)
        # seed with a perturbed initial guess (odometry-like error)
        T0 = T_ij_gt @ synthetic._yaw_T(0.1, -0.08, 0.03)
        res = icp(cj, ci, jnp.asarray(T0, dtype=jnp.float32), PARAMS,
                  "point_to_plane")
        dpos, drot = pose_err(res.transform, T_ij_gt)
        assert dpos < 0.05, f"position error {dpos}"
        assert drot < 0.01, f"rotation error {drot}"
        assert float(res.fitness) > 0.8

    @pytest.mark.parametrize("stride", [2, 4])
    def test_source_stride_recovers_transform(self, scene, stride):
        # persistent source subsampling must not cost meaningful accuracy:
        # the solve stays overdetermined (thousands of correspondences for
        # 6 DOF) and the voxel grid decorrelates neighbors
        scan_i, scan_j, T_ij_gt = scene
        ci = prep(scan_i)
        cj = prep(scan_j)
        T0 = T_ij_gt @ synthetic._yaw_T(0.1, -0.08, 0.03)
        params = PARAMS._replace(source_stride=stride)
        res = icp(cj, ci, jnp.asarray(T0, dtype=jnp.float32), params,
                  "point_to_plane")
        dpos, drot = pose_err(res.transform, T_ij_gt)
        assert dpos < 0.06, f"stride {stride}: position error {dpos}"
        assert drot < 0.012, f"stride {stride}: rotation error {drot}"
        assert float(res.fitness) > 0.8

    def test_identity_when_same_cloud(self, scene):
        scan_i, _, _ = scene
        c = prep(scan_i)
        res = icp(c, c, jnp.eye(4), PARAMS, "point_to_plane")
        dpos, drot = pose_err(res.transform, np.eye(4))
        assert dpos < 1e-3 and drot < 1e-3
        assert float(res.inlier_rmse) < 1e-3


class TestPointToPoint:
    def test_recovers_transform(self, scene):
        scan_i, scan_j, T_ij_gt = scene
        ci = prep(scan_i, with_normals=False)
        cj = prep(scan_j, with_normals=False)
        T0 = T_ij_gt @ synthetic._yaw_T(0.08, -0.05, 0.02)
        res = icp(cj, ci, jnp.asarray(T0, dtype=jnp.float32), PARAMS,
                  "point_to_point")
        dpos, drot = pose_err(res.transform, T_ij_gt)
        assert dpos < 0.08, f"position error {dpos}"
        assert drot < 0.015, f"rotation error {drot}"


class TestTwoPlanes:
    def test_recovers_transform(self, scene):
        scan_i, scan_j, T_ij_gt = scene
        ci = prep(scan_i)
        cj = prep(scan_j)
        plane_i = cl.ransac_ground_plane(ci, jax.random.PRNGKey(1),
                                         seed_height=-0.5)
        plane_j = cl.ransac_ground_plane(cj, jax.random.PRNGKey(2),
                                         seed_height=-0.5)
        gi, ngi = cl.split_by_plane(ci, plane_i, 0.4)
        gj, ngj = cl.split_by_plane(cj, plane_j, 0.4)
        # re-estimate normals on the splits like the reference
        # (keyframe.py:184-189) — mask-only splits reuse buffers, so just
        # reuse the full-cloud normals here.
        T0 = T_ij_gt @ synthetic._yaw_T(0.08, -0.05, 0.02)
        res = icp_two_planes(gj, gi, ngj, ngi,
                             jnp.asarray(T0, dtype=jnp.float32), PARAMS)
        dpos, drot = pose_err(res.transform, T_ij_gt)
        assert dpos < 0.1, f"position error {dpos}"
        assert drot < 0.02, f"rotation error {drot}"


class TestBatched:
    def test_batch_matches_single(self, scene):
        scan_i, scan_j, T_ij_gt = scene
        ci = prep(scan_i)
        cj = prep(scan_j)
        T0 = jnp.asarray(T_ij_gt @ synthetic._yaw_T(0.05, 0.05, 0.02),
                         dtype=jnp.float32)
        single = icp(cj, ci, T0, PARAMS, "point_to_plane")

        B = 2
        stack = lambda x: jnp.stack([x] * B)
        batch = icp_batch(stack(cj.points), stack(cj.mask),
                          stack(ci.points), stack(ci.mask),
                          stack(ci.normals), stack(T0),
                          PARAMS, "point_to_plane")
        np.testing.assert_allclose(np.asarray(batch.transform[0]),
                                   np.asarray(single.transform), atol=1e-4)
        np.testing.assert_allclose(np.asarray(batch.transform[1]),
                                   np.asarray(batch.transform[0]), atol=1e-6)

    def test_batch_jit_compiles_once(self, scene):
        scan_i, scan_j, _ = scene
        ci = prep(scan_i)
        cj = prep(scan_j)
        f = jax.jit(lambda *a: icp_batch(*a, PARAMS, "point_to_plane"))
        B = 3
        stack = lambda x: jnp.stack([x] * B)
        out = f(stack(cj.points), stack(cj.mask), stack(ci.points),
                stack(ci.mask), stack(ci.normals), stack(jnp.eye(4)))
        assert out.transform.shape == (B, 4, 4)


class TestKernelPick:
    """ops.select: the Triton kernels where the program is lowered for a
    CUDA GPU, the plain XLA sweeps elsewhere, never the interpreter."""

    @staticmethod
    def _lowered(fn, args, platform):
        return jax.jit(fn).trace(*args).lower(
            lowering_platforms=(platform,)).as_text()

    @staticmethod
    def _pair(n=200):
        rng = np.random.default_rng(1)
        pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        return jnp.asarray(pts), jnp.ones(n, dtype=bool)

    @pytest.mark.parametrize("platform,kernel_expected",
                             [("cuda", True), ("cpu", False)])
    def test_icp_correspondences(self, platform, kernel_expected):
        pts, mask = self._pair()
        nrm = jnp.zeros_like(pts)
        stack = lambda x: jnp.stack([x, x])
        args = (stack(pts), stack(mask), stack(pts), stack(mask),
                stack(nrm), stack(jnp.eye(4)))
        txt = self._lowered(
            lambda *a: icp_batch(*a, PARAMS, "point_to_plane"), args,
            platform)
        assert ('name = "nn_sweep"' in txt) is kernel_expected
        assert ("xla.gpu.triton" in txt) is kernel_expected

    @pytest.mark.parametrize("platform,kernel_expected",
                             [("cuda", True), ("cpu", False)])
    def test_normals(self, platform, kernel_expected):
        pts, mask = self._pair()
        txt = self._lowered(
            lambda p, m: cl.estimate_normals(cl.Cloud(p, m), 0.5).normals,
            (pts, mask), platform)
        assert ('name = "ball_moments"' in txt) is kernel_expected
        assert ("xla.gpu.triton" in txt) is kernel_expected

    def test_cpu_results_are_the_xla_sweep(self):
        from lidar_slam_arvc_tpu.ops import nearest_neighbors, nn_search
        pts, mask = self._pair()
        src = pts[::-1] * 1.01
        i1, d1 = nearest_neighbors(src, pts, mask, src_block=64,
                                   tgt_block=64)
        i2, d2 = nn_search(src, pts, mask, src_block=64, tgt_block=64)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))

    def test_point_to_plane_runs_on_cpu(self):
        rng = np.random.default_rng(2)
        tgt_pts = rng.uniform(-3, 3, (200, 3)).astype(np.float32)
        T_gt = synthetic._yaw_T(0.15, 0.08, 0.04)
        src_pts = (tgt_pts - T_gt[:3, 3]) @ T_gt[:3, :3]
        ct = cl.estimate_normals(cl.from_numpy(tgt_pts, 256), radius=1.5)
        cs = cl.from_numpy(src_pts.astype(np.float32), 256)
        params = ICPParams(max_correspondence_distance=2.0, max_iterations=6,
                           src_block=64, tgt_block=64)
        res = icp(cs, ct, jnp.eye(4, dtype=jnp.float32), params,
                  "point_to_plane")
        dpos, drot = pose_err(res.transform, T_gt)
        assert dpos < 0.05 and drot < 0.02


class TestEvaluateOnly:
    def test_max_iterations_zero_reports_seed_metrics(self, rng):
        # max_iterations=0 = Open3D evaluate_registration: metrics at T_init
        import jax.numpy as jnp
        from lidar_slam_arvc_tpu import cloud as cl
        from lidar_slam_arvc_tpu.registration import ICPParams, icp
        pts = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
        pts[:, 2] *= 0.1
        tgt = cl.estimate_normals(cl.from_numpy(pts, 512), 0.8)
        src = cl.from_numpy(pts, 512)
        res = icp(src, tgt, jnp.eye(4), ICPParams(max_iterations=0))
        assert float(res.fitness) > 0.99     # identity seed = perfect align
        assert float(res.inlier_rmse) < 1e-3
        assert int(res.iterations) == 0


class TestFinalDelta:
    def test_converged_vs_unconverged(self, rng):
        # converged solves report final_delta <= tol; a solve cut off after
        # one iteration from a far seed is still moving (the pipeline's
        # divergence gate keys on this, since carried metrics lag one step)
        import jax.numpy as jnp
        from lidar_slam_arvc_tpu import cloud as cl
        from lidar_slam_arvc_tpu.registration import ICPParams, icp
        pts = rng.uniform(-5, 5, (600, 3)).astype(np.float32)
        pts[:, 2] *= 0.1
        tgt = cl.estimate_normals(cl.from_numpy(pts, 1024), 0.8)
        src = cl.from_numpy(pts, 1024)
        T0 = np.eye(4, dtype=np.float32)
        T0[0, 3] = 0.05
        done = icp(src, tgt, jnp.asarray(T0), ICPParams(max_iterations=20))
        assert float(done.final_delta) <= 1e-4
        far = np.eye(4, dtype=np.float32)
        far[0, 3] = 2.0
        cut = icp(src, tgt, jnp.asarray(far), ICPParams(max_iterations=1))
        assert float(cut.final_delta) > 1e-2  # still moving when cut off
