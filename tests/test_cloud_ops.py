"""Cloud ops + low-level kernels vs numpy/scipy oracles."""

import numpy as np
import pytest
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu import cloud as cl
from lidar_slam_arvc_tpu.ops import (
    ball_moments_pallas, eigvals_sym3, nn_search, radius_accumulate,
    smallest_eigenvector_sym3,
)
from lidar_slam_arvc_tpu.ops.moments_pallas import _box_dist2


class TestEigh3:
    def test_eigvals_match_numpy(self, rng):
        A = rng.normal(size=(128, 3, 3))
        A = A + np.swapaxes(A, 1, 2)
        got = np.asarray(eigvals_sym3(jnp.asarray(A)))
        expected = np.linalg.eigvalsh(A)
        np.testing.assert_allclose(got, expected, atol=1e-4)

    def test_smallest_eigenvector(self, rng):
        A = rng.normal(size=(64, 3, 3))
        A = A @ np.swapaxes(A, 1, 2)  # PSD with distinct eigvals (generic)
        v = np.asarray(smallest_eigenvector_sym3(jnp.asarray(A)))
        w, V = np.linalg.eigh(A)
        v_ref = V[:, :, 0]
        dots = np.abs(np.sum(v * v_ref, axis=1))
        np.testing.assert_allclose(dots, 1.0, atol=1e-3)

    def test_isotropic(self):
        A = jnp.eye(3)[None] * 2.5
        v = np.asarray(smallest_eigenvector_sym3(A))
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-6)

    def test_planar_covariance(self, rng):
        # points on z=0 plane -> smallest eigenvector is +-z
        pts = rng.normal(size=(500, 3))
        pts[:, 2] = 0
        cov = np.cov(pts.T)
        v = np.asarray(smallest_eigenvector_sym3(jnp.asarray(cov)))
        np.testing.assert_allclose(abs(v[2]), 1.0, atol=1e-5)


class TestNNSearch:
    def test_matches_kdtree(self, rng):
        src = rng.normal(size=(300, 3)).astype(np.float32) * 10
        tgt = rng.normal(size=(500, 3)).astype(np.float32) * 10
        idx, d2 = nn_search(jnp.asarray(src), jnp.asarray(tgt),
                            jnp.ones(500, dtype=bool),
                            src_block=128, tgt_block=128)
        tree = cKDTree(tgt)
        d_ref, i_ref = tree.query(src)
        np.testing.assert_array_equal(np.asarray(idx), i_ref)
        np.testing.assert_allclose(np.sqrt(np.asarray(d2)), d_ref, atol=1e-3)

    def test_masked_targets_excluded(self, rng):
        src = np.zeros((1, 3), dtype=np.float32)
        tgt = np.array([[0.01, 0, 0], [5, 0, 0]], dtype=np.float32)
        mask = np.array([False, True])
        idx, d2 = nn_search(jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(mask), src_block=8, tgt_block=8)
        assert int(idx[0]) == 1
        np.testing.assert_allclose(float(d2[0]), 25.0, atol=1e-4)

    def test_non_multiple_sizes(self, rng):
        # sizes that don't divide the blocks exercise padding
        src = rng.normal(size=(77, 3)).astype(np.float32)
        tgt = rng.normal(size=(131, 3)).astype(np.float32)
        idx, d2 = nn_search(jnp.asarray(src), jnp.asarray(tgt),
                            jnp.ones(131, dtype=bool),
                            src_block=32, tgt_block=64)
        tree = cKDTree(tgt)
        _, i_ref = tree.query(src)
        np.testing.assert_array_equal(np.asarray(idx), i_ref)


class TestRadiusAccumulate:
    def test_matches_bruteforce(self, rng):
        pts = rng.normal(size=(200, 3)).astype(np.float32)
        r = 0.7
        count, s1, s2 = radius_accumulate(
            jnp.asarray(pts), jnp.asarray(pts), jnp.ones(200, dtype=bool),
            r, query_block=64, tgt_block=64)
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        w = d2 <= r * r
        np.testing.assert_allclose(np.asarray(count), w.sum(1), atol=0.5)
        s1_ref = w @ pts
        np.testing.assert_allclose(np.asarray(s1), s1_ref, atol=1e-3)


class TestBallMomentsPallas:
    """Pallas fused ball-moment kernel (interpret mode) vs brute force."""

    def _oracle(self, q, tgt, mask, r):
        d2 = ((q[:, None, :] - tgt[None, :, :]) ** 2).sum(-1)
        w = (d2 <= r * r) & mask[None, :]
        delta = tgt[None, :, :] - q[:, None, :]          # (Q, T, 3)
        s1 = (w[:, :, None] * delta).sum(1)
        outer = delta[:, :, :, None] * delta[:, :, None, :]
        s2full = (w[:, :, None, None] * outer).sum(1)
        iu = ([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2])
        s2 = s2full[:, iu[0], iu[1]]
        return w.sum(1).astype(np.float32), s1, s2

    def test_matches_bruteforce_with_mask(self, rng):
        q = rng.normal(size=(70, 3)).astype(np.float32)
        tgt = rng.normal(size=(90, 3)).astype(np.float32)
        mask = rng.uniform(size=90) > 0.3
        r = 0.9
        count, s1, s2 = ball_moments_pallas(
            jnp.asarray(q), jnp.asarray(tgt), jnp.asarray(mask), r,
            query_block=32, tgt_block=16, interpret=True)
        c_ref, s1_ref, s2_ref = self._oracle(q, tgt, mask, r)
        np.testing.assert_allclose(np.asarray(count), c_ref, atol=0.5)
        np.testing.assert_allclose(np.asarray(s1), s1_ref, atol=1e-4)
        np.testing.assert_allclose(np.asarray(s2), s2_ref, atol=1e-4)

    def test_normals_pallas_path_matches_xla(self, rng):
        from lidar_slam_arvc_tpu.cloud.normals import _cov_from_moments
        pts = rng.uniform(-3, 3, size=(300, 3)).astype(np.float32)
        pts[:, 2] = 0.3 * np.sin(pts[:, 0])  # smooth sheet
        c = cl.from_numpy(pts, capacity=512)
        n_xla = cl.estimate_normals(c, radius=0.8)     # CPU: the XLA path
        count, s1, s2 = ball_moments_pallas(
            c.points, c.points, c.mask, 0.8, query_mask=c.mask,
            interpret=True)
        n_pl = smallest_eigenvector_sym3(_cov_from_moments(count, s1, s2))
        # estimate_normals sets +z where fewer than 3 neighbours
        m = np.asarray(c.mask) & (np.asarray(count) >= 3)
        a = np.asarray(n_xla.normals)[m]
        b = np.asarray(n_pl)[m]
        dots = np.abs(np.sum(a * b, axis=1))
        assert np.min(dots) > 0.999

    def test_tile_skipping_exact(self, rng):
        # spatially sorted clusters 100 m apart: with block 16 every
        # cross-cluster tile's bbox bound exceeds the radius and is skipped
        # inside the kernel; results must still match brute force exactly
        a = rng.normal(scale=0.4, size=(32, 3)).astype(np.float32)
        b = rng.normal(scale=0.4, size=(32, 3)).astype(np.float32) + 100.0
        pts = np.concatenate([a, b])
        mask = np.ones(64, dtype=bool)
        r = 0.8
        count, s1, s2 = ball_moments_pallas(
            jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask), r,
            query_block=16, tgt_block=16, interpret=True,
            query_mask=jnp.asarray(mask))
        c_ref, s1_ref, s2_ref = self._oracle(pts, pts, mask, r)
        np.testing.assert_allclose(np.asarray(count), c_ref, atol=0.5)
        np.testing.assert_allclose(np.asarray(s1), s1_ref, atol=1e-4)
        np.testing.assert_allclose(np.asarray(s2), s2_ref, atol=1e-4)

    @pytest.mark.parametrize("q_n,t_n,qb,tb,r", [
        (16, 16, 16, 16, 0.9), (33, 200, 16, 64, 0.5),
        (129, 70, 64, 32, 1.2), (300, 300, 64, 64, 0.4)])
    def test_shapes_not_block_multiples(self, rng, q_n, t_n, qb, tb, r):
        q = rng.normal(size=(q_n, 3)).astype(np.float32)
        tgt = rng.normal(size=(t_n, 3)).astype(np.float32)
        mask = rng.uniform(size=t_n) > 0.25
        count, s1, s2 = ball_moments_pallas(
            jnp.asarray(q), jnp.asarray(tgt), jnp.asarray(mask), r,
            query_block=qb, tgt_block=tb, interpret=True)
        c_ref, s1_ref, s2_ref = self._oracle(
            q.astype(np.float64), tgt.astype(np.float64), mask, r)
        np.testing.assert_array_equal(np.asarray(count), c_ref)
        np.testing.assert_allclose(np.asarray(s1), s1_ref, atol=1e-4)
        np.testing.assert_allclose(np.asarray(s2), s2_ref, atol=1e-4)

    def test_all_targets_masked(self, rng):
        q = rng.normal(size=(40, 3)).astype(np.float32)
        count, s1, s2 = ball_moments_pallas(
            jnp.asarray(q), jnp.asarray(q), jnp.zeros(40, dtype=bool), 5.0,
            query_block=16, tgt_block=16, interpret=True)
        assert not np.asarray(count).any()
        assert not np.asarray(s1).any() and not np.asarray(s2).any()

    def test_traced_radius(self, rng):
        q = rng.normal(size=(50, 3)).astype(np.float32)
        mask = np.ones(50, dtype=bool)
        f = jax.jit(lambda p, m, r: ball_moments_pallas(
            p, p, m, r, query_block=16, tgt_block=16, interpret=True))
        for r in (0.5, 1.0):
            count, _, _ = f(jnp.asarray(q), jnp.asarray(mask), r)
            c_ref, _, _ = self._oracle(q, q, mask, r)
            np.testing.assert_array_equal(np.asarray(count), c_ref)

    def test_vmap_batches(self, rng):
        # preprocess_batch vmaps estimate_normals over scans
        q = rng.normal(size=(2, 40, 3)).astype(np.float32)
        mask = np.ones((2, 40), dtype=bool)
        f = jax.vmap(lambda p, m: ball_moments_pallas(
            p, p, m, 0.8, query_block=16, tgt_block=8, interpret=True))
        count, s1, s2 = f(jnp.asarray(q), jnp.asarray(mask))
        for b in range(2):
            c_ref, s1_ref, s2_ref = self._oracle(q[b], q[b], mask[b], 0.8)
            np.testing.assert_allclose(np.asarray(count[b]), c_ref, atol=0.5)
            np.testing.assert_allclose(np.asarray(s1[b]), s1_ref, atol=1e-4)
            np.testing.assert_allclose(np.asarray(s2[b]), s2_ref, atol=1e-4)


class TestCloud:
    def test_from_numpy_pads(self, rng):
        pts = rng.normal(size=(10, 3))
        c = cl.from_numpy(pts, capacity=16)
        assert c.points.shape == (16, 3)
        assert int(cl.num_valid(c)) == 10
        np.testing.assert_allclose(cl.to_numpy(c), pts, atol=1e-6)

    def test_from_numpy_truncates_uniformly(self, rng):
        pts = np.arange(100, dtype=np.float32)[:, None] * np.ones(3)
        c = cl.from_numpy(pts, capacity=10)
        out = cl.to_numpy(c)
        assert out.shape == (10, 3)
        assert out[0, 0] == 0 and out[-1, 0] == 99  # spans the whole scan

    def test_crop_radius_height(self):
        pts = np.array([
            [0.1, 0, 0],     # inside min radius -> dropped
            [5, 0, 0],       # kept
            [50, 0, 0],      # outside max radius -> dropped
            [5, 0, -2],      # below min height -> dropped
            [5, 0, 60],      # above max height -> dropped
        ], dtype=np.float32)
        c = cl.from_numpy(pts, capacity=8)
        out = cl.crop_radius_height(c, 0.5, 35.0, -1.0, 50.0)
        np.testing.assert_array_equal(
            np.asarray(out.mask)[:5], [False, True, False, False, False])


class TestVoxelDownsample:
    def test_centroids(self, rng):
        # two tight clusters at voxel centers -> two voxels at cluster means
        # (the min corner lands near cluster a, so +0.5 keeps each cluster
        # strictly inside one 1m voxel)
        a = rng.normal(scale=0.01, size=(50, 3)) + [0.0, 0.0, 0.0]
        b = rng.normal(scale=0.01, size=(50, 3)) + [5.5, 5.5, 5.5]
        pts = np.concatenate([a, b]).astype(np.float32)
        c = cl.from_numpy(pts, capacity=128)
        out = cl.voxel_downsample(c, voxel_size=1.0, out_capacity=16)
        got = cl.to_numpy(out)
        assert got.shape[0] == 2
        got = got[np.argsort(got[:, 0])]
        np.testing.assert_allclose(got[0], a.mean(0), atol=1e-4)
        np.testing.assert_allclose(got[1], b.mean(0), atol=1e-4)

    def test_count_matches_grid(self, rng):
        pts = (rng.uniform(0, 10, size=(2000, 3))).astype(np.float32)
        c = cl.from_numpy(pts, capacity=2048)
        out = cl.voxel_downsample(c, voxel_size=1.0)
        # oracle voxel count with same min-corner convention
        mins = pts.min(0)
        keys = np.unique(np.floor((pts - mins) / 1.0).astype(int) @ [10**6, 10**3, 1])
        assert int(cl.num_valid(out)) == len(keys)

    def test_counted_reports_overflow(self, rng):
        # more occupied voxels than out_capacity: the count still reports
        # the TRUE occupancy so callers can surface the truncation
        pts = (rng.uniform(0, 20, size=(800, 3))).astype(np.float32)
        c = cl.from_numpy(pts, capacity=1024)
        full = cl.voxel_downsample(c, voxel_size=0.5)
        true_n = int(cl.num_valid(full))
        assert true_n > 64
        out, n_vox = cl.voxel_downsample_counted(c, voxel_size=0.5,
                                                 out_capacity=64)
        assert int(n_vox) == true_n
        assert int(cl.num_valid(out)) == 64  # capacity-truncated

    def test_idempotent_when_sparse(self, rng):
        # points further apart than the voxel never merge
        pts = (np.arange(20)[:, None] * np.array([2.0, 0, 0])).astype(np.float32)
        c = cl.from_numpy(pts, capacity=32)
        out = cl.voxel_downsample(c, voxel_size=1.0)
        assert int(cl.num_valid(out)) == 20
        np.testing.assert_allclose(
            np.sort(cl.to_numpy(out)[:, 0]), pts[:, 0], atol=1e-5)


class TestCompact:
    """Full-resolution (voxel None) path: compaction must NEVER fabricate
    geometry.  Round-3 verdict repro: a 35 m-radius scan routed through a
    degenerate 0.01 m voxel grid produced output points up to 4.2 m from
    any input point (the 32-bit key clips at ~20 m).  The compaction path
    has no spatial key, so the property holds at any extent."""

    @staticmethod
    def _subset_err(out_pts, in_pts):
        tree = cKDTree(in_pts)
        d, _ = tree.query(out_pts)
        return d.max()

    def test_out_capacity_exceeding_input_rejected(self, rng):
        # growing a cloud is not compaction's job: an oversized out_capacity
        # must raise a clear ValueError, not a shape-mismatch deep in jnp
        c = cl.from_numpy(rng.normal(size=(32, 3)).astype(np.float32),
                          capacity=64)
        with pytest.raises(ValueError, match="out_capacity"):
            cl.compact_counted(c, out_capacity=128)

    def test_35m_scan_points_are_subset(self, rng):
        # the crop bound regime (keyframe.py:74-94 semantics, max_radius 35)
        pts = rng.uniform(-35, 35, size=(4000, 3)).astype(np.float32)
        c = cl.from_numpy(pts, capacity=4096)
        out, n = cl.compact_counted(c, out_capacity=4096)
        assert int(n) == 4000
        assert int(cl.num_valid(out)) == 4000          # count preserved
        got = cl.to_numpy(out)
        assert self._subset_err(got, pts) == 0.0       # exact subset

    def test_preprocess_full_resolution_subset(self, rng):
        # the real pipeline route: preprocess_batch with voxel_size=None
        from lidar_slam_arvc_tpu.pipeline.preprocess import preprocess_batch
        from lidar_slam_arvc_tpu.utils.config import IcpConfig
        cfg = IcpConfig(raw_capacity=4096, capacity=4096)
        pts = rng.uniform(-30, 30, size=(1, 4000, 3)).astype(np.float32)
        pts[..., 2] = np.abs(pts[..., 2]) * 0.5        # above min_height
        mask = np.zeros((1, 4096), dtype=bool)
        mask[:, :4000] = True
        buf = np.zeros((1, 4096, 3), dtype=np.float32)
        buf[:, :4000] = pts
        keys = jax.random.split(jax.random.PRNGKey(0), 1)
        out = preprocess_batch(jnp.asarray(buf), jnp.asarray(mask), keys,
                               cfg, "icppointpoint", None)
        got = np.asarray(out.points[0])[np.asarray(out.mask[0])]
        assert got.shape[0] > 3000                      # crop only
        assert self._subset_err(got, pts[0]) == 0.0

    def test_truncation_uniform_and_counted(self, rng):
        pts = rng.normal(size=(1000, 3)).astype(np.float32) * 40
        c = cl.from_numpy(pts, capacity=1024)
        out, n = cl.compact_counted(c, out_capacity=256)
        assert int(n) == 1000                           # true count surfaced
        assert int(cl.num_valid(out)) == 256            # exactly capacity
        got = cl.to_numpy(out)
        assert self._subset_err(got, pts) == 0.0
        # uniform stride in index space: consecutive kept input indices are
        # ~n/k apart (no prefix-keep, no dropped tail)
        tree = cKDTree(pts)
        d, idx = tree.query(got)
        assert d.max() == 0.0
        gaps = np.diff(np.sort(idx))
        assert gaps.max() <= int(np.ceil(1000 / 256)) + 1

    def test_order_preserved(self, rng):
        # compaction keeps the original relative order of valid points
        pts = np.arange(30, dtype=np.float32)[:, None] * [1.0, 0.0, 0.0]
        mask = np.zeros(32, dtype=bool)
        mask[:30] = np.arange(30) % 3 != 0              # drop every 3rd
        buf = np.zeros((32, 3), dtype=np.float32)
        buf[:30] = pts
        c = cl.Cloud(jnp.asarray(buf), jnp.asarray(mask))
        out, n = cl.compact_counted(c)
        got = cl.to_numpy(out)
        assert int(n) == int(mask.sum())
        np.testing.assert_array_equal(got[:, 0], pts[mask[:30], 0])

    def test_voxel_extent_guard_raises(self):
        # a grid too fine for the crop bounds is rejected at trace time
        from lidar_slam_arvc_tpu.pipeline.preprocess import preprocess_batch
        from lidar_slam_arvc_tpu.utils.config import IcpConfig
        cfg = IcpConfig(raw_capacity=64, capacity=64)   # max_radius 35
        pts = jnp.zeros((1, 64, 3))
        mask = jnp.ones((1, 64), dtype=bool)
        keys = jax.random.split(jax.random.PRNGKey(0), 1)
        with pytest.raises(ValueError, match="cannot address"):
            preprocess_batch(pts, mask, keys, cfg, "icppointpoint", 0.01)


class TestNormals:
    def test_plane_normals(self, rng):
        # noisy ground plane -> normals ~ +-z
        pts = rng.uniform(-5, 5, size=(2000, 3)).astype(np.float32)
        pts[:, 2] = 0.001 * rng.normal(size=2000)
        c = cl.from_numpy(pts, capacity=2048)
        c = cl.estimate_normals(c, radius=0.8)
        nz = np.abs(np.asarray(c.normals)[np.asarray(c.mask), 2])
        assert (nz > 0.99).mean() > 0.95

    def test_sphere_normals_radial(self, rng):
        # points on a sphere -> normal parallel to radial direction
        v = rng.normal(size=(4000, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts = (10.0 * v).astype(np.float32)
        c = cl.from_numpy(pts, capacity=4096)
        c = cl.estimate_normals(c, radius=1.5)
        n = np.asarray(c.normals)[np.asarray(c.mask)]
        p = cl.to_numpy(c)
        r = p / np.linalg.norm(p, axis=1, keepdims=True)
        align = np.abs(np.sum(n * r, axis=1))
        assert np.median(align) > 0.98


class TestGroundPlane:
    def test_recovers_synthetic_ground(self, rng):
        ground = rng.uniform(-10, 10, size=(1000, 3)).astype(np.float32)
        ground[:, 2] = -1.0 + 0.003 * rng.normal(size=1000)
        walls = rng.uniform(-10, 10, size=(500, 3)).astype(np.float32)
        walls[:, 2] = rng.uniform(0, 3, size=500)
        pts = np.concatenate([ground, walls])
        c = cl.from_numpy(pts, capacity=2048)
        plane = np.asarray(cl.ransac_ground_plane(
            c, jax.random.PRNGKey(0), seed_height=-0.5))
        # plane should be ~ z = -1: normal ~ +-(0,0,1), d ~ +-1
        nz = abs(plane[2])
        assert nz > 0.999
        z0 = -plane[3] / plane[2]
        assert abs(z0 - (-1.0)) < 0.02

        g, ng = cl.split_by_plane(c, jnp.asarray(plane), 0.4)
        gmask = np.asarray(g.mask)
        assert gmask[:1000].mean() > 0.95      # ground captured
        assert np.asarray(ng.mask)[1000:1500].mean() > 0.9  # walls kept out


class TestPallasNN:
    """Fused NN sweep kernel (Pallas interpreter) vs cKDTree."""

    @staticmethod
    def _check(src, tgt, mask, idx, d2):
        valid = np.flatnonzero(mask)
        d_ref, i_ref = cKDTree(tgt[valid].astype(np.float64)).query(
            src.astype(np.float64))
        np.testing.assert_array_equal(np.asarray(idx), valid[i_ref])
        np.testing.assert_allclose(np.asarray(d2), d_ref ** 2, atol=1e-4)

    def test_matches_xla(self, rng):
        from lidar_slam_arvc_tpu.ops.nn_pallas import nn_search_pallas
        src = rng.normal(size=(300, 3)).astype(np.float32) * 10
        tgt = rng.normal(size=(500, 3)).astype(np.float32) * 10
        mask = np.ones(500, dtype=bool)
        mask[100:150] = False
        i1, d1 = nn_search(jnp.asarray(src), jnp.asarray(tgt),
                           jnp.asarray(mask), src_block=128, tgt_block=128)
        i2, d2 = nn_search_pallas(jnp.asarray(src), jnp.asarray(tgt),
                                  jnp.asarray(mask), src_block=128,
                                  tgt_block=128, interpret=True)
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
        np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-3)

    @pytest.mark.parametrize("s_n,t_n,sb,tb", [
        (77, 131, 64, 128), (16, 16, 16, 16), (129, 300, 32, 64),
        (300, 1000, 128, 32)])
    def test_non_multiple_shapes(self, rng, s_n, t_n, sb, tb):
        from lidar_slam_arvc_tpu.ops.nn_pallas import nn_search_pallas
        src = rng.normal(size=(s_n, 3)).astype(np.float32) * 5
        tgt = rng.normal(size=(t_n, 3)).astype(np.float32) * 5
        mask = rng.uniform(size=t_n) > 0.2
        idx, d2 = nn_search_pallas(jnp.asarray(src), jnp.asarray(tgt),
                                   jnp.asarray(mask), src_block=sb,
                                   tgt_block=tb, interpret=True)
        self._check(src, tgt, mask, idx, d2)

    def test_all_targets_masked(self, rng):
        from lidar_slam_arvc_tpu.ops.nn_pallas import nn_search_pallas
        src = rng.normal(size=(40, 3)).astype(np.float32)
        tgt = rng.normal(size=(70, 3)).astype(np.float32)
        idx, d2 = nn_search_pallas(jnp.asarray(src), jnp.asarray(tgt),
                                   jnp.zeros(70, dtype=bool), src_block=16,
                                   tgt_block=16, interpret=True)
        # no valid target: the result can never pass a correspondence gate
        assert np.all(np.asarray(d2) > 1e12)
        assert np.all((np.asarray(idx) >= 0) & (np.asarray(idx) < 70))

    def test_ties_take_lowest_index(self):
        from lidar_slam_arvc_tpu.ops.nn_pallas import nn_search_pallas
        # the same point at indices 5, 21 and 40 (different tiles and
        # lanes of a 16-wide tile), all equally near every source
        tgt = np.full((48, 3), 50.0, dtype=np.float32)
        tgt[[5, 21, 40]] = [1.0, 2.0, 3.0]
        src = np.array([[1.0, 2.0, 3.1], [1.1, 2.0, 3.0]], np.float32)
        idx, _ = nn_search_pallas(jnp.asarray(src), jnp.asarray(tgt),
                                  jnp.ones(48, dtype=bool), src_block=16,
                                  tgt_block=16, interpret=True)
        np.testing.assert_array_equal(np.asarray(idx), [5, 5])

    def test_vmap_matches_per_pair(self, rng):
        from lidar_slam_arvc_tpu.ops.nn_pallas import nn_search_pallas
        src = rng.normal(size=(3, 50, 3)).astype(np.float32)
        tgt = rng.normal(size=(3, 90, 3)).astype(np.float32)
        mask = rng.uniform(size=(3, 90)) > 0.3
        f = jax.vmap(lambda s, t, m: nn_search_pallas(
            s, t, m, src_block=16, tgt_block=32, interpret=True))
        idx, d2 = f(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask))
        for b in range(3):
            self._check(src[b], tgt[b], mask[b], idx[b], d2[b])

    @pytest.mark.parametrize("n,cap,expect", [
        (5, 128, 16), (16, 128, 16), (100, 128, 128), (16384, 128, 128),
        (300, 64, 64)])
    def test_block_size(self, n, cap, expect):
        from lidar_slam_arvc_tpu.ops.nn_pallas import block_size
        assert block_size(n, cap) == expect


def test_box_dist2():
    lo_a = jnp.array([[0.0, 0.0, 0.0], [jnp.inf] * 3])
    hi_a = jnp.array([[1.0, 1.0, 1.0], [-jnp.inf] * 3])
    lo_b = jnp.array([[3.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    hi_b = jnp.array([[4.0, 1.0, 1.0], [2.0, 2.0, 2.0]])
    d = np.asarray(_box_dist2(lo_a, hi_a, lo_b, hi_b))
    np.testing.assert_allclose(d[0], [4.0, 0.0])     # gap 2 in x; overlap
    assert np.all(d[1] >= 1e12)                      # empty box never near
