"""Pose-graph solver tests on synthetic noisy graphs (SURVEY.md §4's
missing-fixture re-creation: what tools/simulate.py intended)."""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as SR

import jax.numpy as jnp

from lidar_slam_arvc_tpu.graph import PoseGraph, DEFAULT_SIGMAS
from lidar_slam_arvc_tpu.utils import synthetic
from lidar_slam_arvc_tpu.utils.metrics import ate


def _noisy_rel(T_rel, rng, rot_sigma=0.002, trans_sigma=0.01):
    n = SR.from_rotvec(rng.normal(scale=rot_sigma, size=3)).as_matrix()
    out = T_rel.copy()
    out[:3, :3] = T_rel[:3, :3] @ n
    out[:3, 3] += rng.normal(scale=trans_sigma, size=3)
    return out


@pytest.fixture(scope="module")
def circle_graph():
    """Ground-truth circle; odometry edges with noise+bias; loop closures."""
    rng = np.random.default_rng(5)
    n = 60
    T_gt = synthetic.make_trajectory(n, radius=8.0)
    rel_gt = [np.linalg.inv(T_gt[i]) @ T_gt[i + 1] for i in range(n - 1)]
    return n, T_gt, rel_gt, rng


class TestPoseGraph:
    def test_odometry_only_matches_compose(self, circle_graph):
        n, T_gt, rel_gt, rng = circle_graph
        g = PoseGraph(max_poses=64, max_between=256, max_gps=64)
        g.init_graph()
        for i in range(n - 1):
            g.add_initial_estimate(rel_gt[i], i + 1)
            g.add_edge(rel_gt[i], i, i + 1, "SM")
        cost = g.optimize()
        # perfect measurements -> solution = composed chain, cost ~ 0
        err = ate(g.current_estimate, T_gt, align=True)
        assert err["rmse"] < 1e-3
        assert cost < 1e-4

    def test_loop_closure_reduces_drift(self, circle_graph):
        n, T_gt, rel_gt, rng = circle_graph
        # biased odometry (yaw drift) -> large open-loop error
        g = PoseGraph(max_poses=64, max_between=256, max_gps=64)
        g.init_graph()
        drift = synthetic._yaw_T(0.02, 0.0, 0.004)
        for i in range(n - 1):
            rel_noisy = rel_gt[i] @ drift
            g.add_initial_estimate(rel_noisy, i + 1)
            g.add_edge(rel_noisy, i, i + 1, "SM")
        open_loop = ate(g.current_estimate, T_gt)["rmse"]

        # add loop closures tying the end back to the start region
        for (i, j) in [(0, n - 2), (1, n - 1), (2, n - 2)]:
            T_ij = np.linalg.inv(T_gt[i]) @ T_gt[j]
            g.add_edge(_noisy_rel(T_ij, rng, 1e-4, 1e-3), i, j, "SM")
        g.optimize(max_iterations=30)
        closed = ate(g.current_estimate, T_gt)["rmse"]
        # three closures vs 59 equally-weighted drifting edges: expect a
        # large (not total) drift reduction
        assert closed < open_loop * 0.5, (open_loop, closed)

    def test_gps_anchors_absolute_frame(self, circle_graph):
        n, T_gt, rel_gt, rng = circle_graph
        g = PoseGraph(max_poses=64, max_between=256, max_gps=64)
        g.init_graph()
        drift = synthetic._yaw_T(0.015, 0.0, 0.002)
        for i in range(n - 1):
            g.add_initial_estimate(rel_gt[i] @ drift, i + 1)
            g.add_edge(rel_gt[i] @ drift, i, i + 1, "ODO")
        # GPS every 5 poses with small noise
        for i in range(0, n, 5):
            z = T_gt[i][:3, 3] + rng.normal(scale=0.05, size=3)
            g.add_gps_factor(z[0], z[1], z[2], i)
        before = ate(g.current_estimate, T_gt, align=False)["rmse"]
        g.optimize(max_iterations=30)
        err = ate(g.current_estimate, T_gt, align=False)  # absolute!
        # GPS is weak (sigma 2.5 m) vs odometry (0.05 m) under the
        # reference noise table, so meters-level residual drift remains —
        # but the absolute frame must be anchored (was ~13 m open loop).
        assert err["rmse"] < 3.0, err
        assert err["rmse"] < before / 4.0

    def test_incremental_resolve_reuses_capacity(self, circle_graph):
        # interleave add/optimize like run_graphSLAM.py:229-268 — shapes are
        # static so no recompilation (smoke: just correctness here)
        n, T_gt, rel_gt, rng = circle_graph
        g = PoseGraph(max_poses=64, max_between=256, max_gps=64)
        g.init_graph()
        for i in range(n - 1):
            g.add_initial_estimate(rel_gt[i], i + 1)
            g.add_edge(rel_gt[i], i, i + 1, "SM")
            if i % 10 == 0:
                g.optimize(max_iterations=5)
        g.optimize()
        assert ate(g.current_estimate, T_gt)["rmse"] < 1e-2

    def test_solution_transforms_lidar(self):
        T0_gps = np.eye(4)
        T0_gps[0, 3] = 0.36  # reference's example gps lever arm
        g = PoseGraph(T0_gps=T0_gps, max_poses=8, max_between=8, max_gps=8)
        g.init_graph()
        g.add_initial_estimate(np.eye(4), 1)
        sol = g.get_solution_transforms_lidar()
        np.testing.assert_allclose(sol[0], np.linalg.inv(T0_gps), atol=1e-6)

    def test_sigma_table_matches_reference(self):
        s = DEFAULT_SIGMAS
        np.testing.assert_allclose(s.prior[:3], np.deg2rad(10.0))
        np.testing.assert_allclose(s.prior[3:], 10.0)
        np.testing.assert_allclose(s.sm[:3], np.deg2rad(0.05))
        np.testing.assert_allclose(s.sm[3:], 0.05)
        np.testing.assert_allclose(s.odo[:3], np.deg2rad(3.0))
        np.testing.assert_allclose(s.odo[3:], 0.05)
        np.testing.assert_allclose(s.gps, [2.5, 2.5, 3.0])


class TestAssembleOracle:
    def test_dense_H_matches_float64_reference(self):
        """The device-formulated assembly (one-hot matmuls for diagonal
        blocks, single wide-layout block-diagonal expansion, off-diagonal
        scatter) must equal a straightforward float64 numpy assembly of
        J^T W^2 J from the same per-factor residuals/Jacobians."""
        from lidar_slam_arvc_tpu.graph.solver import (
            _assemble, _between_residuals, _gps_residuals, _prior_residuals)
        rng = np.random.default_rng(7)
        n, cap = 12, 16
        T_gt = synthetic.make_trajectory(n, radius=4.0)
        g = PoseGraph(max_poses=cap, max_between=64, max_gps=16)
        g.init_graph()
        for i in range(n - 1):
            rel = _noisy_rel(np.linalg.inv(T_gt[i]) @ T_gt[i + 1], rng)
            g.add_initial_estimate(rel, i + 1)
            g.add_edge(rel, i, i + 1, "SM")
            g.add_edge(rel, i, i + 1, "ODO")       # duplicate (i, j) pair
        g.add_edge(np.linalg.inv(T_gt[1]) @ T_gt[n - 2], 1, n - 2, "SM")
        for i in (0, 5):
            g.add_gps_factor(*T_gt[i][:3, 3], i)

        poses = jnp.asarray(g.poses)
        f = g._factor_data()
        H, b = _assemble(poses, f, jnp.int32(g.n_poses))
        H = np.asarray(H, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)

        M = cap * 6
        H64 = np.zeros((M, M))
        b64 = np.zeros(M)
        r, A, B = map(np.asarray, _between_residuals(poses, f))
        w = np.asarray(f.bt_winv)
        for e in range(len(w)):
            if not w[e].any():
                continue
            i, j = int(f.bt_i[e]), int(f.bt_j[e])
            J = np.zeros((6, M))
            J[:, 6 * i: 6 * i + 6] = A[e]
            J[:, 6 * j: 6 * j + 6] = B[e]
            W2 = np.diag(w[e].astype(np.float64) ** 2)
            H64 += J.T @ W2 @ J
            b64 += J.T @ W2 @ r[e]
        rg, Jg = map(np.asarray, _gps_residuals(poses, f))
        wg = np.asarray(f.gps_winv)
        for e in range(len(wg)):
            if not wg[e].any():
                continue
            i = int(f.gps_i[e])
            J = np.zeros((3, M))
            J[:, 6 * i: 6 * i + 6] = Jg[e]
            W2 = np.diag(wg[e].astype(np.float64) ** 2)
            H64 += J.T @ W2 @ J
            b64 += J.T @ W2 @ rg[e]
        rp, Jp = map(np.asarray, _prior_residuals(poses, f))
        wp = np.asarray(f.pr_winv)
        for e in range(len(wp)):
            if not wp[e].any():
                continue
            i = int(f.pr_i[e])
            J = np.zeros((6, M))
            J[:, 6 * i: 6 * i + 6] = Jp[e]
            W2 = np.diag(wp[e].astype(np.float64) ** 2)
            H64 += J.T @ W2 @ J
            b64 += J.T @ W2 @ rp[e]
        for p in range(g.n_poses, cap):           # inactive identity
            H64[6 * p: 6 * p + 6, 6 * p: 6 * p + 6] = np.eye(6)

        scale = max(np.abs(H64).max(), 1.0)
        np.testing.assert_allclose(H / scale, H64 / scale, atol=1e-6)
        bs = max(np.abs(b64).max(), 1.0)
        np.testing.assert_allclose(b / bs, b64 / bs, atol=1e-6)


class TestChainBandAssembly:
    """The chain-partitioned scatter-free band assembly (r5: consecutive
    SM+ODO edges laid down as a block-tridiagonal band, only loop edges
    scatter) must be BITWISE identical to the all-scatter assembly."""

    def _graph(self, n=40, cap=64):
        rng = np.random.default_rng(3)
        T_gt = synthetic.make_trajectory(n, radius=6.0)
        g = PoseGraph(max_poses=cap, max_between=256, max_gps=cap)
        g.init_graph()
        for i in range(n - 1):
            rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
            rel[:3, 3] += rng.normal(scale=0.02, size=3)
            g.add_initial_estimate(rel, i + 1)
            g.add_edge(rel, i, i + 1, "SM")
            g.add_edge(rel, i, i + 1, "ODO")
        # loop closures (scatter partition) + duplicated (i, j) pair
        g.add_edge(np.linalg.inv(T_gt[2]) @ T_gt[n - 3], 2, n - 3, "SM")
        g.add_edge(np.linalg.inv(T_gt[2]) @ T_gt[n - 3], 2, n - 3, "SM")
        g.add_gps_factor(*T_gt[0][:3, 3], 0)
        return g, T_gt

    def test_band_assembly_bitwise_matches_scatter(self):
        from lidar_slam_arvc_tpu.graph.solver import _assemble
        g, _ = self._graph()
        assert g.n_chain == 78 and g.n_loop == 2
        poses = jnp.asarray(g.poses)
        fd = g._factor_data()
        H0, b0 = _assemble(poses, fd, jnp.int32(g.n_poses), 0)
        H1, b1 = _assemble(poses, fd, jnp.int32(g.n_poses),
                           g.chain_capacity)
        assert float(jnp.abs(H1 - H0).max()) == 0.0
        assert float(jnp.abs(b1 - b0).max()) == 0.0

    def test_partitioned_solve_matches_unpartitioned(self):
        from lidar_slam_arvc_tpu.graph.solver import solve_graph
        g, T_gt = self._graph()
        poses = jnp.asarray(g.poses)
        fd = g._factor_data()
        p0, c0 = solve_graph(poses, fd, g.n_poses, chain_capacity=0)
        p1, c1 = solve_graph(poses, fd, g.n_poses,
                             chain_capacity=g.chain_capacity)
        assert abs(c1 - c0) <= 1e-6 * max(abs(c0), 1.0)
        np.testing.assert_allclose(np.asarray(p1), np.asarray(p0),
                                   atol=1e-6)

    def test_chain_overflow_routes_to_scatter_partition(self):
        # more consecutive edges than the chain partition holds must not
        # error — they spill into the scatter partition, same numerics
        from lidar_slam_arvc_tpu.graph.solver import _assemble
        g = PoseGraph(max_poses=8, max_between=8, max_gps=4)
        g.init_graph()
        rel = np.eye(4)
        rel[0, 3] = 1.0
        for _ in range(3):                       # 3x duplicated chain edge
            for i in range(2):
                g.add_edge(rel, i, i + 1, "SM")
        assert g.n_chain == g.chain_capacity  # partition full
        assert g.n_loop == 6 - g.chain_capacity
        fd = g._factor_data()
        poses = jnp.asarray(g.poses)
        H0, b0 = _assemble(poses, fd, jnp.int32(3), 0)
        H1, b1 = _assemble(poses, fd, jnp.int32(3), g.chain_capacity)
        assert float(jnp.abs(H1 - H0).max()) == 0.0

    def test_loop_capacity_exhaustion_raises(self):
        g = PoseGraph(max_poses=8, max_between=8, max_gps=4)
        g.init_graph()
        rel = np.eye(4)
        with pytest.raises(RuntimeError, match="capacity exceeded"):
            for _ in range(9):
                g.add_edge(rel, 0, 5, "SM")      # all non-consecutive


class TestBCR:
    def test_matches_dense_solve(self):
        """Cyclic-reduction solve of random SPD block-tridiagonal systems
        vs a dense float64 oracle, across sizes incl. N=2 and N=1024."""
        from lidar_slam_arvc_tpu.graph.bcr import bcr_factor, bcr_solve
        rng = np.random.default_rng(0)
        for n in (2, 8, 64, 1024):
            E = rng.normal(scale=0.3, size=(n, 6, 6)).astype(np.float32)
            E[-1] = 0
            R = rng.normal(size=(n, 6, 6)).astype(np.float32)
            D = np.einsum("kab,kcb->kac", R, R) + 8 * np.eye(
                6, dtype=np.float32)
            M = np.zeros((6 * n, 6 * n))
            for i in range(n):
                M[6 * i: 6 * i + 6, 6 * i: 6 * i + 6] = D[i]
                if i + 1 < n:
                    M[6 * i: 6 * i + 6, 6 * i + 6: 6 * i + 12] = E[i]
                    M[6 * i + 6: 6 * i + 12, 6 * i: 6 * i + 6] = E[i].T
            b = rng.normal(size=(n, 6)).astype(np.float32)
            x_ref = np.linalg.solve(M, b.ravel()).reshape(n, 6)
            levels, Dr = bcr_factor(jnp.asarray(D), jnp.asarray(E))
            x = np.asarray(bcr_solve(levels, Dr, jnp.asarray(b)))
            err = np.abs(x - x_ref).max() / max(np.abs(x_ref).max(), 1)
            assert err < 1e-4, (n, err)

    def test_rejects_non_power_of_two(self):
        from lidar_slam_arvc_tpu.graph.bcr import bcr_factor
        D = jnp.tile(jnp.eye(6), (12, 1, 1))
        E = jnp.zeros((12, 6, 6))
        with pytest.raises(ValueError, match="power-of-two"):
            bcr_factor(D, E)

    def test_pcg_step_bcr_matches_tridiag(self):
        """pcg_lm_step with the BCR preconditioner reaches the same
        solution as the scan preconditioner (same H, same CG, different
        preconditioner factorization only)."""
        from lidar_slam_arvc_tpu.graph.pcg import pcg_lm_step
        rng = np.random.default_rng(2)
        n, cap = 24, 32
        T_gt = synthetic.make_trajectory(n, radius=6.0)
        g = PoseGraph(max_poses=cap, max_between=2 * cap, max_gps=cap)
        g.init_graph()
        for i in range(n - 1):
            rel = _noisy_rel(np.linalg.inv(T_gt[i]) @ T_gt[i + 1], rng)
            g.add_initial_estimate(rel, i + 1)
            g.add_edge(rel, i, i + 1, "SM")
        g.add_edge(np.linalg.inv(T_gt[2]) @ T_gt[n - 2], 2, n - 2, "SM")
        poses = jnp.asarray(g.poses)
        f = g._factor_data()
        lam = jnp.float32(1e-6)
        p_bcr, c_bcr = pcg_lm_step(poses, f, g.n_poses, lam,
                                   precond="bcr")
        p_tri, c_tri = pcg_lm_step(poses, f, g.n_poses, lam,
                                   precond="tridiag")
        np.testing.assert_allclose(np.asarray(p_bcr[:n, :3, 3]),
                                   np.asarray(p_tri[:n, :3, 3]),
                                   atol=5e-4)
        assert abs(float(c_bcr) - float(c_tri)) < 1e-3 * max(
            float(c_tri), 1.0)


class TestPCGSolver:
    """Matrix-free PCG vs dense Cholesky (graph/pcg.py)."""

    def _drifted_graph(self, n=60, cap=64):
        rng = np.random.default_rng(5)
        T_gt = synthetic.make_trajectory(n, radius=8.0)
        g = PoseGraph(max_poses=cap, max_between=4 * cap, max_gps=cap)
        g.init_graph()
        drift = synthetic._yaw_T(0.02, 0.0, 0.004)
        for i in range(n - 1):
            rel = (np.linalg.inv(T_gt[i]) @ T_gt[i + 1]) @ drift
            g.add_initial_estimate(rel, i + 1)
            g.add_edge(rel, i, i + 1, "SM")
        for (i, j) in [(0, n - 2), (1, n - 1), (2, n - 2)]:
            g.add_edge(np.linalg.inv(T_gt[i]) @ T_gt[j], i, j, "SM")
        for i in range(0, n, 6):
            z = T_gt[i][:3, 3]
            g.add_gps_factor(z[0], z[1], z[2], i)
        return g, T_gt

    def test_pcg_matches_dense(self):
        import copy
        g1, T_gt = self._drifted_graph()
        g2 = copy.deepcopy(g1)
        c_dense = g1.optimize(max_iterations=25, solver="dense")
        c_pcg = g2.optimize(max_iterations=25, solver="pcg")
        # same optimum (costs equal within f32 tolerance)
        assert abs(c_dense - c_pcg) < 0.05 * max(abs(c_dense), 1.0), (
            c_dense, c_pcg)
        e1 = ate(g1.current_estimate, T_gt)["rmse"]
        e2 = ate(g2.current_estimate, T_gt)["rmse"]
        assert abs(e1 - e2) < 0.02, (e1, e2)

    def test_auto_selects_pcg_for_large_capacity(self):
        g, T_gt = self._drifted_graph(n=60, cap=2048)
        before = ate(g.current_estimate, T_gt)["rmse"]
        g.optimize(max_iterations=20)  # auto -> pcg at cap 2048
        after = ate(g.current_estimate, T_gt)["rmse"]
        assert after < before

    def test_pcg_at_scale_with_loops_and_gps(self):
        # the regime PCG exists for: 2048 ACTIVE poses, loop closures +
        # GPS unary factors.  Exact between edges + drifted initial
        # estimates make the optimum the ground truth itself, so accuracy
        # is checked without a (prohibitively slow on CPU) dense solve.
        rng = np.random.default_rng(11)
        n = 2048
        T_gt = synthetic.make_trajectory(n, radius=60.0)
        g = PoseGraph(T0=T_gt[0], max_poses=n, max_between=3 * n,
                      max_gps=n // 8 + 1)
        g.init_graph()
        for i in range(n - 1):
            rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
            drifted = rel.copy()
            drifted[:3, 3] += rng.normal(scale=0.02, size=3)
            g.add_initial_estimate(drifted, i + 1)
            g.add_edge(rel, i, i + 1, "SM")
        for k in range(1, 9):
            i, j = 5 * k, n - 1 - 5 * k
            g.add_edge(np.linalg.inv(T_gt[i]) @ T_gt[j], i, j, "SM")
        for i in range(0, n, 8):
            z = T_gt[i][:3, 3]
            g.add_gps_factor(z[0], z[1], z[2], i)
        before = ate(g.current_estimate, T_gt)["rmse"]
        # default pipeline path: block-tridiagonal-preconditioned CG
        # (graph/pcg.py) solves the chain exactly, so the 200-iteration
        # default converges even on a 2048-pose trajectory
        g.optimize(max_iterations=25, solver="pcg")
        after = ate(g.current_estimate, T_gt)["rmse"]
        assert before > 0.2, before   # drift accumulated over 2k poses
        assert after < 0.05 * before, (before, after)


class TestMarginals:
    """gtsam.Marginals parity (reference graphSLAM.py:117-137)."""

    def _chain(self, n=6):
        g = PoseGraph(max_poses=8, max_between=16, max_gps=4)
        g.init_graph()
        step = np.eye(4)
        step[0, 3] = 1.0
        for i in range(n - 1):
            g.add_initial_estimate(step, i + 1)
            g.add_edge(step, i, i + 1, "ODO")
        return g, n

    def test_uncertainty_grows_along_chain(self):
        # with only a prior at pose 0 and odometry edges, the marginal
        # position variance must grow monotonically with distance from the
        # anchor (classic dead-reckoning behavior)
        g, n = self._chain()
        cov = g.marginal_covariances()
        assert cov.shape == (n, 6, 6)
        tvar = np.trace(cov[:, 3:, 3:], axis1=1, axis2=2)
        assert np.all(np.diff(tvar) > 0), tvar
        # symmetric PSD blocks
        assert np.allclose(cov, np.swapaxes(cov, 1, 2), rtol=1e-4, atol=1e-4)
        assert np.all(np.linalg.eigvalsh(cov) > -1e-6)

    def test_matches_dense_numpy_inverse_identity_chain(self):
        # identity-rotation chain: between-factor Jacobians reduce to
        # A=-Ad(T_ij^-1), B=I; build H in numpy and compare blocks.
        g, n = self._chain(n=4)
        cov = g.marginal_covariances()

        def adjoint(T):
            R, t = T[:3, :3], T[:3, 3]
            tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                           [-t[1], t[0], 0.0]])
            A = np.zeros((6, 6))
            A[:3, :3] = R
            A[3:, :3] = tx @ R
            A[3:, 3:] = R
            return A

        N = g.max_poses
        H = np.zeros((6 * N, 6 * N))
        # prior on pose 0 (zero residual at solution -> Jr_inv = I)
        Wp = np.diag((1.0 / DEFAULT_SIGMAS.prior) ** 2)
        H[:6, :6] += Wp
        step = np.eye(4)
        step[0, 3] = 1.0
        W = np.diag((1.0 / DEFAULT_SIGMAS.odo) ** 2)
        for i in range(3):
            A = -adjoint(np.linalg.inv(step))
            B = np.eye(6)
            si, sj = 6 * i, 6 * (i + 1)
            H[si:si + 6, si:si + 6] += A.T @ W @ A
            H[si:si + 6, sj:sj + 6] += A.T @ W @ B
            H[sj:sj + 6, si:si + 6] += B.T @ W @ A
            H[sj:sj + 6, sj:sj + 6] += B.T @ W @ B
        for k in range(4, N):  # inactive poses: identity diagonal
            H[6 * k:6 * k + 6, 6 * k:6 * k + 6] = np.eye(6)
        ref = np.linalg.inv(H)
        # the solver assembles/inverts in f32 with weights spanning 0.01-400
        # (kappa ~ 4e4), so compare scale-aware: diagonals relatively, off-
        # diagonals normalized by sqrt(d_ii d_jj) (correlation form)
        for i in range(4):
            blk = ref[6 * i:6 * i + 6, 6 * i:6 * i + 6]
            d = np.sqrt(np.outer(np.diag(blk), np.diag(blk)))
            np.testing.assert_allclose(np.diag(cov[i]), np.diag(blk),
                                       rtol=1e-2)
            np.testing.assert_allclose(cov[i] / d, blk / d,
                                       rtol=1e-2, atol=1e-2)

    def _loopy_graph(self, n=20, cap=32):
        rng = np.random.default_rng(3)
        from lidar_slam_arvc_tpu.utils import synthetic
        T_gt = synthetic.make_trajectory(n, radius=4.0)
        g = PoseGraph(max_poses=cap, max_between=4 * cap, max_gps=cap)
        g.init_graph()
        for i in range(n - 1):
            rel = np.linalg.inv(T_gt[i]) @ T_gt[i + 1]
            rel[:3, 3] += rng.normal(scale=0.01, size=3)
            g.add_initial_estimate(rel, i + 1)
            g.add_edge(rel, i, i + 1, "SM")
        g.add_edge(np.linalg.inv(T_gt[2]) @ T_gt[n - 2], 2, n - 2, "SM")
        for i in (0, n // 2):
            z = T_gt[i][:3, 3]
            g.add_gps_factor(z[0], z[1], z[2], i)
        g.optimize(max_iterations=10,
                   solver="dense" if cap <= 64 else "pcg")
        return g

    def test_pcg_blocks_match_dense_chunked(self):
        # Both marginal paths (dense chunked back-substitution and the
        # matrix-free per-index PCG) are compared against a float64
        # inverse of the SAME assembled information matrix.  cond(H) is
        # ~5e8 on this graph (SM rotation weights 1e6 vs weak priors), so
        # each f32 path carries a ~3% error floor — asserting the two
        # paths against EACH OTHER at a tighter tolerance than that floor
        # just tests that their rounding errors correlate (it broke on a
        # numerically-equivalent assembly reorder in r4).
        import jax.numpy as jnp
        from lidar_slam_arvc_tpu.graph.solver import _assemble
        g = self._loopy_graph()
        H, _ = _assemble(jnp.asarray(g.poses), g._factor_data(),
                         jnp.int32(g.n_poses))
        H64 = np.asarray(H, dtype=np.float64) + 1e-9 * np.eye(H.shape[0])
        Cov64 = np.linalg.inv(H64)
        cov_dense = g.marginal_covariances()
        idx = np.array([0, 3, 10, 19])
        cov_pcg = g.marginal_covariances(indices=idx)
        for k, i in enumerate(idx):
            truth = Cov64[6 * i: 6 * i + 6, 6 * i: 6 * i + 6]
            d = np.sqrt(np.outer(np.diag(truth), np.diag(truth)))
            np.testing.assert_allclose(cov_dense[i] / d, truth / d,
                                       rtol=5e-2, atol=5e-2)
            np.testing.assert_allclose(cov_pcg[k] / d, truth / d,
                                       rtol=5e-2, atol=5e-2)

    def test_pcg_blocks_at_large_capacity(self):
        # beyond the dense regime nothing materializes H: blocks stay
        # finite, symmetric, and PSD at capacity 2048
        g = self._loopy_graph(n=40, cap=2048)
        idx = np.array([0, 17, 39])
        cov = g.marginal_covariances(indices=idx)
        assert cov.shape == (3, 6, 6)
        assert np.all(np.isfinite(cov))
        # CG converges to the f32 residual floor (~1e-7 relative), so the
        # 6 independently-solved columns agree to ~1e-5 absolute
        np.testing.assert_allclose(cov, np.swapaxes(cov, 1, 2),
                                   rtol=1e-3, atol=1e-5)
        assert np.all(np.linalg.eigvalsh(cov) > -1e-6)

    def test_uncertainty_plot_artifact(self, tmp_path):
        from lidar_slam_arvc_tpu.viz import plot_trajectory_with_uncertainty
        g, n = self._chain()
        out = tmp_path / "unc.png"
        plot_trajectory_with_uncertainty(g.current_estimate,
                                         g.marginal_covariances(), str(out))
        assert out.exists() and out.stat().st_size > 0


class TestFusedLMEquivalence:
    def test_fused_schedule_matches_host_lm_drive(self, circle_graph):
        # solve_graph runs the LM accept/reject schedule inside one jitted
        # while_loop; it must match the host-driven lm_drive reference
        # step-for-step (same damping ladder -> same accepted iterates)
        import jax.numpy as jnp
        from lidar_slam_arvc_tpu.graph import PoseGraph
        from lidar_slam_arvc_tpu.graph.solver import (
            _lm_step, graph_cost, lm_drive, solve_graph)
        n, T_gt, rel_gt, rng = circle_graph
        g = PoseGraph(max_poses=64, max_between=128, max_gps=8)
        g.init_graph()
        for i in range(n - 1):
            rel = _noisy_rel(rel_gt[i], rng)
            g.add_initial_estimate(rel, i + 1)
            g.add_edge(rel, i, i + 1, "SM")
        fd = g._factor_data()
        poses = jnp.asarray(g.poses)
        n_active = jnp.asarray(g.n_poses, dtype=jnp.int32)

        p_fused, c_fused = solve_graph(poses, fd, g.n_poses,
                                       max_iterations=10)

        def step(p, lam):
            return _lm_step(p, fd, n_active, jnp.float32(lam))
        p_host, c_host = lm_drive(step, poses, graph_cost(poses, fd),
                                  max_iterations=10)
        assert abs(c_fused - float(c_host)) <= 1e-5 * max(float(c_host), 1.0)
        np.testing.assert_allclose(np.asarray(p_fused)[:n],
                                   np.asarray(p_host)[:n], atol=1e-5)
