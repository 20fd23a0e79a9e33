"""Incremental pose-graph construction with batch re-solve.

API parity with reference graphslam/graphSLAM.py:56-232 (GraphSLAM class):
``init_graph`` / ``add_edge`` / ``add_gps_factor`` / ``add_initial_estimate``
/ ``optimize`` / ``get_solution_transforms`` / ``get_solution_transforms_lidar``.
Factors accumulate in host-side numpy buffers with static capacities; each
``optimize`` pushes them to the device and runs the batch LM solver (one
compiled executable for the whole run because capacities are fixed).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu.graph.factors import DEFAULT_SIGMAS, FactorData, NoiseSigmas
from lidar_slam_arvc_tpu.graph.solver import solve_graph


@functools.partial(jax.jit, static_argnames=("eb", "eg", "ep"))
def _unpack_factors(f32, i32, eb: int, eg: int, ep: int) -> FactorData:
    """Slice ONE packed f32 buffer + ONE packed i32 buffer back into the
    FactorData struct-of-arrays.  Uploading the 10 factor buffers
    separately costs 10 host-to-device transfers per optimize(); the
    slices here are free inside XLA."""
    o = 0

    def take(n, shape):
        nonlocal o
        a = f32[o:o + n].reshape(shape)
        o += n
        return a

    bt_T = take(eb * 16, (eb, 4, 4))
    bt_winv = take(eb * 6, (eb, 6))
    gps_z = take(eg * 3, (eg, 3))
    gps_winv = take(eg * 3, (eg, 3))
    pr_T = take(ep * 16, (ep, 4, 4))
    pr_winv = take(ep * 6, (ep, 6))
    return FactorData(
        bt_i=i32[:eb], bt_j=i32[eb:2 * eb], bt_T=bt_T, bt_winv=bt_winv,
        gps_i=i32[2 * eb:2 * eb + eg], gps_z=gps_z, gps_winv=gps_winv,
        pr_i=i32[2 * eb + eg:2 * eb + eg + ep], pr_T=pr_T, pr_winv=pr_winv)


class PoseGraph:
    def __init__(self, T0: np.ndarray | None = None,
                 T0_gps: np.ndarray | None = None,
                 max_poses: int = 4096, max_between: int | None = None,
                 max_gps: int | None = None,
                 sigmas: NoiseSigmas = DEFAULT_SIGMAS,
                 mesh=None, chain_capacity: int | None = None):
        # mesh: jax.sharding.Mesh with a 'data' axis.  When set (and the pose
        # capacity divides evenly over it) optimize(solver='auto') picks the
        # distributed Schur solver — the multi-device stage-2 path
        # (SURVEY.md §2.3 row 3); None = single-device dense/PCG.
        self.mesh = mesh
        self.max_poses = max_poses
        self.max_between = max_between or (4 * max_poses)
        self.max_gps = max_gps or max_poses
        self.sigmas = sigmas
        self.T0 = np.eye(4) if T0 is None else np.asarray(T0, dtype=np.float64)
        self.T0_gps = (np.eye(4) if T0_gps is None
                       else np.asarray(T0_gps, dtype=np.float64))

        self.poses = np.tile(np.eye(4, dtype=np.float32), (max_poses, 1, 1))
        self.n_poses = 0

        self.bt_i = np.zeros(self.max_between, dtype=np.int32)
        self.bt_j = np.zeros(self.max_between, dtype=np.int32)
        self.bt_T = np.tile(np.eye(4, dtype=np.float32),
                            (self.max_between, 1, 1))
        self.bt_winv = np.zeros((self.max_between, 6), dtype=np.float32)
        self.n_between = 0
        # CHAIN-partitioned buffers: slots [0, chain_capacity) hold only
        # consecutive (j == i+1) edges (or zero-weight padding), so the
        # dense assembly lays them down as a scatter-free block-tridiagonal
        # band (solver._expand_block_tridiag); only slots beyond — the
        # loop-closure edges — go through the serialized scatter.  SM+ODO
        # chain edges need up to 2*(max_poses-1) slots; the default keeps
        # at least half of max_between reserved for loop edges.  Callers
        # sizing their own buffers (the pipeline) pass chain_capacity
        # explicitly (2*max_poses chain + a loop budget).
        if chain_capacity is None:
            chain_capacity = min(2 * max_poses, self.max_between // 2)
        if not 0 <= chain_capacity <= self.max_between:
            raise ValueError(f"chain_capacity {chain_capacity} outside "
                             f"[0, max_between={self.max_between}]")
        self.chain_capacity = chain_capacity
        self.n_chain = 0
        self.n_loop = 0

        self.gps_i = np.zeros(self.max_gps, dtype=np.int32)
        self.gps_z = np.zeros((self.max_gps, 3), dtype=np.float32)
        self.gps_winv = np.zeros((self.max_gps, 3), dtype=np.float32)
        self.n_gps = 0

        self.pr_i = np.zeros(1, dtype=np.int32)
        self.pr_T = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1))
        self.pr_winv = np.zeros((1, 6), dtype=np.float32)
        self.n_prior = 0

    # ------------------------------------------------------------ building

    def init_graph(self):
        """Prior at pose 0 with T0, seeded at T0 (reference
        graphSLAM.py:79-86: PriorFactorPose3(X(0), T0) + initial estimate
        T0 — seeding identity when T0 != I would start the prior with a
        large residual and bias pose 0)."""
        self.pr_i[0] = 0
        self.pr_T[0] = self.T0.astype(np.float32)
        self.pr_winv[0] = 1.0 / self.sigmas.prior
        self.n_prior = 1
        self.poses[0] = self.T0.astype(np.float32)
        self.n_poses = max(self.n_poses, 1)

    def add_edge(self, T_ij: np.ndarray, i: int, j: int, noise_type: str):
        """Between factor i->j (reference graphSLAM.py:88-91).

        Consecutive edges (j == i+1) fill the chain partition while it has
        room (scatter-free band assembly); everything else — loop closures,
        or chain overflow — goes to the scatter partition after it.
        """
        sig = {"SM": self.sigmas.sm, "ODO": self.sigmas.odo}[noise_type]
        if j == i + 1 and self.n_chain < self.chain_capacity:
            k = self.n_chain
            self.n_chain += 1
        else:
            k = self.chain_capacity + self.n_loop
            if k >= self.max_between:
                raise RuntimeError(
                    f"between-factor capacity exceeded (chain "
                    f"{self.n_chain}/{self.chain_capacity}, loop "
                    f"{self.n_loop}/"
                    f"{self.max_between - self.chain_capacity}); raise "
                    "max_between")
            self.n_loop += 1
        self.bt_i[k] = i
        self.bt_j[k] = j
        self.bt_T[k] = np.asarray(T_ij, dtype=np.float32)
        self.bt_winv[k] = 1.0 / sig
        self.n_between += 1

    def add_gps_factor(self, utmx: float, utmy: float, altitude: float, i: int):
        """GPS unary factor (reference graphSLAM.py:93-95)."""
        if self.n_gps >= self.max_gps:
            raise RuntimeError("gps-factor capacity exceeded")
        k = self.n_gps
        self.gps_i[k] = i
        self.gps_z[k] = (utmx, utmy, altitude)
        self.gps_winv[k] = 1.0 / self.sigmas.gps
        self.n_gps += 1

    def add_initial_estimate(self, T_rel: np.ndarray, k: int):
        """Pose k seeded by composing pose k-1 with the relative transform
        (reference graphSLAM.py:97-100)."""
        self.poses[k] = (self.poses[k - 1].astype(np.float64)
                         @ np.asarray(T_rel, dtype=np.float64)).astype(np.float32)
        self.n_poses = max(self.n_poses, k + 1)

    # ----------------------------------------------------------- solving

    def _factor_data(self) -> FactorData:
        """Device factor buffers via ONE packed f32 + ONE packed i32 upload
        (see _unpack_factors — 2 transfers instead of 10 per optimize)."""
        f32 = np.concatenate([
            self.bt_T.reshape(-1), self.bt_winv.reshape(-1),
            self.gps_z.reshape(-1), self.gps_winv.reshape(-1),
            self.pr_T.reshape(-1), self.pr_winv.reshape(-1)])
        i32 = np.concatenate([self.bt_i, self.bt_j, self.gps_i, self.pr_i])
        return _unpack_factors(jnp.asarray(f32), jnp.asarray(i32),
                               self.max_between, self.max_gps,
                               self.pr_i.shape[0])

    def auto_solver(self) -> str:
        """The solver optimize(solver='auto') will pick — single source of
        truth, also reported in the stage-2 profile artifact.

        Dense Cholesky up to 256 poses, PCG with the cyclic-reduction
        chain preconditioner (graph/bcr.py) beyond: dense cost grows with
        the cube of the capacity and PCG's about linearly, and the
        crossover has to be measured on the device (not measured on the
        GPU yet).
        """
        if (self.mesh is not None and self.mesh.size > 1
                and self.max_poses % self.mesh.size == 0
                and self.max_poses >= 2 * self.mesh.size):
            return "schur"
        return "dense" if self.max_poses <= 256 else "pcg"

    def optimize(self, max_iterations: int = 15,
                 solver: str = "auto") -> float:
        """Batch LM re-solve of the whole graph (replaces isam.update,
        reference graphSLAM.py:102-105).

        solver: 'dense' (Cholesky on the full 6Nx6N normal equations),
        'pcg' (matrix-free preconditioned CG, cyclic-reduction chain
        preconditioner), 'schur' (distributed chunk-wise Schur elimination
        over the attached mesh), or 'auto' (schur when a multi-device mesh
        is attached and the pose capacity divides over it; else dense up to
        the measured 256-pose-capacity crossover, PCG beyond — see
        auto_solver for the numbers).
        """
        if solver == "auto":
            solver = self.auto_solver()
        if solver == "schur":
            from lidar_slam_arvc_tpu.parallel.schur import schur_solve_graph
            mesh = self.mesh
            if mesh is None:
                from lidar_slam_arvc_tpu.parallel.mesh import data_mesh
                mesh = data_mesh()
            if self.max_poses % mesh.size:
                raise ValueError(
                    f"pose capacity {self.max_poses} not divisible by mesh "
                    f"size {mesh.size}")
            poses, cost = schur_solve_graph(
                mesh, jnp.asarray(self.poses), self._factor_data(),
                self.n_poses, sep_capacity=self._sep_capacity(mesh.size),
                max_iterations=max_iterations)
        elif solver == "pcg":
            from lidar_slam_arvc_tpu.graph.pcg import solve_graph_pcg
            poses, cost = solve_graph_pcg(jnp.asarray(self.poses),
                                          self._factor_data(), self.n_poses,
                                          max_iterations=max_iterations)
        else:
            poses, cost = solve_graph(
                jnp.asarray(self.poses), self._factor_data(), self.n_poses,
                max_iterations=max_iterations,
                chain_capacity=self._effective_chain_capacity())
        self.poses = np.array(poses)  # writable host copy
        return cost

    def _effective_chain_capacity(self) -> int:
        """Band assembly through 1024 poses, scatter beyond (the three
        full-(6N)^2 band passes outgrow the scatter at large capacity);
        every dense _assemble consumer size-gates through this single
        policy.  The crossover has not been measured on the GPU yet."""
        return self.chain_capacity if self.max_poses <= 1024 else 0

    def _sep_capacity(self, n_devices: int) -> int:
        """Static separator capacity for the Schur solver: the exact count
        of poses touched by cross-chunk edges, rounded up to a power of two
        (>=16) so the compiled step is reused as the graph grows."""
        m = self.max_poses // n_devices
        # buffers are chain-partitioned (add_edge): active slots are those
        # with nonzero weight, not a prefix
        active = self.bt_winv.any(axis=1)
        i = self.bt_i[active]
        j = self.bt_j[active]
        cross = (i // m) != (j // m)
        n_sep = len(np.unique(np.concatenate([i[cross], j[cross]])))
        cap = 16
        while cap < n_sep:
            cap *= 2
        return min(cap, self.max_poses)

    def marginal_covariances(self, indices=None) -> np.ndarray:
        """Tangent-space [w, v] 6x6 marginal covariance blocks
        (gtsam.Marginals parity, reference graphSLAM.py:117-137).

        indices=None: all active poses — chunked dense back-substitution
        (O((6N)^2) memory, same as the solve; fine to the dense-solver
        capacity).  With indices (K,): matrix-free PCG per requested pose,
        which scales to any capacity — used by the pipeline's skip-sampled
        uncertainty artifact.  Returns (n_poses, 6, 6) or (K, 6, 6).
        """
        if indices is None:
            from lidar_slam_arvc_tpu.graph.solver import marginal_covariances
            cov = marginal_covariances(
                jnp.asarray(self.poses), self._factor_data(), self.n_poses,
                chain_capacity=self._effective_chain_capacity())
            return np.array(cov[: self.n_poses], dtype=np.float64)
        from lidar_slam_arvc_tpu.graph.pcg import marginal_blocks_pcg
        cov = marginal_blocks_pcg(jnp.asarray(self.poses),
                                  self._factor_data(), self.n_poses,
                                  np.asarray(indices, dtype=np.int32))
        return np.array(cov, dtype=np.float64)

    # ----------------------------------------------------------- queries

    @property
    def current_estimate(self) -> np.ndarray:
        return self.poses[: self.n_poses].astype(np.float64)

    def positions(self) -> np.ndarray:
        return self.current_estimate[:, :3, 3]

    def get_solution_transforms(self) -> np.ndarray:
        """(reference graphSLAM.py:214-222)."""
        return self.current_estimate

    def get_solution_transforms_lidar(self) -> np.ndarray:
        """Solution re-based into the LiDAR frame: X_i @ T0_gps^-1
        (reference graphSLAM.py:224-232)."""
        inv = np.linalg.inv(self.T0_gps)
        return np.einsum("nij,jk->nik", self.current_estimate, inv)
