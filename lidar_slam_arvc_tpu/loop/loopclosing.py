"""Loop closing with triplet (triangle) consistency filtering.

Logic parity with reference graphslam/loopclosing.py:9-268 (LoopClosing):
candidates are past poses within ``radius_threshold`` of the current pose,
restricted to at least ``distance_backwards`` of accumulated path behind the
current pose; candidate triplets (i, j1, j2) require index separation
1 < |j2-j1| < 80 and Euclidean separation 1 m < d < 2 m
(loopclosing.py:131-144); a triplet is accepted iff the transform cycle
I = T_ij1 * T_j1j2 * T_ij2^-1 is near identity (|pos| < 0.1 m and
min-branch Euler norm < 0.05 rad, loopclosing.py:119-129).

Restructuring: the candidate search is vectorized numpy (host control
logic), and the per-triplet ICPs — the expensive part the reference runs
sequentially (loopclosing.py:80-97) — are batched into a single dispatch
over all sampled triplet pairs, routed through the KeyframeStore's
4-method registration surface (keyframes/store.py) exactly as the
reference's loop closures inherit the configured method via
keyframe_manager.compute_transformation (loopclosing.py:180 ->
keyframemanager.py:60-72).  Candidate sampling uses an explicit seeded
Generator instead of global np.random (loopclosing.py:78), keeping runs
deterministic.
"""

from __future__ import annotations

import time as _time

import numpy as np

from lidar_slam_arvc_tpu.registration import ICPParams


def _rot_to_euler_both_np(R: np.ndarray):
    """Host mirror of geom.rot_to_euler_both for the triangle gate."""
    r02 = np.clip(R[0, 2], -1.0, 1.0)
    beta1 = np.arcsin(r02)
    beta2 = np.pi - beta1
    s1 = np.sign(np.cos(beta1)) or 1.0
    s2 = np.sign(np.cos(beta2)) or 1.0
    e1 = np.array([np.arctan2(-s1 * R[1, 2], s1 * R[2, 2]), beta1,
                   np.arctan2(-s1 * R[0, 1], s1 * R[0, 0])])
    e2 = np.array([np.arctan2(-s2 * R[1, 2], s2 * R[2, 2]), beta2,
                   np.arctan2(-s2 * R[0, 1], s2 * R[0, 0])])
    wrap = lambda e: np.arctan2(np.sin(e), np.cos(e))
    return wrap(e1), wrap(e2)


class LoopCloser:
    def __init__(self, graph, store, scan_masks=None, scan_normals=None,
                 distance_backwards: float = 7.0,
                 radius_threshold: float = 5.0,
                 icp_params: ICPParams | None = None,
                 method: str | None = None, seed: int = 0):
        """graph: PoseGraph; store: KeyframeStore holding the preprocessed
        scans — candidate ICPs dispatch the store's configured registration
        method (the reference's loop closures inherit the method the same
        way, loopclosing.py:180 -> keyframemanager.py:60-72).

        For callers holding raw stacked tensors, ``store`` may instead be
        the (N, CAP, 3) points array with ``scan_masks``/``scan_normals``
        following — wrapped into an array-backed store.  ``method`` then
        selects the estimator ('icppointplane' default; the legacy
        'point_to_plane'/'point_to_point' aliases are accepted)."""
        from lidar_slam_arvc_tpu.keyframes import KeyframeStore
        if not isinstance(store, KeyframeStore):
            alias = {"point_to_plane": "icppointplane", None: "icppointplane",
                     "point_to_point": "icppointpoint"}
            store = KeyframeStore.from_arrays(
                store, scan_masks, scan_normals,
                method=alias.get(method, method), icp_params=icp_params)
        else:
            assert scan_masks is None and scan_normals is None
            if icp_params is not None:
                # shallow copy: override the ICP params for loop-closure
                # dispatches WITHOUT mutating the caller's store (which may
                # serve other registrations with its own parameters); the
                # copy shares the device tensors
                import copy
                store = copy.copy(store)
                store.icp_params_override = icp_params
        self.graph = graph
        self.store = store
        self.distance_backwards = distance_backwards
        self.radius_threshold = radius_threshold
        self.rng = np.random.default_rng(seed)
        # per-phase cost accounting, surfaced in the stage-2 profile
        # artifact (candidate search is host control flow; the ICP is
        # device dispatches)
        self.timings = {"candidate_search_seconds": 0.0,
                        "icp_seconds": 0.0, "icp_dispatches": 0,
                        "icp_pairs": 0}

    # ------------------------------------------------- candidate search

    def _positions(self) -> np.ndarray:
        return self.graph.positions()

    def find_index_backwards(self, positions) -> int | None:
        """Largest index with > distance_backwards of accumulated path to the
        current pose (reference loopclosing.py:223-237)."""
        steps = np.linalg.norm(np.diff(positions, axis=0), axis=1)
        # cumulative path length walking backwards from the end
        back = np.cumsum(steps[::-1])[::-1]
        hits = np.nonzero(back > self.distance_backwards)[0]
        if len(hits) == 0:
            return None
        return int(hits[-1])

    def find_candidates(self) -> np.ndarray:
        """(reference loopclosing.py:213-253, vectorized)."""
        positions = self._positions()
        if len(positions) < 3:
            return np.empty(0, dtype=int)
        index = self.find_index_backwards(positions)
        if index is None:
            return np.empty(0, dtype=int)
        d = np.linalg.norm(positions[:index] - positions[-1], axis=1)
        return np.nonzero(d < self.radius_threshold)[0]

    def find_feasible_triplets(self, current_index: int) -> list:
        """(reference loopclosing.py:102-117 + 131-144)."""
        positions = self._positions()
        candidates = np.sort(self.find_candidates())
        triplets = []
        for k in range(len(candidates)):
            j1 = int(candidates[k])
            rest = candidates[k:]
            dindex = np.abs(rest - j1)
            deuc = np.linalg.norm(positions[rest] - positions[j1], axis=1)
            ok = (dindex > 1) & (dindex < 80) & (deuc > 1.0) & (deuc < 2.0)
            hits = np.nonzero(ok)[0]
            if len(hits):
                triplets.append([current_index, j1, int(rest[hits[0]])])
        return triplets

    # ------------------------------------------------------ ICP plumbing

    def _batched_candidate_icp(self, pairs: np.ndarray) -> np.ndarray:
        """Refined T_i_j for each (i, j) pair in one batched dispatch.

        Mirrors compute_transformations_between_candidates (reference
        loopclosing.py:154-184): seed from the current graph estimates
        conjugated by T0_gps, register the LiDAR clouds, conjugate back.

        The batch is padded to a fixed power-of-two size (self-pairs,
        discarded) so every loop-closing round reuses one compiled
        executable regardless of how many triplets survived the gates.
        """
        est = self.graph.current_estimate
        T0g_inv = np.linalg.inv(self.graph.T0_gps)
        T0g = self.graph.T0_gps

        n = len(pairs)
        cap = 8
        while cap < n:
            cap *= 2
        padded = np.concatenate(
            [pairs, np.zeros((cap - n, 2), dtype=pairs.dtype)])

        seeds = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
        for k, (i, j) in enumerate(pairs):
            Ti = est[i] @ T0g_inv
            Tj = est[j] @ T0g_inv
            seeds[k] = (np.linalg.inv(Ti) @ Tj).astype(np.float32)

        # [target i, source j] pairs — the store's batch convention matches
        t0 = _time.time()
        T = self.store.compute_transformations_batch(padded, seeds)[:n]
        self.timings["icp_seconds"] += _time.time() - t0
        self.timings["icp_dispatches"] += 1
        self.timings["icp_pairs"] += int(cap)
        return np.einsum("ij,njk,kl->nil", T0g_inv, T, T0g)

    # ------------------------------------------------------- public API

    def check_distances(self, I: np.ndarray) -> bool:
        """Triangle consistency gate (reference loopclosing.py:119-129)."""
        dp = np.linalg.norm(I[:3, 3])
        e1, e2 = _rot_to_euler_both_np(I[:3, :3])
        da = min(np.linalg.norm(e1), np.linalg.norm(e2))
        return dp < 0.1 and da < 0.05

    def loop_closing_simple(self, current_index: int,
                            number_of_candidates: int) -> list:
        """Ungated loop closing (reference loopclosing.py:33-57): sample
        candidates within the radius and add every ICP result as an SM edge
        — no triangle consistency check, so a wrong registration corrupts
        the graph (the reference documents this risk; loop_closing_triangle
        is the recommended path).  Returns added [i, j] pairs.
        """
        candidates = self.find_candidates()
        if len(candidates) == 0:
            return []
        n = min(len(candidates), number_of_candidates)
        chosen = self.rng.choice(candidates, size=n, replace=False)
        pairs = np.array([[current_index, int(j)] for j in chosen])
        T_ij = self._batched_candidate_icp(pairs)
        added = []
        for k, (i, j) in enumerate(pairs):
            self.graph.add_edge(T_ij[k], int(i), int(j), "SM")
            added.append([int(i), int(j)])
        return added

    def loop_closing_triangle(self, current_index: int,
                              number_of_triplets: int) -> list:
        """(reference loopclosing.py:58-100); returns accepted [i, j] pairs."""
        t0 = _time.time()
        triplets = self.find_feasible_triplets(current_index)
        self.timings["candidate_search_seconds"] += _time.time() - t0
        if not triplets:
            return []
        n = min(len(triplets), number_of_triplets)
        chosen = self.rng.choice(len(triplets), size=n, replace=False)
        triplets = [triplets[k] for k in chosen]

        # one batched ICP dispatch for all (i,j1) and (i,j2) pairs
        pairs = np.array([[t[0], t[1]] for t in triplets]
                         + [[t[0], t[2]] for t in triplets])
        T_all = self._batched_candidate_icp(pairs)
        T_ij1 = T_all[: len(triplets)]
        T_ij2 = T_all[len(triplets):]

        est = self.graph.current_estimate
        T0g_inv = np.linalg.inv(self.graph.T0_gps)
        added = []
        for k, (i, j1, j2) in enumerate(triplets):
            Ta = est[j1] @ T0g_inv
            Tb = est[j2] @ T0g_inv
            T_j1j2 = np.linalg.inv(Ta) @ Tb
            I = T_ij1[k] @ T_j1j2 @ np.linalg.inv(T_ij2[k])
            if self.check_distances(I):
                self.graph.add_edge(T_ij1[k], i, j1, "SM")
                self.graph.add_edge(T_ij2[k], i, j2, "SM")
                added.append([i, j1])
                added.append([i, j2])
        return added
