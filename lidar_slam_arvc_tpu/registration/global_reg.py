"""Global (initialization-free) registration: FPFH matching + batched RANSAC.

Replaces Open3D's ``registration_ransac_based_on_feature_matching`` as used
by the reference (keyframe.py:297-345, global_registration): correspondences
from mutual-nearest FPFH features on the non-ground clouds, RANSAC over
3-point correspondence triplets with the edge-length (0.9) and distance
(fpfh_threshold=5 m) checkers, followed by point-to-plane ICP refinement.

Formulation: feature NN is one tiled (S,33)x(33,T) matmul argmin; all
RANSAC hypotheses are drawn/solved/scored in one batched program — the
3-point rigid solve is a closed-form orthonormal-frame alignment (no SVD),
scoring is a batched correspondence-distance check.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu import geom
from lidar_slam_arvc_tpu.cloud import Cloud
from lidar_slam_arvc_tpu.cloud.fpfh import compute_fpfh
from lidar_slam_arvc_tpu.ops import nn2_search, nn_search
from lidar_slam_arvc_tpu.registration.icp import ICPParams, ICPResult, icp

_HI = jax.lax.Precision.HIGHEST


class GlobalRegParams(NamedTuple):
    fpfh_radius: float = 0.3
    distance_threshold: float = 5.0     # reference fpfh_threshold (keyframe.py:19)
    edge_length_similarity: float = 0.9  # keyframe.py:323-324
    num_hypotheses: int = 8192           # batched stand-in for 100k sequential
    icp: ICPParams = ICPParams()


def _feature_correspondences(feat_src, mask_src, feat_tgt, mask_tgt,
                             ratio: float = 0.95):
    """Mutual nearest neighbors in 33-dim feature space + Lowe ratio test.

    Returns (idx (S,), good (S,)): per-source best target and whether the
    match is reciprocal AND distinctive (best/second-best feature distance
    ratio below ``ratio``).  The reference passes mutual_filter=True to
    Open3D (keyframe.py:318-320); the ratio test further suppresses matches
    in self-similar regions (planes, cylinders) where mutual-NN is still
    near-random.
    """
    idx_st, d1, d2 = nn2_search(feat_src, feat_tgt, mask_tgt,
                                src_block=512, tgt_block=1024)
    idx_ts, _ = nn_search(feat_tgt, feat_src, mask_src,
                          src_block=512, tgt_block=1024)
    s_range = jnp.arange(feat_src.shape[0], dtype=idx_st.dtype)
    mutual = idx_ts[idx_st] == s_range
    distinctive = d1 < (ratio ** 2) * d2
    return idx_st, mutual & distinctive & mask_src


def _three_point_transform(ps, qs):
    """Closed-form rigid T aligning (H,3,3) source triplets to targets.

    Builds an orthonormal frame from each triangle (edge, in-plane normal,
    plane normal) in both clouds; R = F_q F_p^T, t = centroid alignment.
    """
    def frame(tri):
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        u = e1 / jnp.maximum(jnp.linalg.norm(e1, axis=-1, keepdims=True), 1e-9)
        n = jnp.cross(e1, e2)
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        v = jnp.cross(n, u)
        return jnp.stack([u, v, n], axis=-1)  # (H,3,3) columns

    Fp = frame(ps)
    Fq = frame(qs)
    R = jnp.einsum("hij,hkj->hik", Fq, Fp, precision=_HI)
    cp = jnp.mean(ps, axis=1)
    cq = jnp.mean(qs, axis=1)
    t = cq - jnp.einsum("hij,hj->hi", R, cp, precision=_HI)
    return geom.make_transform(t, R)


@functools.partial(jax.jit, static_argnames=("params",))
def ransac_feature_registration(src: Cloud, src_feat, tgt: Cloud, tgt_feat,
                                key, params: GlobalRegParams):
    """Coarse T from FPFH correspondences + batched 3-point RANSAC."""
    corr_idx, mutual = _feature_correspondences(src_feat, src.mask,
                                                tgt_feat, tgt.mask)
    q_of_src = tgt.points[corr_idx]                   # (S,3) matched targets

    # sample 3 source indices per hypothesis among MUTUAL matches
    logits = jnp.where(mutual, 0.0, -jnp.inf)
    any_valid = jnp.any(mutual)
    logits = jnp.where(any_valid, logits, jnp.zeros_like(logits))
    sel = jax.random.categorical(key, logits,
                                 shape=(params.num_hypotheses, 3))
    ps = src.points[sel]                              # (H,3,3)
    qs = q_of_src[sel]

    # edge-length checker (keyframe.py:322-324): similar triangle edges
    def edges(tri):
        return jnp.stack([
            jnp.linalg.norm(tri[:, 1] - tri[:, 0], axis=-1),
            jnp.linalg.norm(tri[:, 2] - tri[:, 1], axis=-1),
            jnp.linalg.norm(tri[:, 0] - tri[:, 2], axis=-1)], axis=-1)

    ep = edges(ps)
    eq = edges(qs)
    sim = params.edge_length_similarity
    ok_edge = jnp.all((ep > sim * eq) & (eq > sim * ep) & (ep > 1e-3),
                      axis=-1)

    T = _three_point_transform(ps, qs)

    # distance checker + scoring on the full correspondence set, chunked
    # over hypotheses so the (H, S, 3) intermediate never materializes
    CHUNK = 256
    T_chunks = T.reshape(-1, CHUNK, 4, 4)

    # MSAC-style truncated scoring at a tight tau: counting inliers at the
    # reference's 5 m checker distance barely separates hypotheses, since
    # most mutual matches fall within 5 m of ANY plausible transform
    tau2 = jnp.minimum(params.distance_threshold, 1.0) ** 2

    def score_chunk(Tc):
        p_all = geom.transform_points(Tc, src.points)        # (C,S,3)
        d2 = jnp.sum((p_all - q_of_src[None]) ** 2, axis=-1)
        w = jnp.maximum(0.0, 1.0 - d2 / tau2) * mutual[None, :]
        return jnp.sum(w, axis=1)

    score = jax.lax.map(score_chunk, T_chunks).reshape(-1)
    score = score * ok_edge
    best = jnp.argmax(score)
    return T[best], score[best]


def global_registration(src: Cloud, tgt: Cloud, key,
                        params: GlobalRegParams = GlobalRegParams(),
                        src_nonground: Cloud | None = None,
                        tgt_nonground: Cloud | None = None) -> ICPResult:
    """Full fpfh method (reference keyframe.py:297-345): FPFH on the
    non-ground clouds -> RANSAC coarse alignment -> point-to-plane ICP
    refinement on the full filtered clouds."""
    sng = src_nonground or src
    tng = tgt_nonground or tgt
    src_feat = compute_fpfh(sng, params.fpfh_radius)
    tgt_feat = compute_fpfh(tng, params.fpfh_radius)
    T0, _ = ransac_feature_registration(sng, src_feat, tng, tgt_feat, key,
                                        params)
    return icp(src, tgt, T0, params.icp, "point_to_plane")
