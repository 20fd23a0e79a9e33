"""Vectorized RANSAC ground-plane estimation and plane segmentation.

Replaces Open3D's C++ ``segment_plane`` as used by the reference's
two-planes scan-matcher preprocessing (keyframe.py:417-461): a plane is
RANSAC-fit to the points below a seed height (z < -0.5 m), then the full
cloud is split into ground / non-ground by point-to-plane distance.

Formulation: all RANSAC hypotheses are drawn and scored at once — a
(iters, 3) categorical sample of candidate points, a batched 3-point plane
construction, and one (iters, N) masked distance matrix for inlier counting.
No sequential hypothesis loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu.cloud.cloud import Cloud

_HI = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("num_iterations",))
def ransac_ground_plane(cloud: Cloud, key: jax.Array,
                        seed_height: float = -0.5,
                        distance_threshold: float = 0.01,
                        num_iterations: int = 1000) -> jax.Array:
    """Best-fit plane [a, b, c, d] (unit normal) near the ground.

    Semantics of reference keyframe.py:417-437 (calculate_plane): fit only
    points with z < seed_height, RANSAC with ``num_iterations`` triplets and
    ``distance_threshold`` inliers, then least-squares refine on the winning
    inlier set (as Open3D's segment_plane does).
    """
    pts = cloud.points
    cand = cloud.mask & (pts[:, 2] < seed_height)
    logits = jnp.where(cand, 0.0, -jnp.inf)
    # guard: no candidates at all -> sample uniformly (result is degenerate
    # but finite; callers only use the plane to split, yielding empty ground)
    any_cand = jnp.any(cand)
    logits = jnp.where(any_cand, logits, jnp.zeros_like(logits))

    idx = jax.random.categorical(key, logits, shape=(num_iterations, 3))
    p0 = pts[idx[:, 0]]
    p1 = pts[idx[:, 1]]
    p2 = pts[idx[:, 2]]
    n = jnp.cross(p1 - p0, p2 - p0)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    d = -jnp.sum(n * p0, axis=-1)

    # inlier counts over candidate points: (iters, N) distances
    dist = jnp.abs(jnp.dot(n, pts.T, precision=_HI) + d[:, None])
    inlier = (dist < distance_threshold) & cand[None, :]
    counts = jnp.sum(inlier, axis=1)
    counts = jnp.where(norm[:, 0] > 1e-9, counts, -1)  # degenerate triplets

    best = jnp.argmax(counts)
    best_inliers = inlier[best]
    plane = jnp.concatenate([n[best], d[best][None]])
    return refine_plane_lsq(pts, best_inliers, fallback=plane)


def refine_plane_lsq(points: jax.Array, inlier_mask: jax.Array,
                     fallback: jax.Array) -> jax.Array:
    """Least-squares plane through masked points (centroid + min-eigvec)."""
    from lidar_slam_arvc_tpu.ops import smallest_eigenvector_sym3

    w = inlier_mask.astype(points.dtype)
    n_in = jnp.sum(w)
    safe_n = jnp.maximum(n_in, 1.0)
    mean = jnp.sum(points * w[:, None], axis=0) / safe_n
    centered = (points - mean) * w[:, None]
    cov = jnp.dot(centered.T, centered, precision=_HI) / safe_n
    normal = smallest_eigenvector_sym3(cov)
    d = -jnp.dot(normal, mean)
    refined = jnp.concatenate([normal, d[None]])
    return jnp.where(n_in >= 3, refined, fallback)


def split_by_plane(cloud: Cloud, plane: jax.Array,
                   distance_threshold: float = 0.4):
    """(ground, non_ground) clouds by point-to-plane distance.

    Same classification as reference keyframe.py:439-461 (segment_plane):
    |a x + b y + c z + d| / ||(a,b,c)|| < threshold -> ground.
    Both outputs share the input's points buffer; only masks differ.
    """
    n = plane[:3]
    d = plane[3]
    denom = jnp.maximum(jnp.linalg.norm(n), 1e-12)
    dist = jnp.abs(cloud.points @ n + d) / denom
    is_ground = dist < distance_threshold
    ground = Cloud(points=cloud.points, mask=cloud.mask & is_ground,
                   normals=cloud.normals)
    non_ground = Cloud(points=cloud.points, mask=cloud.mask & ~is_ground,
                       normals=cloud.normals)
    return ground, non_ground
