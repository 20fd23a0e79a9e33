"""FPFH (Fast Point Feature Histogram) descriptors, batched on device.

Replaces Open3D's C++ ``compute_fpfh_feature`` (reference
keyframe.py:227-229): 33-dim histograms (11 bins x 3 Darboux angles) used to
seed global registration.

Formulation (no neighbor lists): both SPFH passes stream over target
tiles.  Pass 1 accumulates the 33 per-angle-bin counts with masked
reductions; pass 2 (the 1/d-weighted neighbor mixing) is a masked
(Q,T)x(T,33) matmul.  Exact over the epsilon-ball (no
max_nn cap, like cloud.normals).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu.cloud.cloud import Cloud

_HI = jax.lax.Precision.HIGHEST
_BIG = 1e12
N_BINS = 11


def _pad_rows(x, block, fill=0.0):
    n = x.shape[0]
    rem = (-n) % block
    if rem:
        x = jnp.pad(x, ((0, rem),) + ((0, 0),) * (x.ndim - 1),
                    constant_values=fill)
    return x


def _pair_angles(p, n_p, q, n_q):
    """Darboux-frame features (f1=cos(alpha), f2=cos(phi), f3=theta) for all
    pairs of a (Q,3) query tile against a (T,3) target tile.

    Uses the standard PFH angle set: with d = (q - p)/|q - p|,
      u = n_p, v = d x u, w = u x v,
      f1 = v . n_q, f2 = u . d, f3 = atan2(w . n_q, u . n_q).
    """
    diff = q[None, :, :] - p[:, None, :]            # (Q,T,3)
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    d = diff / jnp.maximum(dist[..., None], 1e-12)
    u = n_p[:, None, :]                              # (Q,1,3)
    v = jnp.cross(d, jnp.broadcast_to(u, d.shape))
    v = v / jnp.maximum(
        jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    w = jnp.cross(jnp.broadcast_to(u, d.shape), v)
    nq = n_q[None, :, :]
    f1 = jnp.sum(v * nq, axis=-1)                    # cos(alpha) in [-1,1]
    f2 = jnp.sum(d * jnp.broadcast_to(u, d.shape), axis=-1)  # cos(phi)
    f3 = jnp.arctan2(jnp.sum(w * nq, axis=-1),
                     jnp.sum(jnp.broadcast_to(u, d.shape) * nq, axis=-1))
    return f1, f2, f3, dist


def _bin_index(f, lo, hi):
    b = jnp.floor((f - lo) / (hi - lo) * N_BINS).astype(jnp.int32)
    return jnp.clip(b, 0, N_BINS - 1)


@functools.partial(jax.jit, static_argnames=("query_block", "tgt_block"))
def _spfh(points, normals, mask, radius, query_block=256, tgt_block=1024):
    """(N, 33) unnormalized SPFH histograms + (N,) neighbor counts."""
    N = points.shape[0]
    maskf = mask.astype(points.dtype)
    q_p = _pad_rows(points, query_block)
    q_n = _pad_rows(normals, query_block)
    t_p = _pad_rows(points, tgt_block)
    t_n = _pad_rows(normals, tgt_block)
    t_m = _pad_rows(maskf[:, None], tgt_block)[:, 0]
    r = jnp.asarray(radius, dtype=points.dtype)

    n_tiles = t_p.shape[0] // tgt_block
    t_p_tiles = t_p.reshape(n_tiles, tgt_block, 3)
    t_n_tiles = t_n.reshape(n_tiles, tgt_block, 3)
    t_m_tiles = t_m.reshape(n_tiles, tgt_block)

    def per_chunk(args):
        qp, qn = args

        def body(carry, tile):
            hist, count = carry
            tp, tn, tm = tile
            f1, f2, f3, dist = _pair_angles(qp, qn, tp, tn)
            w = ((dist <= r) & (dist > 1e-9)).astype(qp.dtype) * tm[None, :]
            b1 = _bin_index(f1, -1.0, 1.0)
            b2 = _bin_index(f2, -1.0, 1.0)
            b3 = _bin_index(f3, -jnp.pi, jnp.pi)
            for b in range(N_BINS):
                hist = hist.at[:, b].add(
                    jnp.sum(w * (b1 == b), axis=1))
                hist = hist.at[:, N_BINS + b].add(
                    jnp.sum(w * (b2 == b), axis=1))
                hist = hist.at[:, 2 * N_BINS + b].add(
                    jnp.sum(w * (b3 == b), axis=1))
            count = count + jnp.sum(w, axis=1)
            return (hist, count), None

        init = (jnp.zeros((qp.shape[0], 3 * N_BINS), dtype=qp.dtype),
                jnp.zeros(qp.shape[0], dtype=qp.dtype))
        (hist, count), _ = jax.lax.scan(
            body, init, (t_p_tiles, t_n_tiles, t_m_tiles))
        return hist, count

    chunks = (q_p.reshape(-1, query_block, 3),
              q_n.reshape(-1, query_block, 3))
    hist, count = jax.lax.map(per_chunk, chunks)
    return hist.reshape(-1, 3 * N_BINS)[:N], count.reshape(-1)[:N]


@functools.partial(jax.jit, static_argnames=("query_block", "tgt_block"))
def compute_fpfh(cloud: Cloud, radius: float = 0.3,
                 query_block: int = 256, tgt_block: int = 1024) -> jax.Array:
    """(capacity, 33) FPFH descriptors (invalid rows = zeros).

    Pass 1: SPFH per point.  Pass 2: FPFH_i = SPFH_i + (1/k) sum_j
    SPFH_j / d_ij over ball neighbors (PCL weighting), then per-row
    normalization to sum 100 per 11-bin block (Open3D convention is
    per-feature normalized; any fixed scaling works for matching).
    """
    if cloud.normals is None:
        raise ValueError("compute_fpfh needs normals (cloud.estimate_normals)")
    points, normals, mask = cloud.points, cloud.normals, cloud.mask
    N = points.shape[0]
    spfh, count = _spfh(points, normals, mask, radius,
                        query_block, tgt_block)

    # pass 2: weighted neighbor mixing, streaming masked matmul
    maskf = mask.astype(points.dtype)
    q_p = _pad_rows(points, query_block)
    t_p = _pad_rows(points, tgt_block)
    t_m = _pad_rows(maskf[:, None], tgt_block)[:, 0]
    t_f = _pad_rows(spfh, tgt_block)
    r = jnp.asarray(radius, dtype=points.dtype)

    n_tiles = t_p.shape[0] // tgt_block
    t_p_tiles = t_p.reshape(n_tiles, tgt_block, 3)
    t_m_tiles = t_m.reshape(n_tiles, tgt_block)
    t_f_tiles = t_f.reshape(n_tiles, tgt_block, 3 * N_BINS)

    def per_chunk(qp):
        def body(carry, tile):
            acc, wsum = carry
            tp, tm, tf = tile
            diff = tp[None, :, :] - qp[:, None, :]
            dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
            w = (((dist <= r) & (dist > 1e-9)).astype(qp.dtype)
                 * tm[None, :]) / jnp.maximum(dist, 1e-6)
            acc = acc + jnp.dot(w, tf, precision=_HI)
            wsum = wsum + jnp.sum(w, axis=1)
            return (acc, wsum), None

        init = (jnp.zeros((qp.shape[0], 3 * N_BINS), dtype=qp.dtype),
                jnp.zeros(qp.shape[0], dtype=qp.dtype))
        (acc, wsum), _ = jax.lax.scan(
            body, init, (t_p_tiles, t_m_tiles, t_f_tiles))
        return acc, wsum

    acc, wsum = jax.lax.map(per_chunk, q_p.reshape(-1, query_block, 3))
    acc = acc.reshape(-1, 3 * N_BINS)[:N]
    wsum = wsum.reshape(-1)[:N]

    # PCL weighting: FPFH(p) = SPFH(p) + (1/k) sum_j SPFH(j)/d_j
    k = jnp.maximum(count, 1.0)
    fpfh = spfh + acc / k[:, None]
    # normalize each 11-bin block to sum 100 (scale-invariant matching)
    out = []
    for blk in range(3):
        h = fpfh[:, blk * N_BINS:(blk + 1) * N_BINS]
        s = jnp.sum(h, axis=1, keepdims=True)
        out.append(100.0 * h / jnp.maximum(s, 1e-6))
    fpfh = jnp.concatenate(out, axis=1)
    return jnp.where(mask[:, None], fpfh, 0.0)
