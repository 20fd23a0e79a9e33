"""Tiled brute-force nearest-neighbor search and radius accumulation.

This replaces the reference's KD-tree queries (Open3D/FLANN inside
``registration_icp`` and ``KDTreeSearchParamHybrid``, reference
keyframemanager/keyframe.py:160-162,246-252).  Pointer-chasing trees map
poorly to accelerators; instead distances are computed tile-by-tile with
the matmul identity  ||s-t||^2 = ||s||^2 + ||t||^2 - 2 s.t  and a running
argmin/accumulator per tile.  For LiDAR-scale clouds (10-100k points) the
exact O(S*T) sweep is a few GFLOP, so it beats tree construction +
irregular traversal while being exact.

This is the plain version that runs on every backend; on CUDA GPUs
ops.select swaps in the fused kernels of ops.nn_pallas and
ops.moments_pallas for the 3-D sweep and the ball moments.

Two access patterns:
  * :func:`nn_search` — per-source-point nearest target (ICP correspondence),
  * :func:`radius_accumulate` — per-query count/mean/covariance moments over
    an epsilon-ball (normal estimation), computed as three masked matmuls
    without materializing neighbor lists.

Masked-out target points are excluded via a +BIG distance offset; masked
source rows produce garbage that callers must gate with their own mask.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST
_BIG = 1e12


def _pad_rows(x: jax.Array, block: int, fill: float = 0.0):
    n = x.shape[0]
    rem = (-n) % block
    if rem:
        pad_width = ((0, rem),) + ((0, 0),) * (x.ndim - 1)
        x = jnp.pad(x, pad_width, constant_values=fill)
    return x, n


@functools.partial(jax.jit, static_argnames=("src_block", "tgt_block"))
def nn_search(src: jax.Array, tgt: jax.Array, tgt_mask: jax.Array,
              src_block: int = 1024, tgt_block: int = 2048):
    """Nearest target index + squared distance for every source point.

    Args:
      src: (S, D) query points (D = 3 for clouds; any D, e.g. 33-dim
        FPFH features, works — the sweep is dimension-agnostic).
      tgt: (T, D) target points.
      tgt_mask: (T,) validity of target points (False rows never match).
    Returns:
      (idx (S,) int32, dist2 (S,) f32) — exact nearest among valid targets.
    """
    S, D = src.shape
    src_p, _ = _pad_rows(src, src_block)
    tgt_p, T = _pad_rows(tgt, tgt_block)
    mask_p, _ = _pad_rows(tgt_mask[:, None].astype(src.dtype), tgt_block)
    mask_p = mask_p[:, 0]

    t2 = jnp.sum(tgt_p * tgt_p, axis=-1) + jnp.where(mask_p > 0, 0.0, _BIG)
    n_tiles = tgt_p.shape[0] // tgt_block
    tgt_tiles = tgt_p.reshape(n_tiles, tgt_block, D)
    t2_tiles = t2.reshape(n_tiles, tgt_block)

    def per_chunk(src_chunk):
        s2 = jnp.sum(src_chunk * src_chunk, axis=-1)

        def body(carry, tile):
            best_d2, best_idx = carry
            tgt_tile, t2_tile, tile_start = tile
            cross = jnp.dot(src_chunk, tgt_tile.T, precision=_HI)
            d2 = s2[:, None] + t2_tile[None, :] - 2.0 * cross
            tile_min = jnp.min(d2, axis=1)
            tile_arg = jnp.argmin(d2, axis=1).astype(jnp.int32) + tile_start
            better = tile_min < best_d2
            return (jnp.where(better, tile_min, best_d2),
                    jnp.where(better, tile_arg, best_idx)), None

        init = (jnp.full(src_chunk.shape[0], jnp.inf, dtype=src.dtype),
                jnp.zeros(src_chunk.shape[0], dtype=jnp.int32))
        starts = (jnp.arange(n_tiles, dtype=jnp.int32) * tgt_block)
        (best_d2, best_idx), _ = jax.lax.scan(
            body, init, (tgt_tiles, t2_tiles, starts))
        return best_d2, best_idx

    chunks = src_p.reshape(-1, src_block, D)
    d2, idx = jax.lax.map(per_chunk, chunks)
    d2 = d2.reshape(-1)[:S]
    idx = idx.reshape(-1)[:S]
    # numerical floor: the matmul identity can give tiny negatives
    d2 = jnp.maximum(d2, 0.0)
    return idx, d2


@functools.partial(jax.jit, static_argnames=("src_block", "tgt_block"))
def nn2_search(src: jax.Array, tgt: jax.Array, tgt_mask: jax.Array,
               src_block: int = 1024, tgt_block: int = 2048):
    """Top-2 nearest targets per source row: (idx1, d2_1, d2_2).

    Used for Lowe-style ratio tests on feature matches (global
    registration).  Same tiled sweep as :func:`nn_search` with a
    two-slot running minimum.
    """
    S, D = src.shape
    src_p, _ = _pad_rows(src, src_block)
    tgt_p, _ = _pad_rows(tgt, tgt_block)
    mask_p, _ = _pad_rows(tgt_mask[:, None].astype(src.dtype), tgt_block)
    mask_p = mask_p[:, 0]

    t2 = jnp.sum(tgt_p * tgt_p, axis=-1) + jnp.where(mask_p > 0, 0.0, _BIG)
    n_tiles = tgt_p.shape[0] // tgt_block
    tgt_tiles = tgt_p.reshape(n_tiles, tgt_block, D)
    t2_tiles = t2.reshape(n_tiles, tgt_block)

    def per_chunk(src_chunk):
        s2 = jnp.sum(src_chunk * src_chunk, axis=-1)

        def body(carry, tile):
            b1, i1, b2 = carry
            tgt_tile, t2_tile, tile_start = tile
            cross = jnp.dot(src_chunk, tgt_tile.T, precision=_HI)
            d2 = s2[:, None] + t2_tile[None, :] - 2.0 * cross
            tile_min = jnp.min(d2, axis=1)
            tile_arg = jnp.argmin(d2, axis=1).astype(jnp.int32) + tile_start
            # second-best within the tile (mask out the argmin column)
            cols = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
            d2_wo = jnp.where(cols == (tile_arg - tile_start)[:, None],
                              jnp.inf, d2)
            tile_min2 = jnp.min(d2_wo, axis=1)
            # merge two sorted pairs
            new_b1 = jnp.minimum(b1, tile_min)
            new_i1 = jnp.where(tile_min < b1, tile_arg, i1)
            cand2 = jnp.where(tile_min < b1,
                              jnp.minimum(b1, tile_min2),
                              jnp.minimum(b2, tile_min))
            return (new_b1, new_i1, cand2), None

        init = (jnp.full(src_chunk.shape[0], jnp.inf, dtype=src.dtype),
                jnp.zeros(src_chunk.shape[0], dtype=jnp.int32),
                jnp.full(src_chunk.shape[0], jnp.inf, dtype=src.dtype))
        starts = jnp.arange(n_tiles, dtype=jnp.int32) * tgt_block
        (b1, i1, b2), _ = jax.lax.scan(body, init,
                                       (tgt_tiles, t2_tiles, starts))
        return b1, i1, b2

    chunks = src_p.reshape(-1, src_block, D)
    d2_1, idx, d2_2 = jax.lax.map(per_chunk, chunks)
    return (idx.reshape(-1)[:S],
            jnp.maximum(d2_1.reshape(-1)[:S], 0.0),
            jnp.maximum(d2_2.reshape(-1)[:S], 0.0))


@functools.partial(jax.jit, static_argnames=("query_block", "tgt_block"))
def radius_accumulate(query: jax.Array, tgt: jax.Array, tgt_mask: jax.Array,
                      radius: float, query_block: int = 1024,
                      tgt_block: int = 2048):
    """Ball-neighborhood moments for every query point.

    Returns (count (Q,), S1 (Q,3), S2 (Q,6)) where S1/S2 are the sums of
    neighbor coordinates and their outer-product upper triangles
    (xx,xy,xz,yy,yz,zz).  The caller turns these into mean + covariance —
    the input to normal estimation — without ever materializing neighbor
    lists.  All three accumulations are masked matmuls.

    Precision note: these matmuls run at Precision.HIGHEST on purpose and it
    is load-bearing — the raw (origin-referenced) moments feed
    cloud.normals._cov_from_moments, whose cov = S2/n - m m^T subtraction
    catastrophically cancels if S2 is accumulated in bfloat16 or TF32.
    """
    Q = query.shape[0]
    q_p, _ = _pad_rows(query, query_block)
    tgt_p, _ = _pad_rows(tgt, tgt_block)
    mask_p, _ = _pad_rows(tgt_mask[:, None].astype(query.dtype), tgt_block)
    mask_p = mask_p[:, 0]

    r2 = jnp.asarray(radius, dtype=query.dtype) ** 2
    t2 = jnp.sum(tgt_p * tgt_p, axis=-1) + jnp.where(mask_p > 0, 0.0, _BIG)
    x, y, z = tgt_p[:, 0], tgt_p[:, 1], tgt_p[:, 2]
    feats = jnp.stack(  # (T, 9): p and upper-triangular p p^T
        [x, y, z, x * x, x * y, x * z, y * y, y * z, z * z], axis=-1)

    n_tiles = tgt_p.shape[0] // tgt_block
    tgt_tiles = tgt_p.reshape(n_tiles, tgt_block, 3)
    t2_tiles = t2.reshape(n_tiles, tgt_block)
    feat_tiles = feats.reshape(n_tiles, tgt_block, 9)

    def per_chunk(q_chunk):
        s2 = jnp.sum(q_chunk * q_chunk, axis=-1)

        def body(carry, tile):
            count, moments = carry
            tgt_tile, t2_tile, feat_tile = tile
            cross = jnp.dot(q_chunk, tgt_tile.T, precision=_HI)
            d2 = s2[:, None] + t2_tile[None, :] - 2.0 * cross
            w = (d2 <= r2).astype(q_chunk.dtype)
            count = count + jnp.sum(w, axis=1)
            moments = moments + jnp.dot(w, feat_tile, precision=_HI)
            return (count, moments), None

        init = (jnp.zeros(q_chunk.shape[0], dtype=query.dtype),
                jnp.zeros((q_chunk.shape[0], 9), dtype=query.dtype))
        (count, moments), _ = jax.lax.scan(
            body, init, (tgt_tiles, t2_tiles, feat_tiles))
        return count, moments

    chunks = q_p.reshape(-1, query_block, 3)
    count, moments = jax.lax.map(per_chunk, chunks)
    count = count.reshape(-1)[:Q]
    moments = moments.reshape(-1, 9)[:Q]
    return count, moments[:, :3], moments[:, 3:]
