"""Voxel-grid downsampling with static shapes.

Replaces Open3D's C++ ``voxel_down_sample`` (reference keyframe.py:108-111):
each voxel's points are replaced by their centroid.  Formulation:
pack voxel indices into one 32-bit key, sort, detect run starts, assign
compacted output slots with a cumulative sum, and scatter-add coordinates —
all static-shape device ops (no host compaction).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu.cloud.cloud import Cloud

# key packing: 11 bits x | 11 bits y | 10 bits z  (32-bit total)
_BITS_X, _BITS_Y, _BITS_Z = 11, 11, 10


def addressable_extent(voxel_size: float) -> tuple[float, float]:
    """(xy, z) metres addressable by the packed key at this cell size.

    Beyond this the grid clips at the border and merges the far field into
    border voxels — callers that know their crop bounds (the pipeline does)
    should reject too-fine grids at trace time rather than corrupt
    geometry.  Full-resolution clouds must use ``cloud.compact_counted``,
    never a degenerate fine grid.
    """
    return ((2 ** _BITS_X - 1) * voxel_size, (2 ** _BITS_Z - 1) * voxel_size)


def _segment_sums_sorted(key_s, vals, valid_s, out_capacity: int):
    """Per-voxel (sums, counts, n_voxels) from KEY-SORTED per-point values.

    Combine with NO scatter and NO gather: XLA can lower scatter-add with
    potentially-colliding indices to a serialized update loop, and
    random-index gathers are costly at capacity 16384
    (benchmarks/voxel_probe.py).  Instead:

      1. run starts from key changes (first), n_voxels = sum(first),
      2. REVERSE segmented scan (log2 N shifted masked adds, elementwise)
         accumulates each run's total at its START row — exact f32, sums
         never cross run boundaries,
      3. a second payload sort with key (first ? position : MAX) compacts
         the run-start rows to the front IN KEY ORDER (run starts appear
         in ascending key order, and position order preserves that).

    ``vals`` is (N, C) with invalid rows already zeroed; counts come from a
    ones column.  Returns ((out_capacity, C) sums, (out_capacity,) counts,
    n_voxels-before-truncation).
    """
    n = key_s.shape[0]
    first = jnp.concatenate(
        [valid_s[:1], key_s[1:] != key_s[:-1]]) & valid_s
    n_voxels = jnp.sum(first.astype(jnp.int32))

    # reverse segmented scan: x[i] += x[i+d] while the run id matches.
    # Invalid rows share the preceding run's id but carry zeroed vals, so
    # they extend the run without changing its total.
    seg = jnp.cumsum(first.astype(jnp.int32))
    d = 1
    while d < n:
        same = seg[:-d] == seg[d:]
        vals = vals.at[:-d].add(jnp.where(same[:, None], vals[d:], 0.0))
        d *= 2

    # stable compaction of run starts via a second payload sort
    pos = jnp.arange(n, dtype=jnp.int32)
    key2 = jnp.where(first, pos, jnp.int32(2 ** 31 - 1))
    sorted_cols = jax.lax.sort(
        (key2,) + tuple(vals[:, c] for c in range(vals.shape[1])),
        num_keys=1)
    out = jnp.stack(sorted_cols[1:], axis=1)[:out_capacity]
    if out_capacity > n:          # more slots than input rows: zero-pad
        out = jnp.pad(out, ((0, out_capacity - n), (0, 0)))
    live = jnp.arange(out_capacity) < jnp.minimum(n_voxels, out_capacity)
    out = jnp.where(live[:, None], out, 0.0)
    return out[:, :-1], out[:, -1], n_voxels


@functools.partial(jax.jit, static_argnames=("out_capacity",))
def voxel_downsample_counted(cloud: Cloud, voxel_size: float,
                             out_capacity: int | None = None):
    """Centroid-per-voxel downsample, returning (Cloud, n_voxels).

    ``n_voxels`` is the occupied-voxel count BEFORE capacity truncation, so
    ``max(n_voxels - out_capacity, 0)`` is the number of silently dropped
    voxels — the pipeline surfaces this in its profile artifact instead of
    losing the densest tail without a trace (the full-resolution
    loop-closure regime of reference run_graphSLAM.py:224 routinely exceeds
    16k points per scan).

    out_capacity defaults to the input capacity.  Grid extents beyond
    2048 x 2048 x 1024 voxels (e.g. 100m+ range at 5cm voxels) clip at the
    border — unreachable under the pipeline's radius/height crop.  If the
    number of occupied voxels exceeds out_capacity the tail voxels
    (highest keys) are dropped.
    """
    capacity = cloud.points.shape[0]
    if out_capacity is None:
        out_capacity = capacity
    pts = cloud.points
    valid = cloud.mask

    vsize = jnp.asarray(voxel_size, dtype=pts.dtype)
    # min corner over valid points (invalid rows excluded via +inf)
    masked = jnp.where(valid[:, None], pts, jnp.inf)
    mins = jnp.min(masked, axis=0)
    mins = jnp.where(jnp.isfinite(mins), mins, 0.0)
    ijk = jnp.floor((pts - mins) / vsize).astype(jnp.int32)
    ijk = jnp.clip(ijk, 0, jnp.asarray(
        [2 ** _BITS_X - 1, 2 ** _BITS_Y - 1, 2 ** _BITS_Z - 1], dtype=jnp.int32))
    key = ((ijk[:, 0] << (_BITS_Y + _BITS_Z))
           | (ijk[:, 1] << _BITS_Z)
           | ijk[:, 2])
    # invalid points get the max key so they sort to the end
    key = jnp.where(valid, key, jnp.int32(2 ** 31 - 1))

    # one variadic sort carries the coordinates as payload, saving the
    # three post-sort gathers (benchmarks/voxel_probe.py)
    valid_f = valid.astype(pts.dtype)
    key_s, x_s, y_s, z_s, valid_sf = jax.lax.sort(
        (key, pts[:, 0] * valid_f, pts[:, 1] * valid_f,
         pts[:, 2] * valid_f, valid_f), num_keys=1)
    valid_s = valid_sf > 0.5

    vals = jnp.stack([x_s, y_s, z_s, valid_sf], axis=1)   # zeros if invalid
    sums, counts, n_voxels = _segment_sums_sorted(key_s, vals, valid_s,
                                                  out_capacity)
    centroids = sums / jnp.maximum(counts[:, None], 1.0)
    out_mask = jnp.arange(out_capacity) < jnp.minimum(n_voxels, out_capacity)
    return Cloud(points=jnp.where(out_mask[:, None], centroids, 0.0),
                 mask=out_mask), n_voxels


def voxel_downsample(cloud: Cloud, voxel_size: float,
                     out_capacity: int | None = None) -> Cloud:
    """voxel_downsample_counted without the occupancy count (see there)."""
    return voxel_downsample_counted(cloud, voxel_size, out_capacity)[0]
