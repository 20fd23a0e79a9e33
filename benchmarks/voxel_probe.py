"""Fine-grained voxel-downsample cost breakdown on the local device.

preprocess_breakdown.py splits batch preprocess into crop, voxel and
normals.  This probe splits the voxel stage itself — key compute, the
sort, the post-sort gathers, the scatter-add — to decide what to attack
(a faster sort only pays if the sort dominates).

All variants run as ONE chained jitted program family; timing forces
np.asarray host transfers.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu import cloud as cl
from lidar_slam_arvc_tpu.utils import synthetic

N_SCANS = int(os.environ.get("BENCH_SCANS", 257))
SCAN_POINTS = int(os.environ.get("BENCH_POINTS", 12000))
CAP_RAW = int(os.environ.get("BENCH_CAP_RAW", 16384))
CAP = int(os.environ.get("BENCH_CAP", 8192))
VOXEL = 0.2
REPS = int(os.environ.get("BENCH_REPS", 5))

rng = np.random.default_rng(0)
world = synthetic.make_world(rng, extent=30.0, n_ground=20000,
                             n_pillars=40, pillar_pts=500)
T = synthetic.make_trajectory(N_SCANS, radius=12.0)
scans = [synthetic.render_scan(world, T[i], rng, max_range=25.0,
                               max_points=SCAN_POINTS)
         for i in range(N_SCANS)]
stacked = [cl.from_numpy(s, CAP_RAW) for s in scans]
raw_pts = jnp.stack([c.points for c in stacked])
raw_mask = jnp.stack([c.mask for c in stacked])


def _sync(out):
    # completion barrier via a SCALAR host fetch: a 1-element fetch still
    # depends on the whole computation without timing a large transfer
    leaf = jax.tree_util.tree_leaves(out)[0]
    np.asarray(leaf[(0,) * leaf.ndim])


def timeit(fn, label):
    out = fn()
    _sync(out)
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = fn()
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    print(f"{label}: {best*1e3:.2f} ms for {N_SCANS} scans "
          f"({best*1e3/N_SCANS:.3f} ms/scan)", flush=True)
    return best


def _keys(pp, mm):
    c = cl.crop_radius_height(cl.Cloud(pp, mm), 0.5, 35.0, -1.0, 50.0)
    pts, valid = c.points, c.mask
    vsize = jnp.float32(VOXEL)
    masked = jnp.where(valid[:, None], pts, jnp.inf)
    mins = jnp.min(masked, axis=0)
    mins = jnp.where(jnp.isfinite(mins), mins, 0.0)
    ijk = jnp.floor((pts - mins) / vsize).astype(jnp.int32)
    ijk = jnp.clip(ijk, 0, jnp.asarray([2047, 2047, 1023], jnp.int32))
    key = (ijk[:, 0] << 21) | (ijk[:, 1] << 10) | ijk[:, 2]
    return jnp.where(valid, key, jnp.int32(2 ** 31 - 1)), pts, valid


@jax.jit
def keys_only(p, m):
    return jax.vmap(_keys)(p, m)


@jax.jit
def keys_argsort(p, m):
    def one(pp, mm):
        key, pts, valid = _keys(pp, mm)
        return jnp.argsort(key)
    return jax.vmap(one)(p, m)


@jax.jit
def keys_sortkv(p, m):
    def one(pp, mm):
        key, pts, valid = _keys(pp, mm)
        return jax.lax.sort_key_val(key, jnp.arange(key.shape[0], dtype=jnp.int32))
    return jax.vmap(one)(p, m)


@jax.jit
def keys_sort_payload4(p, m):
    # sort carrying the three coordinate columns + validity directly
    def one(pp, mm):
        key, pts, valid = _keys(pp, mm)
        out = jax.lax.sort((key, pts[:, 0], pts[:, 1], pts[:, 2],
                            valid.astype(jnp.int32)), num_keys=1)
        return out[0], out[1]
    return jax.vmap(one)(p, m)


@jax.jit
def sort_and_gather(p, m):
    def one(pp, mm):
        key, pts, valid = _keys(pp, mm)
        order = jnp.argsort(key)
        return key[order], pts[order], valid[order]
    return jax.vmap(one)(p, m)


@jax.jit
def full_voxel(p, m):
    def one(pp, mm):
        c = cl.crop_radius_height(cl.Cloud(pp, mm), 0.5, 35.0, -1.0, 50.0)
        c, n = cl.voxel_downsample_counted(c, VOXEL, out_capacity=CAP)
        return c.points, c.mask
    return jax.vmap(one)(p, m)


@jax.jit
def full_preprocess(p, m):
    def one(pp, mm):
        c = cl.crop_radius_height(cl.Cloud(pp, mm), 0.5, 35.0, -1.0, 50.0)
        c = cl.voxel_downsample(c, VOXEL, out_capacity=CAP)
        c = cl.estimate_normals(c, radius=0.3)
        return c.points, c.mask, c.normals
    return jax.vmap(one)(p, m)


t_k = timeit(lambda: keys_only(raw_pts, raw_mask), "crop+keys")
t_a = timeit(lambda: keys_argsort(raw_pts, raw_mask), "crop+keys+argsort")
t_s = timeit(lambda: keys_sortkv(raw_pts, raw_mask), "crop+keys+sort_key_val")
t_p4 = timeit(lambda: keys_sort_payload4(raw_pts, raw_mask),
              "crop+keys+sort(4 payloads)")
t_g = timeit(lambda: sort_and_gather(raw_pts, raw_mask),
             "crop+keys+argsort+gathers")
t_v = timeit(lambda: full_voxel(raw_pts, raw_mask), "crop+voxel (full)")
t_f = timeit(lambda: full_preprocess(raw_pts, raw_mask),
             "crop+voxel+normals (full preprocess)")
print(f"deltas/scan: sort {1e3*(t_a-t_k)/N_SCANS:.3f} ms, "
      f"gathers {1e3*(t_g-t_a)/N_SCANS:.3f} ms, "
      f"scatter+rest {1e3*(t_v-t_g)/N_SCANS:.3f} ms, "
      f"normals {1e3*(t_f-t_v)/N_SCANS:.3f} ms", flush=True)
