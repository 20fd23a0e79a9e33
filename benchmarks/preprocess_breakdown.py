"""Per-stage timing of the scan preprocess pipeline on the local device.

Times, for a bench.py-sized batch of raw scans (33 x 16384 capacity):
  1. crop_radius_height alone,
  2. crop + voxel_downsample,
  3. crop + voxel + estimate_normals (the full preprocess),
each as one jitted vmapped program, so stage costs come from differences.
Each timing ends in a host transfer of the result.
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

N_SCANS = int(os.environ.get("BENCH_SCANS", 33))
SCAN_POINTS = int(os.environ.get("BENCH_POINTS", 12000))
CAP_RAW = int(os.environ.get("BENCH_CAP_RAW", 16384))
CAP = int(os.environ.get("BENCH_CAP", 8192))
VOXEL = 0.2
REPS = 10

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


def timeit(fn, label):
    out = fn()
    np.asarray(jax.tree_util.tree_leaves(out)[0])
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn()
    np.asarray(jax.tree_util.tree_leaves(out)[0])
    dt = (time.perf_counter() - t0) / REPS
    print(f"{label}: {dt*1e3:.2f} ms for {N_SCANS} scans "
          f"({dt*1e3/N_SCANS:.3f} ms/scan)", flush=True)
    return dt


@jax.jit
def crop_only(p, m):
    def one(pp, mm):
        c = cl.crop_radius_height(cl.Cloud(pp, mm), 0.5, 35.0, -1.0, 50.0)
        return c.points, c.mask
    return jax.vmap(one)(p, m)


@jax.jit
def crop_voxel(p, m):
    def one(pp, mm):
        c = cl.crop_radius_height(cl.Cloud(pp, mm), 0.5, 35.0, -1.0, 50.0)
        c = cl.voxel_downsample(c, VOXEL, out_capacity=CAP)
        return c.points, c.mask
    return jax.vmap(one)(p, m)


@jax.jit
def full(p, m):
    def one(pp, mm):
        c = cl.crop_radius_height(cl.Cloud(pp, mm), 0.5, 35.0, -1.0, 50.0)
        c = cl.voxel_downsample(c, VOXEL, out_capacity=CAP)
        c = cl.estimate_normals(c, radius=0.3)
        return c.points, c.mask, c.normals
    return jax.vmap(one)(p, m)


t_crop = timeit(lambda: crop_only(raw_pts, raw_mask), "crop")
t_cv = timeit(lambda: crop_voxel(raw_pts, raw_mask), "crop+voxel")
t_full = timeit(lambda: full(raw_pts, raw_mask), "crop+voxel+normals")
print(f"stage deltas: voxel {1e3*(t_cv-t_crop):.2f} ms, "
      f"normals {1e3*(t_full-t_cv):.2f} ms", flush=True)
