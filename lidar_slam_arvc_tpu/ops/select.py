"""One choice between the GPU kernels and the plain XLA versions.

The correspondence sweep and the ball moments each have a hand-written
kernel for CUDA GPUs (ops.nn_pallas, ops.moments_pallas) and a plain XLA
version (ops.nn) that runs everywhere.  :func:`on_gpu` decides between
them when the program is lowered for its device, so a computation placed
on the CPU of a GPU host still takes the plain path; kernels are never run
in the Pallas interpreter outside tests.
"""

from __future__ import annotations

import functools

import jax

from lidar_slam_arvc_tpu.ops.moments_pallas import ball_moments_pallas
from lidar_slam_arvc_tpu.ops.nn import nn_search, radius_accumulate
from lidar_slam_arvc_tpu.ops.nn_pallas import nn_search_pallas


def on_gpu(kernel, plain, *args):
    """``kernel(*args)`` when compiled for a CUDA GPU, else ``plain(*args)``."""
    return jax.lax.platform_dependent(*args, cuda=kernel, default=plain)


def nearest_neighbors(src, tgt, tgt_mask, src_block: int = 1024,
                      tgt_block: int = 2048):
    """(idx, d2) of the nearest valid target of every 3-D source point.

    ``src_block``/``tgt_block`` tile the XLA version only; the GPU kernel
    uses its own measured blocks."""
    plain = functools.partial(nn_search, src_block=src_block,
                              tgt_block=tgt_block)
    return on_gpu(nn_search_pallas, plain, src, tgt, tgt_mask)


def ball_moments(points, mask, radius):
    """(count, S1, S2) over each valid point's ``radius`` ball.

    The kernel returns query-centred moments and the XLA version raw
    moments; cloud.normals._cov_from_moments turns either into the same
    covariance."""
    return on_gpu(
        lambda p, m: ball_moments_pallas(p, p, m, radius, query_mask=m),
        lambda p, m: radius_accumulate(p, p, m, radius),
        points, mask)
