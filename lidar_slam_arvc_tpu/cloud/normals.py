"""Normal estimation from ball-neighborhood covariance.

Replaces Open3D's C++ ``estimate_normals`` with
``KDTreeSearchParamHybrid(radius, max_nn)`` (reference keyframe.py:160-162,
184-189): per point, the normal is the smallest-eigenvalue eigenvector of
the covariance of neighbors within ``radius``.

Neighbour moments (count, sum, sum of outer products) come from a fused
Pallas sweep on the GPU (ops.ball_moments_pallas: the (Q,T) weight matrix
never reaches device memory) or from three masked matmuls elsewhere
(ops.radius_accumulate), chosen per device by ops.ball_moments; the
eigenvector comes from a closed-form symmetric 3x3 solve.  The reference's ``max_nn``
cap (300) is not applied: at the radii used (0.3-0.5 m on voxelized
scans) neighborhoods are far below the cap, where the cap exists only to
bound KD-tree query cost.
"""

from __future__ import annotations

import jax.numpy as jnp

from lidar_slam_arvc_tpu.cloud.cloud import Cloud
from lidar_slam_arvc_tpu.ops import ball_moments, smallest_eigenvector_sym3


def _cov_from_moments(count, s1, s2):
    """Covariance cov = S2/n - m m^T from ball moments.

    Works for BOTH moment conventions: query-centered moments
    (ball_moments_pallas) and raw-origin moments (ops.nn.radius_accumulate)
    — the algebra is identical, only the frame of the mean differs.  For
    the raw-moment path the subtraction is catastrophically cancelling
    (|S2/n| >> |cov|), so radius_accumulate MUST keep its
    Precision.HIGHEST matmuls (see its docstring) for this to be safe."""
    n = jnp.maximum(count, 1.0)
    m = s1 / n[:, None]                      # mean offset from the query
    xx, xy, xz, yy, yz, zz = (s2[:, 0], s2[:, 1], s2[:, 2],
                              s2[:, 3], s2[:, 4], s2[:, 5])
    mx, my, mz = m[:, 0], m[:, 1], m[:, 2]
    c00 = xx / n - mx * mx
    c01 = xy / n - mx * my
    c02 = xz / n - mx * mz
    c11 = yy / n - my * my
    c12 = yz / n - my * mz
    c22 = zz / n - mz * mz
    return jnp.stack([
        jnp.stack([c00, c01, c02], axis=-1),
        jnp.stack([c01, c11, c12], axis=-1),
        jnp.stack([c02, c12, c22], axis=-1),
    ], axis=-2)


def estimate_normals(cloud: Cloud, radius: float,
                     orient_to_viewpoint: bool = True) -> Cloud:
    """Returns the cloud with unit ``normals`` filled for valid points.

    Points with fewer than 3 ball neighbors (including self) get +z, like
    Open3D's degenerate fallback.  With ``orient_to_viewpoint`` (default)
    normal signs are flipped to face the sensor origin — the PCL viewpoint
    convention.  Sign is irrelevant for point-to-plane ICP but essential for
    FPFH descriptors, whose Darboux angles are sign-sensitive.
    """
    count, s1, s2 = ball_moments(cloud.points, cloud.mask, radius)
    cov = _cov_from_moments(count, s1, s2)
    normals = smallest_eigenvector_sym3(cov)
    if orient_to_viewpoint:
        # flip so n . (viewpoint - p) >= 0 with viewpoint = sensor origin
        facing = jnp.sum(normals * cloud.points, axis=-1, keepdims=True)
        normals = jnp.where(facing > 0, -normals, normals)
    degenerate = (count < 3.0)[:, None]
    ez = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], dtype=normals.dtype),
                          normals.shape)
    normals = jnp.where(degenerate, ez, normals)
    return Cloud(points=cloud.points, mask=cloud.mask, normals=normals)
