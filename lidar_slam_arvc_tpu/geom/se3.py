"""Batched SE(3) transforms and trajectory algebra.

Trajectories are stacked (N, 4, 4) tensors.  The reference pipeline folds
Python lists of HomogeneousMatrix objects sequentially
(artelib/homogeneousmatrix.py:170-212); here the same algebra is expressed as
vectorized einsums and an associative prefix-product scan, so a whole
trajectory fold is one fused XLA program instead of an N-step Python loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lidar_slam_arvc_tpu.geom.rotations import (
    _hat_sq,
    euler_to_rot,
    quat_to_rot,
    rot_to_euler,
    rot_to_quat,
    so3_exp,
    so3_hat,
    so3_log,
)

# Small-geometry einsums must not run at an accelerator's reduced default
# matmul precision (bfloat16 or TF32): pose chains compound the error.
_HI = jax.lax.Precision.HIGHEST


def make_transform(position: jax.Array, R: jax.Array) -> jax.Array:
    """Build (..., 4, 4) homogeneous transforms from (..., 3) and (..., 3, 3).

    Mirrors artelib's buildT (reference artelib/tools.py:11-18).
    """
    position = jnp.asarray(position)
    R = jnp.asarray(R)
    batch = jnp.broadcast_shapes(position.shape[:-1], R.shape[:-2])
    R = jnp.broadcast_to(R, batch + (3, 3))
    position = jnp.broadcast_to(position, batch + (3,))
    top = jnp.concatenate([R, position[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=top.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def transform_from_quat(position: jax.Array, q_wxyz: jax.Array) -> jax.Array:
    return make_transform(position, quat_to_rot(q_wxyz))


def transform_from_euler(position: jax.Array, abg: jax.Array) -> jax.Array:
    return make_transform(position, euler_to_rot(abg))


def compose(Ta: jax.Array, Tb: jax.Array) -> jax.Array:
    """Ta @ Tb for batches of (..., 4, 4)."""
    return jnp.einsum("...ij,...jk->...ik", Ta, Tb, precision=_HI)


def inverse(T: jax.Array) -> jax.Array:
    """Closed-form SE(3) inverse: [R^T, -R^T t] (cheaper/stabler than inv)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    t_inv = -jnp.einsum("...ij,...j->...i", Rt, t, precision=_HI)
    return make_transform(t_inv, Rt)


def transform_points(T: jax.Array, points: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", R, points, precision=_HI) + t[..., None, :]


def positions(T: jax.Array) -> jax.Array:
    """(..., 3) translation part (reference homogeneousmatrix.py:73-74 ``pos``)."""
    return T[..., :3, 3]


def rotations(T: jax.Array) -> jax.Array:
    return T[..., :3, :3]


def t2v(T: jax.Array) -> jax.Array:
    """SE(3) -> [tx, ty, tz, alpha, beta, gamma] (reference
    homogeneousmatrix.py:95-107 ``t2v(n=3)``, first Euler branch)."""
    e = rot_to_euler(T[..., :3, :3])
    return jnp.concatenate([T[..., :3, 3], e], axis=-1)


# ---------------------------------------------------------------------------
# se(3) exp/log — tangent convention [rot(3), trans(3)], matching GTSAM Pose3
# so that the graph-solver noise table (reference graphslam/graphSLAM.py:32-53,
# sigmas ordered rpy-then-xyz) applies verbatim.
# ---------------------------------------------------------------------------

def _V_matrix(w: jax.Array) -> jax.Array:
    """Left Jacobian of SO(3): V = I + B*W + C*W^2 with series near zero."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < 1e-12
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, 1e-24))
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - jnp.sin(theta)) / jnp.maximum(theta2 * theta, 1e-24))
    W = so3_hat(w)
    W2 = _hat_sq(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + B[..., None, None] * W + C[..., None, None] * W2


def _V_inv_matrix(w: jax.Array) -> jax.Array:
    """Inverse left Jacobian of SO(3) with series near zero."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < 1e-12
    half_theta = theta / 2.0
    cot = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_theta * jnp.cos(half_theta) / jnp.maximum(jnp.sin(half_theta), 1e-24))
        / jnp.maximum(theta2, 1e-24),
    )
    W = so3_hat(w)
    W2 = _hat_sq(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot[..., None, None] * W2


def se3_exp(xi: jax.Array) -> jax.Array:
    """Exponential map se(3) -> SE(3); xi = [w(3), v(3)]."""
    w = xi[..., :3]
    v = xi[..., 3:]
    R = so3_exp(w)
    t = jnp.einsum("...ij,...j->...i", _V_matrix(w), v, precision=_HI)
    return make_transform(t, R)


def se3_log(T: jax.Array) -> jax.Array:
    """Log map SE(3) -> se(3); returns [w(3), v(3)]."""
    w = so3_log(T[..., :3, :3])
    v = jnp.einsum("...ij,...j->...i", _V_inv_matrix(w), T[..., :3, 3], precision=_HI)
    return jnp.concatenate([w, v], axis=-1)


# ---------------------------------------------------------------------------
# Trajectory algebra (stacked (N, 4, 4))
# ---------------------------------------------------------------------------

def relative_transforms(global_T: jax.Array) -> jax.Array:
    """(N,4,4) global -> (N-1,4,4) relative: T_i^-1 @ T_{i+1}.

    Vectorized equivalent of reference homogeneousmatrix.py:170-181.
    """
    return compose(inverse(global_T[:-1]), global_T[1:])


def global_transforms(relative_T: jax.Array, T0: jax.Array | None = None,
                      Trobot_gps: jax.Array | None = None) -> jax.Array:
    """(N-1,4,4) relative -> (N,4,4) global prefix products starting at T0.

    The sequential left-fold of reference homogeneousmatrix.py:184-205 becomes
    an associative prefix product (``lax.associative_scan`` over matmul),
    which XLA executes in O(log N) batched-matmul depth.
    """
    n = relative_T.shape[0]
    if T0 is None:
        T0 = jnp.eye(4, dtype=relative_T.dtype)
    chain = jnp.concatenate([T0[None], relative_T], axis=0)
    out = jax.lax.associative_scan(compose, chain)
    if Trobot_gps is not None:
        out = compose(out, jnp.broadcast_to(Trobot_gps, out.shape))
    return out


def multiply_by_transform(transforms: jax.Array, Trel: jax.Array) -> jax.Array:
    """Right-multiply every pose by Trel (reference homogeneousmatrix.py:208-212)."""
    return compose(transforms, jnp.broadcast_to(Trel, transforms.shape))


def transforms_from_pose_columns(xyz: jax.Array, q_wxyz: jax.Array) -> jax.Array:
    """Stacked (N,4,4) from position columns + wxyz quaternion columns.

    Equivalent of reference homogeneousmatrix.py:147-167
    (compute_homogeneous_transforms), which reads trajectory CSV rows
    [x y z] + [qw qx qy qz].
    """
    return transform_from_quat(xyz, q_wxyz)


def pose_columns_from_transforms(T: jax.Array):
    """(N,4,4) -> (xyz (N,3), q_wxyz (N,4)) for CSV serialization."""
    return positions(T), rot_to_quat(T[..., :3, :3])
