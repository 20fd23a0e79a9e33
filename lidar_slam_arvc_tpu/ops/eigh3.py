"""Closed-form symmetric 3x3 eigen-solve (batched, branchless).

Replaces the per-neighborhood eigen decomposition inside Open3D's C++
``estimate_normals`` (reference keyframemanager/keyframe.py:160-162): normal
vectors are the eigenvectors of the local covariance with smallest
eigenvalue.  A trigonometric closed form (Smith's algorithm) is used instead
of an iterative solver so the whole cloud solves as one fused elementwise
program — no lapack, no dynamic loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def eigvals_sym3(A: jax.Array) -> jax.Array:
    """Eigenvalues of symmetric (..., 3, 3) matrices, ascending."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))

    # det(B)/2 with B = (A - qI)/p
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) / (p * p * p)
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0

    e_max = q + 2.0 * p * jnp.cos(phi)
    e_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_max - e_min

    # Diagonal matrices (p2 ~ 0): all eigenvalues equal q.
    iso = p2 < 1e-24
    e_min = jnp.where(iso, q, e_min)
    e_mid = jnp.where(iso, q, e_mid)
    e_max = jnp.where(iso, q, e_max)
    return jnp.stack([e_min, e_mid, e_max], axis=-1)


def smallest_eigenvector_sym3(A: jax.Array) -> jax.Array:
    """Unit eigenvector of the smallest eigenvalue of symmetric (...,3,3).

    The eigenvector is recovered as the largest-norm cross product of rows of
    (A - lambda_min I); for isotropic (degenerate) inputs it falls back to
    +z, which is harmless for normal estimation (sign/direction of a normal
    in a spherically-symmetric neighborhood is arbitrary).
    """
    lam = eigvals_sym3(A)[..., 0]
    B = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0 = B[..., 0, :]
    r1 = B[..., 1, :]
    r2 = B[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)

    best01 = (n01 >= n02) & (n01 >= n12)
    best02 = (n02 > n01) & (n02 >= n12)
    v = jnp.where(best01[..., None], c01,
                  jnp.where(best02[..., None], c02, c12))
    nv = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    ez = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], dtype=A.dtype), v.shape)
    return jnp.where(nv > 1e-18, v / jnp.maximum(nv, 1e-30), ez)
