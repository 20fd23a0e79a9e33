"""Batched SO(3) primitives: quaternions (wxyz), Euler XYZ, exp/log maps.

All functions accept arbitrary leading batch dimensions and are safe under
jit/vmap/grad.  Numerical behavior matches the reference pipeline's artelib
conventions where interop matters:

  * ``rot_to_quat`` reproduces the sign-robust Corke-style extraction of
    reference artelib/tools.py:110-172 (dominant-diagonal branch + modified
    sign), implemented branchlessly with ``jnp.where`` so it vectorizes.
  * ``euler_to_rot`` builds R = Rx(a) @ Ry(b) @ Rz(g) — the XYZ mobile-axes
    convention of reference artelib/tools.py:226-238.
  * ``rot_to_euler_both`` returns both Euler branches like reference
    artelib/tools.py:241-275 (used by the loop-closure triangle gate, which
    takes the min-norm branch: reference graphslam/loopclosing.py:119-129).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-9


def _hat_sq(w: jax.Array) -> jax.Array:
    """hat(w) @ hat(w) via the closed form w w^T - (w.w) I.

    Avoids a 3x3 matmul, which an accelerator may run at reduced default
    precision (bfloat16 or TF32) — geometry must stay full f32.
    """
    outer = w[..., :, None] * w[..., None, :]
    theta2 = jnp.sum(w * w, axis=-1)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), outer.shape)
    return outer - theta2[..., None, None] * eye


def normalize_angle(theta: jax.Array) -> jax.Array:
    """Wrap angles elementwise to [-pi, pi] (reference artelib/tools.py:29-36)."""
    return jnp.arctan2(jnp.sin(theta), jnp.cos(theta))


# ---------------------------------------------------------------------------
# Quaternions (wxyz)
# ---------------------------------------------------------------------------

def quat_normalize(q: jax.Array) -> jax.Array:
    """Normalize quaternion(s) to unit length; zero quats map to identity."""
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    unit = jnp.concatenate(
        [jnp.ones_like(q[..., :1]), jnp.zeros_like(q[..., 1:])], axis=-1
    )
    return jnp.where(n > _EPS, q / jnp.maximum(n, _EPS), unit)


def quat_multiply(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Hamilton product of wxyz quaternions (reference artelib/tools.py:205-216)."""
    w1, x1, y1, z1 = jnp.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q: jax.Array) -> jax.Array:
    """Conjugate of wxyz quaternion(s) (reference artelib/tools.py:219-223)."""
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_to_rot(q: jax.Array) -> jax.Array:
    """wxyz quaternion(s) -> rotation matrix/matrices (..., 3, 3).

    Same closed form as reference artelib/tools.py:92-107 (quaternion2rot).
    """
    q = quat_normalize(q)
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    rows = jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )
    return rows


def rot_to_quat(R: jax.Array) -> jax.Array:
    """Rotation matrix/matrices -> wxyz quaternion(s).

    Branchless vectorization of the Corke-style extraction in reference
    artelib/tools.py:110-172: w from the (clamped) trace, vector part from the
    dominant diagonal element with the modified-sign rule, so the result is
    robust to noisy, nearly-orthonormal inputs.
    """
    R = R[..., :3, :3]
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] + 1.0
    tr = jnp.maximum(tr, 0.0)
    s = jnp.sqrt(tr) / 2.0

    kx = R[..., 2, 1] - R[..., 1, 2]
    ky = R[..., 0, 2] - R[..., 2, 0]
    kz = R[..., 1, 0] - R[..., 0, 1]

    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    k = jnp.argmax(diag, axis=-1)

    # branch 0: Nx dominates
    kx1_0 = R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2] + 1.0
    ky1_0 = R[..., 1, 0] + R[..., 0, 1]
    kz1_0 = R[..., 2, 0] + R[..., 0, 2]
    # branch 1: Oy dominates
    kx1_1 = R[..., 1, 0] + R[..., 0, 1]
    ky1_1 = R[..., 1, 1] - R[..., 0, 0] - R[..., 2, 2] + 1.0
    kz1_1 = R[..., 2, 1] + R[..., 1, 2]
    # branch 2: Az dominates
    kx1_2 = R[..., 2, 0] + R[..., 0, 2]
    ky1_2 = R[..., 2, 1] + R[..., 1, 2]
    kz1_2 = R[..., 2, 2] - R[..., 0, 0] - R[..., 1, 1] + 1.0

    is0 = (k == 0)
    is1 = (k == 1)
    kx1 = jnp.where(is0, kx1_0, jnp.where(is1, kx1_1, kx1_2))
    ky1 = jnp.where(is0, ky1_0, jnp.where(is1, ky1_1, ky1_2))
    kz1 = jnp.where(is0, kz1_0, jnp.where(is1, kz1_1, kz1_2))
    ksel = jnp.where(is0, kx, jnp.where(is1, ky, kz))
    sgn = jnp.where(ksel >= 0, 1.0, -1.0).astype(R.dtype)

    kx = kx + sgn * kx1
    ky = ky + sgn * ky1
    kz = kz + sgn * kz1

    nm = jnp.sqrt(kx * kx + ky * ky + kz * kz)
    scale = jnp.sqrt(jnp.maximum(1.0 - s * s, 0.0)) / jnp.maximum(nm, _EPS)
    v = jnp.stack([kx, ky, kz], axis=-1) * scale[..., None]
    q = jnp.concatenate([s[..., None], v], axis=-1)
    identity = jnp.zeros_like(q).at[..., 0].set(1.0)
    # Unlike the reference we re-normalize: noisy near-orthonormal inputs
    # otherwise yield |q| slightly != 1, which would leak into saved CSVs.
    return quat_normalize(jnp.where(nm[..., None] > _EPS, q, identity))


def quat_slerp(q1: jax.Array, q2: jax.Array, t) -> jax.Array:
    """Spherical interpolation with shortest-path sign handling
    (reference artelib/tools.py:290-310)."""
    t = jnp.asarray(t, dtype=q1.dtype)
    cth = jnp.sum(q1 * q2, axis=-1)
    q1 = jnp.where((cth < 0)[..., None], -q1, q1)
    cth = jnp.clip(jnp.abs(cth), -1.0, 1.0)
    th = jnp.arccos(cth)
    sth = jnp.sin(th)
    safe = sth > _EPS
    a = jnp.where(safe, jnp.sin((1 - t) * th) / jnp.where(safe, sth, 1.0), 1 - t)
    b = jnp.where(safe, jnp.sin(t * th) / jnp.where(safe, sth, 1.0), t)
    return quat_normalize(q1 * a[..., None] + q2 * b[..., None])


# ---------------------------------------------------------------------------
# Euler XYZ (mobile axes): R = Rx(alpha) @ Ry(beta) @ Rz(gamma)
# ---------------------------------------------------------------------------

def euler_to_rot(abg: jax.Array) -> jax.Array:
    """Euler [alpha, beta, gamma] -> R = Rx@Ry@Rz (reference artelib/tools.py:226-238)."""
    a, b, g = jnp.moveaxis(abg, -1, 0)
    ca, sa = jnp.cos(a), jnp.sin(a)
    cb, sb = jnp.cos(b), jnp.sin(b)
    cg, sg = jnp.cos(g), jnp.sin(g)
    # Expanded product Rx @ Ry @ Rz.
    r00 = cb * cg
    r01 = -cb * sg
    r02 = sb
    r10 = ca * sg + sa * sb * cg
    r11 = ca * cg - sa * sb * sg
    r12 = -sa * cb
    r20 = sa * sg - ca * sb * cg
    r21 = sa * cg + ca * sb * sg
    r22 = ca * cb
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rot_to_euler_both(R: jax.Array):
    """Both XYZ-mobile Euler branches, angles wrapped to [-pi, pi].

    Vectorized port of the two-branch extraction in reference
    artelib/tools.py:241-275 (including its degenerate |R02|≈1 handling).
    Returns a tuple (e1, e2) of (..., 3) arrays.
    """
    r02 = jnp.clip(R[..., 0, 2], -1.0, 1.0)
    degenerate = jnp.abs(jnp.abs(R[..., 0, 2]) - 1.0) <= 1e-4

    # --- regular case ---
    beta1 = jnp.arcsin(r02)
    beta2 = jnp.pi - beta1
    s1 = jnp.sign(jnp.cos(beta1))
    s2 = jnp.sign(jnp.cos(beta2))
    s1 = jnp.where(s1 == 0, 1.0, s1)
    s2 = jnp.where(s2 == 0, 1.0, s2)
    alpha1 = jnp.arctan2(-s1 * R[..., 1, 2], s1 * R[..., 2, 2])
    gamma1 = jnp.arctan2(-s1 * R[..., 0, 1], s1 * R[..., 0, 0])
    alpha2 = jnp.arctan2(-s2 * R[..., 1, 2], s2 * R[..., 2, 2])
    gamma2 = jnp.arctan2(-s2 * R[..., 0, 1], s2 * R[..., 0, 0])

    # --- degenerate case (gimbal lock, beta = +-pi/2) ---
    alpha1_d = jnp.zeros_like(beta1)
    alpha2_d = jnp.full_like(beta1, jnp.pi)
    beta_pos = beta1 > 0
    beta2_d = jnp.where(beta_pos, jnp.pi / 2, -jnp.pi / 2)
    gamma_pos = jnp.arctan2(R[..., 1, 0], R[..., 1, 1])
    gamma_neg = jnp.arctan2(-R[..., 1, 0], R[..., 1, 1])
    gamma1_d = jnp.where(beta_pos, gamma_pos, gamma_neg)
    gamma2_d = gamma1_d - alpha2_d

    alpha1 = jnp.where(degenerate, alpha1_d, alpha1)
    alpha2 = jnp.where(degenerate, alpha2_d, alpha2)
    beta2 = jnp.where(degenerate, beta2_d, beta2)
    gamma1 = jnp.where(degenerate, gamma1_d, gamma1)
    gamma2 = jnp.where(degenerate, gamma2_d, gamma2)

    e1 = normalize_angle(jnp.stack([alpha1, beta1, gamma1], axis=-1))
    e2 = normalize_angle(jnp.stack([alpha2, beta2, gamma2], axis=-1))
    return e1, e2


def rot_to_euler(R: jax.Array) -> jax.Array:
    """First XYZ-mobile Euler branch (the one artelib consumers use by default)."""
    return rot_to_euler_both(R)[0]


def euler_to_quat(abg: jax.Array) -> jax.Array:
    return rot_to_quat(euler_to_rot(abg))


def quat_to_euler(q: jax.Array) -> jax.Array:
    return rot_to_euler(quat_to_rot(q))


# ---------------------------------------------------------------------------
# so(3) exp/log (needed by the pose-graph solver; no artelib counterpart)
# ---------------------------------------------------------------------------

def so3_hat(w: jax.Array) -> jax.Array:
    """(..., 3) axis-angle vector(s) -> (..., 3, 3) skew matrices."""
    wx, wy, wz = jnp.moveaxis(w, -1, 0)
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def so3_vee(W: jax.Array) -> jax.Array:
    """Inverse of :func:`so3_hat`."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues exponential with a Taylor branch near zero (grad-safe)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < 1e-12
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    W = so3_hat(w)
    W2 = _hat_sq(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: jax.Array) -> jax.Array:
    """Log map SO(3) -> so(3), robust near theta=0 and theta=pi.

    Near pi the axis is recovered from the dominant diagonal of
    (R + R^T)/2 - cos(theta) I, signed by the skew part.
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    skew = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_theta = jnp.sin(theta)

    # Generic branch: w = theta / (2 sin(theta)) * vee(R - R^T); series near 0.
    small = theta < 1e-4
    scale_generic = jnp.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / jnp.maximum(2.0 * sin_theta, 1e-12),
    )
    w_generic = skew * scale_generic[..., None]

    # Near-pi branch: axis from diagonal of the symmetric part.
    near_pi = theta > jnp.pi - 1e-3
    S = 0.5 * (R + jnp.swapaxes(R, -1, -2))
    diag = jnp.stack(
        [S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], axis=-1
    )
    axis_sq = jnp.maximum((diag - cos_theta[..., None]) / jnp.maximum(1.0 - cos_theta[..., None], 1e-12), 0.0)
    axis = jnp.sqrt(axis_sq)
    # Resolve signs: pick dominant component positive, sign others from the
    # off-diagonal symmetric entries S_ij = axis_i*axis_j*(1-cos) near pi.
    k = jnp.argmax(axis, axis=-1)
    s01 = S[..., 0, 1]
    s02 = S[..., 0, 2]
    s12 = S[..., 1, 2]

    def signed(axis, k):
        a0, a1, a2 = axis[..., 0], axis[..., 1], axis[..., 2]
        # dominant = 0
        b1_0 = jnp.where(s01 >= 0, a1, -a1)
        b2_0 = jnp.where(s02 >= 0, a2, -a2)
        cand0 = jnp.stack([a0, b1_0, b2_0], axis=-1)
        # dominant = 1
        b0_1 = jnp.where(s01 >= 0, a0, -a0)
        b2_1 = jnp.where(s12 >= 0, a2, -a2)
        cand1 = jnp.stack([b0_1, a1, b2_1], axis=-1)
        # dominant = 2
        b0_2 = jnp.where(s02 >= 0, a0, -a0)
        b1_2 = jnp.where(s12 >= 0, a1, -a1)
        cand2 = jnp.stack([b0_2, b1_2, a2], axis=-1)
        k_ = k[..., None]
        return jnp.where(k_ == 0, cand0, jnp.where(k_ == 1, cand1, cand2))

    w_pi = signed(axis, k) * theta[..., None]
    # keep continuity with the skew sign when available
    dot = jnp.sum(w_pi * skew, axis=-1, keepdims=True)
    w_pi = jnp.where(dot < 0, -w_pi, w_pi)

    return jnp.where(near_pi[..., None], w_pi, w_generic)
