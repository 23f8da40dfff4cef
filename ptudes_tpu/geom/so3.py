"""SO(3) primitives in JAX.

JAX replacement for the rotation helpers the reference pulls from
scipy ``Rotation`` and ``ouster.sdk.pose_util`` (``exp_rot_vec`` /
``log_rot_mat``; see reference ``src/ptudes/ins/es_ekf.py:11`` and
``src/ptudes/utils.py:28-36`` for ``vee``).

All functions are pure, jit/vmap-friendly, and numerically guarded around
``theta -> 0`` and ``theta -> pi`` with series expansions so gradients are
finite everywhere.

Conventions:
  * rotation vectors ("rotvec") are axis*angle, radians.
  * quaternions are ``[x, y, z, w]`` (scalar-last), matching scipy and the
    reference's ``NavState.att_q`` (reference ``src/ptudes/ins/data.py:37``).
  * matrices act on column vectors: ``p' = R @ p``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(v: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of a 3-vector (the reference calls this ``vee``,
    reference ``src/ptudes/utils.py:28-36`` — that name is a misnomer there;
    we keep the conventional ``hat``/``vee`` pair).

    Supports leading batch dims: (..., 3) -> (..., 3, 3).
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(m: jax.Array) -> jax.Array:
    """Inverse of :func:`hat`: (..., 3, 3) skew matrix -> (..., 3) vector."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def exp_rotvec(v: jax.Array) -> jax.Array:
    """Rodrigues formula: rotation vector (..., 3) -> rotation matrix (..., 3, 3).

    Equivalent of ``ouster.sdk.pose_util.exp_rot_vec`` used by the reference
    EKF (``src/ptudes/ins/es_ekf.py:280,316``).
    """
    theta2 = jnp.sum(v * v, axis=-1)
    theta = jnp.sqrt(theta2)
    small = theta < _EPS
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks
    safe_t2 = jnp.where(small, 1.0, theta2)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.sqrt(safe_t2))
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe_t2)
    k = hat(v)
    kk = k @ k
    eye = jnp.broadcast_to(jnp.eye(3, dtype=v.dtype), k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * kk


def log_rotmat(r: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> rotation vector (..., 3).

    Equivalent of ``ouster.sdk.pose_util.log_rot_mat`` used in the EKF pose
    residual (reference ``src/ptudes/ins/es_ekf.py:297``). Handles the
    theta -> pi branch via the quaternion path, which is stable everywhere.
    """
    return quat_to_rotvec(mat_to_quat(r))


def normalize_quat(q: jax.Array) -> jax.Array:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    q = q / jnp.maximum(n, _EPS)
    # canonicalize sign (w >= 0) for deterministic comparisons
    return q * jnp.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_mul(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Hamilton product, xyzw convention: rot(q1*q2) == rot(q1) @ rot(q2)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def quat_conj(q: jax.Array) -> jax.Array:
    return q * jnp.asarray([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_rotate(q: jax.Array, p: jax.Array) -> jax.Array:
    """Rotate vector(s) p (..., 3) by quaternion q (..., 4)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * jnp.cross(qv, p)
    return p + w * t + jnp.cross(qv, t)


def quat_to_mat(q: jax.Array) -> jax.Array:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = jnp.ones_like(x)
    return jnp.stack(
        [
            jnp.stack([one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            jnp.stack([2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)], -1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)], -1),
        ],
        axis=-2,
    )


def mat_to_quat(r: jax.Array) -> jax.Array:
    """Rotation matrix -> quaternion (xyzw), branch-free (Shepperd's method
    expressed with ``jnp.where`` so it vmaps/jits cleanly)."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate (unnormalized) quaternions, one per dominant component
    qw = jnp.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], -1)
    qx = jnp.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], -1)
    qy = jnp.stack([m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21, m02 - m20], -1)
    qz = jnp.stack([m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11, m10 - m01], -1)

    # choose the numerically largest pivot
    c0 = tr
    c1 = m00 - m11 - m22
    c2 = m11 - m00 - m22
    c3 = m22 - m00 - m11
    cands = jnp.stack([c0, c1, c2, c3], -1)
    best = jnp.argmax(cands, axis=-1)

    q = jnp.where(
        (best == 0)[..., None],
        qw,
        jnp.where(
            (best == 1)[..., None],
            qx,
            jnp.where((best == 2)[..., None], qy, qz),
        ),
    )
    return normalize_quat(q)


def quat_to_rotvec(q: jax.Array) -> jax.Array:
    q = normalize_quat(q)
    qv = q[..., :3]
    w = q[..., 3]
    n = jnp.linalg.norm(qv, axis=-1)
    # angle = 2*atan2(|qv|, w) in [0, pi] after sign canonicalization
    angle = 2.0 * jnp.arctan2(n, w)
    small = n < _EPS
    scale = jnp.where(small, 2.0 / jnp.maximum(w, _EPS), angle / jnp.where(small, 1.0, n))
    return qv * scale[..., None]


def rotvec_to_quat(v: jax.Array) -> jax.Array:
    theta = jnp.linalg.norm(v, axis=-1, keepdims=True)
    small = theta < _EPS
    half = 0.5 * theta
    k = jnp.where(small, 0.5 - theta * theta / 48.0, jnp.sin(half) / jnp.where(small, 1.0, theta))
    return normalize_quat(
        jnp.concatenate([v * k, jnp.cos(half)], axis=-1)
    )


def quat_from_euler_xyz(rpy: jax.Array) -> jax.Array:
    """Intrinsic XYZ Euler angles (radians) -> quaternion.

    Matches scipy ``Rotation.from_euler('XYZ', ...)`` as used for the EKF
    initial attitude std (reference ``src/ptudes/ins/es_ekf.py:104-106``).
    """
    rx = rotvec_to_quat(jnp.stack([rpy[..., 0], jnp.zeros_like(rpy[..., 0]), jnp.zeros_like(rpy[..., 0])], -1))
    ry = rotvec_to_quat(jnp.stack([jnp.zeros_like(rpy[..., 1]), rpy[..., 1], jnp.zeros_like(rpy[..., 1])], -1))
    rz = rotvec_to_quat(jnp.stack([jnp.zeros_like(rpy[..., 2]), jnp.zeros_like(rpy[..., 2]), rpy[..., 2]], -1))
    return quat_mul(rx, quat_mul(ry, rz))
