"""Constant-velocity motion compensation (deskew).

JAX equivalent of kiss-icp's C++ ``compensator.deskew_scan``
(reference call sites ``src/ptudes/kiss.py:77,90``): every point is moved by
the fractional relative motion

    p' = exp((tau_i - 0.5) * log(delta)) * p_i,     delta = T_{k-2}^{-1} T_{k-1}

with per-column normalized timestamps tau in [0, 1)
(``src/ptudes/kiss.py:34-35``) and kiss's mid-scan anchor (0.5).

Instead of materializing a 4x4 pose per point, the Rodrigues form is expanded
per point with shared twist axis and per-point scale — pure element-wise
math (two cross products + a few FMAs per point), no matmuls, no gathers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geom import se3, so3

_EPS = 1e-8


def deskew_by_twist(
    pts: jax.Array,       # [N, 3]
    scales: jax.Array,    # [N]   per-point fraction (tau - 0.5)
    twist: jax.Array,     # [6]   [rot, trans] = log(delta)
) -> jax.Array:
    """Apply exp(scale_i * twist) to each point, closed form."""
    w = twist[:3]
    v = twist[3:]
    theta2 = jnp.sum(w * w)
    theta = jnp.sqrt(theta2)
    small = theta < _EPS
    safe_t = jnp.where(small, 1.0, theta)
    safe_t2 = jnp.where(small, 1.0, theta2)

    st = scales * theta                                      # [N]
    sin_st = jnp.sin(st)
    cos_st = jnp.cos(st)

    # R(s) = I + A K + B K^2 with K = hat(w):
    #   A = sin(s*theta)/theta, B = (1 - cos(s*theta))/theta^2
    a = jnp.where(small, scales, sin_st / safe_t)            # [N]
    b = jnp.where(small, 0.5 * scales * scales, (1.0 - cos_st) / safe_t2)

    wxp = jnp.cross(jnp.broadcast_to(w, pts.shape), pts)     # K p
    wwxp = jnp.cross(jnp.broadcast_to(w, pts.shape), wxp)    # K^2 p
    rotated = pts + a[:, None] * wxp + b[:, None] * wwxp

    # t(s) = V(s) (s v),  V(s) = I + B' K + C' K^2 with
    #   B' = (1 - cos(s t))/(s t^2 ... ) expressed against full theta:
    #   V(s) = I + ((1-cos(st))/t^2/s?) — derive via omega_s = s w:
    #   V(omega_s) = I + (1-cos|w_s|)/|w_s|^2 hat(w_s)
    #                  + (|w_s| - sin|w_s|)/|w_s|^3 hat(w_s)^2
    # with hat(w_s) = s K and |w_s| = s*theta. Acting on (s v):
    #   t(s) = s v + s^2 (1-cos st)/(st)^2 K v * ... simplify:
    s2 = scales * scales
    bb = jnp.where(
        small,
        0.5 * s2,
        (1.0 - cos_st) / safe_t2,
    )  # coefficient of K v  (s^2 * (1-cos st)/(st)^2 == (1-cos st)/theta^2)
    cc = jnp.where(
        small,
        s2 * scales / 6.0,
        (st - sin_st) / (safe_t2 * safe_t),
    )  # coefficient of K^2 v ((st - sin st)/theta^3)
    wxv = jnp.cross(w, v)
    wwxv = jnp.cross(w, wxv)
    t = scales[:, None] * v + bb[:, None] * wxv + cc[:, None] * wwxv

    return rotated + t


def deskew_scan(
    pts: jax.Array,         # [N, 3]
    col_ts01: jax.Array,    # [N] normalized timestamps in [0, 1)
    pose_prev2: jax.Array,  # [4, 4] T_{k-2}
    pose_prev1: jax.Array,  # [4, 4] T_{k-1}
    enabled: bool | jax.Array = True,
) -> jax.Array:
    """kiss-icp constant-velocity deskew with delta from the last two poses.

    With fewer than two poses the reference applies no compensation
    (kiss compensator early-returns); callers pass identity poses then,
    which makes the twist zero — no branch needed.
    """
    delta = se3.inv(pose_prev2) @ pose_prev1
    twist = se3.log_pose(delta)
    twist = jnp.where(jnp.asarray(enabled), twist, jnp.zeros_like(twist))
    return deskew_by_twist(pts, col_ts01 - 0.5, twist)
