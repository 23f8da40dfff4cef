"""Per-voxel plane estimation from stored map points.

Point-to-plane support for the ICP (``icp.register_frame`` with
``loss="plane"``): the normal of each correspondence's voxel is computed
on the fly from the voxel's stored point list (already gathered for the
NN search), via a closed-form symmetric 3x3 eigen-decomposition — pure
vectorized elementwise math, no extra map state.

Why this exists: the reference's kiss-icp uses point-to-point, whose
fixed point on flat, ring-sampled lidar data is set by the sampling
pattern (ring-lock) — the estimate wobbles scan to scan, the wobble
smears the map, and the feedback can diverge. Point-to-plane removes the
spurious tangential constraints entirely (a classic LIO improvement:
LOAM/FAST-LIO lineage) while degrading gracefully to point-to-point for
voxels with too few or non-planar points.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def smallest_eigvec_sym3(a: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Smallest eigenpair of symmetric 3x3 matrices (..., 3, 3).

    Returns (eigvec (..., 3) unit, quality (...,)) where quality is
    (lam_mid - lam_min) / lam_max — a planarity score in [0, 1]: ~1 for a
    thin plane, ~0 for isotropic or degenerate point sets.

    Closed-form trigonometric eigenvalues + cross-product eigenvector;
    numerically guarded for repeated eigenvalues.
    """
    eps = 1e-12
    # explicit symmetric-entry arithmetic: jnp.trace(b @ b) and
    # jnp.linalg.det lower to batched matmul / LU custom calls; the
    # closed forms are pure elementwise work
    axx, ayy, azz = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    axy, axz, ayz = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    m = (axx + ayy + azz) / 3.0
    bxx, byy, bzz = axx - m, ayy - m, azz - m
    q = (bxx * bxx + byy * byy + bzz * bzz
         + 2.0 * (axy * axy + axz * axz + ayz * ayz)) / 6.0
    det = (bxx * (byy * bzz - ayz * ayz)
           - axy * (axy * bzz - ayz * axz)
           + axz * (axy * ayz - byy * axz)) / 2.0
    sq = jnp.sqrt(jnp.maximum(q, eps))
    # clamp for acos
    r = jnp.clip(det / jnp.maximum(sq**3, eps), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    l1 = m + 2.0 * sq * jnp.cos(phi)                        # largest
    l3 = m + 2.0 * sq * jnp.cos(phi + 2.0 * jnp.pi / 3.0)   # smallest
    l2 = 3.0 * m - l1 - l3

    # eigvec for l3: null space of (a - l3 I); use the largest cross
    # product of row pairs for robustness
    c = a - l3[..., None, None] * jnp.eye(3, dtype=a.dtype)
    r0, r1, r2 = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    v01 = jnp.cross(r0, r1)
    v02 = jnp.cross(r0, r2)
    v12 = jnp.cross(r1, r2)
    n01 = jnp.sum(v01 * v01, axis=-1)
    n02 = jnp.sum(v02 * v02, axis=-1)
    n12 = jnp.sum(v12 * v12, axis=-1)
    best = jnp.argmax(jnp.stack([n01, n02, n12], axis=-1), axis=-1)
    v = jnp.where(
        (best == 0)[..., None], v01,
        jnp.where((best == 1)[..., None], v02, v12))
    vn = jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))
    v = v / vn
    quality = (l2 - l3) / jnp.maximum(l1, eps)
    # degenerate null-space (isotropic): quality -> 0, vector arbitrary
    return v, jnp.clip(quality, 0.0, 1.0)


def voxel_plane(
    vox_pts: jax.Array,   # [M, P, 3] stored points of the matched voxel
    cnt: jax.Array,       # [M] valid count
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Fit a plane per voxel point list.

    Returns (normal [M, 3] unit, centroid [M, 3], planarity [M] in [0,1];
    zero planarity when cnt < 4).
    """
    ppv = vox_pts.shape[1]
    valid = (jnp.arange(ppv, dtype=jnp.int32)[None, :]
             < cnt[:, None])                                  # [M, P]
    w = valid.astype(vox_pts.dtype)
    n = jnp.maximum(cnt.astype(vox_pts.dtype), 1.0)
    centroid = jnp.sum(vox_pts * w[..., None], axis=1) / n[:, None]
    d = (vox_pts - centroid[:, None, :]) * w[..., None]
    cov = jnp.einsum("mpi,mpj->mij", d, d) / n[:, None, None]
    normal, quality = smallest_eigvec_sym3(cov)
    quality = jnp.where(cnt >= 4, quality, 0.0)
    return normal, centroid, quality
