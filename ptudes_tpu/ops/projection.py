"""Range-image geometry: XYZ projection LUT, destagger, beam reduction.

JAX equivalent of the ouster-sdk C++ ``XYZLut`` (reference call sites
``src/ptudes/kiss.py:28-29,60``) and the field/column helpers
(``src/ptudes/data.py:97``). The LUT is precomputed once per sensor on host
(numpy) and uploaded; per-scan projection is a fused multiply-add under jit:

    xyz = dir_lut * range_m[..., None] + off_lut        (valid where range>0)

The Ouster model (legacy coordinate frame, as in ouster-sdk make_xyz_lut):
for beam row i and measurement column m of W:
    theta_enc = 2*pi * (1 - m / W)
    theta_az  = -2*pi * beam_azimuth_deg[i] / 360
    phi       =  2*pi * beam_altitude_deg[i] / 360
    dir       = [cos(theta_enc+theta_az)*cos(phi),
                 sin(theta_enc+theta_az)*cos(phi), sin(phi)]
    xyz_lidar = (r - n)*dir + n*[cos(theta_enc), sin(theta_enc), 0]
with n = lidar_origin_to_beam_origin_mm, then lidar_to_sensor_transform and
user extrinsics applied. The reference exploits extrinsics to output points
directly in the IMU/nav frame (``src/ptudes/cli/ekf_bench.py:440-447``);
we support the same by folding ``extrinsic`` into the LUT.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class XyzLut(NamedTuple):
    """Direction + offset lookup (meters), staggered (measurement-id) order."""
    direction: jax.Array  # [H, W, 3] f32
    offset: jax.Array     # [H, W, 3] f32


def make_xyz_lut_np(
    w: int,
    h: int,
    beam_altitude_deg: np.ndarray,
    beam_azimuth_deg: np.ndarray,
    lidar_origin_to_beam_origin_mm: float = 0.0,
    lidar_to_sensor_transform: np.ndarray | None = None,
    extrinsic: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Build the projection LUT on host: (direction, offset) numpy f64.

    Host-only variant (no jax device placement) — viz/export tools use
    this directly so they never touch the accelerator."""
    alt = np.asarray(beam_altitude_deg, np.float64) * (np.pi / 180.0)
    azi = np.asarray(beam_azimuth_deg, np.float64) * (np.pi / 180.0)
    assert alt.shape == (h,) and azi.shape == (h,)

    m = np.arange(w, dtype=np.float64)
    theta_enc = 2.0 * np.pi * (1.0 - m / w)                   # [W]
    theta = theta_enc[None, :] - azi[:, None]                 # [H, W]
    phi = np.broadcast_to(alt[:, None], (h, w))               # [H, W]

    direction = np.stack(
        [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)],
        axis=-1,
    )  # [H, W, 3]

    n_m = float(lidar_origin_to_beam_origin_mm) / 1000.0
    beam_origin = n_m * np.stack(
        [
            np.broadcast_to(np.cos(theta_enc), (h, w)),
            np.broadcast_to(np.sin(theta_enc), (h, w)),
            np.zeros((h, w)),
        ],
        axis=-1,
    )
    offset = beam_origin - n_m * direction

    # fold in lidar->sensor then extrinsic: x' = R x + t
    tf = np.eye(4)
    if lidar_to_sensor_transform is not None:
        lt = np.array(lidar_to_sensor_transform, np.float64).reshape(4, 4)
        lt = lt.copy()
        lt[:3, 3] /= 1000.0  # ouster metadata stores mm
        tf = lt
    if extrinsic is not None:
        tf = np.array(extrinsic, np.float64).reshape(4, 4) @ tf

    r3, t3 = tf[:3, :3], tf[:3, 3]
    direction = direction @ r3.T
    offset = offset @ r3.T + t3
    return direction, offset


def make_xyz_lut(
    w: int,
    h: int,
    beam_altitude_deg: np.ndarray,
    beam_azimuth_deg: np.ndarray,
    lidar_origin_to_beam_origin_mm: float = 0.0,
    lidar_to_sensor_transform: np.ndarray | None = None,
    extrinsic: np.ndarray | None = None,
) -> XyzLut:
    """Build the projection LUT on host (numpy, f64) then cast to f32."""
    direction, offset = make_xyz_lut_np(
        w, h, beam_altitude_deg, beam_azimuth_deg,
        lidar_origin_to_beam_origin_mm, lidar_to_sensor_transform,
        extrinsic)
    return XyzLut(
        direction=jnp.asarray(direction, jnp.float32),
        offset=jnp.asarray(offset, jnp.float32),
    )


def project(lut: XyzLut, range_m: jax.Array) -> jax.Array:
    """Range image [H, W] (meters, 0 = invalid) -> points [H, W, 3].

    Invalid pixels project to the sensor-origin offset; callers must carry
    the ``range_m > 0`` mask (the reference masks with ``RANGE != 0``,
    ``src/ptudes/kiss.py:59-61``).
    """
    return lut.direction * range_m[..., None] + lut.offset


def scan_to_points(
    lut: XyzLut, range_m: jax.Array, decimate: int = 1
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Full scan -> flat (points [H*W/d, 3], mask [H*W/d], col_ts01).

    ``col_ts01`` are per-column normalized timestamps
    ``linspace(0, 1, W, endpoint=False)`` tiled over rows, exactly the
    deskew timestamps the reference builds (``src/ptudes/kiss.py:34-35``).

    ``decimate`` > 1 keeps the FIRST VALID return of each group of
    ``decimate`` adjacent columns per beam row (its exact direction, range
    and column timestamp — not an average). Adjacent columns are a few cm
    apart at typical ranges, far below the 0.5*voxel downsample that
    immediately follows in the odometry pipeline, so decimation removes
    points the dedup would discard anyway — at half (d=2) the cost of
    every full-width stage (projection, deskew, clip, voxel scatter,
    compaction). Static shapes: output width is H*W/d regardless of data.
    """
    h, w = range_m.shape
    if decimate == 1:
        pts = project(lut, range_m).reshape(h * w, 3)
        mask = (range_m > 0).reshape(h * w)
        ts = jnp.tile(jnp.arange(w, dtype=jnp.float32) / w, (h,))
        return pts, mask, ts

    assert w % decimate == 0
    g = w // decimate
    rm = range_m.reshape(h, g, decimate)
    valid = rm > 0
    k = jnp.argmax(valid, axis=-1)                          # first valid col
    r = jnp.take_along_axis(rm, k[..., None], -1)[..., 0]   # [h, g]
    dirs = lut.direction.reshape(h, g, decimate, 3)
    offs = lut.offset.reshape(h, g, decimate, 3)
    d = jnp.take_along_axis(dirs, k[..., None, None], -2)[..., 0, :]
    o = jnp.take_along_axis(offs, k[..., None, None], -2)[..., 0, :]
    pts = (d * r[..., None] + o).reshape(h * g, 3)
    mask = jnp.any(valid, axis=-1).reshape(h * g)
    cols = jnp.arange(g, dtype=jnp.int32)[None, :] * decimate + k
    ts = (cols.astype(jnp.float32) / w).reshape(h * g)
    return pts, mask, ts


def destagger(field: jax.Array, pixel_shift_by_row: jax.Array) -> jax.Array:
    """Shift each row by its per-beam offset for a spatially coherent 2D image
    (ouster-sdk ``client.destagger`` equivalent; viz-only in the reference)."""
    h = field.shape[0]

    def roll_row(row, shift):
        return jnp.roll(row, shift, axis=0)

    return jax.vmap(roll_row)(field, pixel_shift_by_row.astype(jnp.int32))


def reduce_active_beams_mask(h: int, beams_num: int) -> np.ndarray:
    """Row mask keeping ``beams_num`` uniformly spaced beams.

    Equivalent of the reference's ``reduce_active_beams`` which zeroes RANGE
    rows to simulate low-res sensors (``src/ptudes/utils.py:328-341``);
    here a mask multiply instead of in-place mutation.
    """
    keep = np.zeros(h, dtype=bool)
    keep[np.linspace(0, h, num=beams_num, endpoint=False, dtype=int)] = True
    return keep
