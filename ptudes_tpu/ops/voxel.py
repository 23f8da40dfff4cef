"""Static-shape voxel downsampling.

JAX equivalent of kiss-icp's C++ ``voxel_down_sample`` (reference
call site ``src/ptudes/kiss.py:96`` via ``voxelize``): keep the FIRST point
falling into each voxel (kiss semantics — insertion order), with all shapes
static.

Design (SURVEY.md section 7, stage 5): instead of a hash-set with dynamic
growth, we scatter each point's linear index into a scratch table slot
addressed by a spatial hash of its voxel coordinate, reducing with ``min``.
A point survives iff it won its slot (lowest index == first in scan order).
True hash collisions (two different voxels, same slot) drop the losing
voxel's points entirely — an acceptable, slightly stronger downsample with
probability ~N/table_size (<2% at defaults); the table is sized in
:class:`ptudes_tpu.config.Capacity` (``dedup_table``).

Compaction to a fixed output capacity is a single cumsum+scatter (no sort).
"""
from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

# numpy scalars: creating device arrays at import time would initialize
# jax's default backend before callers can select a platform.
_H1 = np.uint32(73856093)
_H2 = np.uint32(19349669)
_H3 = np.uint32(83492791)
_INT_MAX = np.int32(2**31 - 1)


def voxel_coords(pts: jax.Array, voxel_size: float) -> jax.Array:
    """Points (..., 3) -> integer voxel coordinates (..., 3) int32."""
    return jnp.floor(pts / voxel_size).astype(jnp.int32)


def spatial_hash(coords: jax.Array, table_size: int) -> jax.Array:
    """3D spatial hash -> [0, table_size).

    kiss-icp's classic prime-multiply hash has structured low bits, which
    collide badly under power-of-two masking on dense voxel grids; a
    murmur3-style finalizer mixes the high bits down.
    """
    c = coords.astype(jnp.uint32)

    def mix(h):
        h = h ^ (h >> 16)
        h = h * jnp.uint32(0x85EBCA6B)
        h = h ^ (h >> 13)
        h = h * jnp.uint32(0xC2B2AE35)
        return h ^ (h >> 16)

    # mixing each coordinate independently before combining removes the
    # linear structure that makes xor-of-multiplies collide on dense grids
    h = (
        mix(c[..., 0] * _H1)
        ^ (mix(c[..., 1] * _H2) * jnp.uint32(0x9E3779B9))
        ^ (mix(c[..., 2] * _H3) * jnp.uint32(0x517CC1B7))
    )
    h = mix(h)
    return (h & jnp.uint32(table_size - 1)).astype(jnp.int32)


def window_prededup_mask(
    pts: jax.Array,
    mask: jax.Array,
    voxel_size: float,
    grid_hw: tuple[int, int],
    rows: int = 4,
    cols: int = 4,
) -> jax.Array:
    """Grid-local voxel pre-dedup: drop points whose voxel id also appears
    at a causally-earlier pixel within a (rows x +-cols) window of the
    range image.

    Pure elementwise compares on the [H, W] grid — NO scatter. Adjacent
    range-image pixels are millimeters-to-centimeters apart in 3D, so this
    window removes the bulk (~95%) of sub-voxel duplicates; the exact
    scatter-table dedup then runs on the COMPACTED survivors at ~1/4 the
    width: ~100k rows of dedup work move from scatter to elementwise
    compares. Survivors are a superset of the exact
    first-in-voxel set — running :func:`first_in_voxel_mask` after this
    yields the identical final point set (modulo compaction capacity).

    Column shifts wrap — correct for 360-degree sweeps, where the last
    column is physically adjacent to the first. (For partial-FOV windows a
    wrap-boundary pixel may be deduped against a column-wrapped neighbor,
    so the surviving representative of a voxel can differ from the exact
    scan-order-first point there; one-point-per-voxel still holds since
    offsets are causal and mutual elimination is impossible.) Row shifts
    do NOT wrap: the comparisons against the bottom rows that jnp.roll
    would introduce for the top ``rows-1`` rows are masked out, so a row-0
    point is never deduped against a causally-later bottom-row point.
    """
    h, w = grid_hw
    ids = spatial_hash(voxel_coords(pts, voxel_size), 1 << 31).reshape(h, w)
    m = mask.reshape(h, w)
    keep = m
    row = jnp.arange(h, dtype=jnp.int32)
    for dr in range(0, -rows, -1):
        for dc in range(-cols, cols + 1):
            if dr == 0 and dc >= 0:
                continue
            sh_ids = jnp.roll(ids, (-dr, -dc), axis=(0, 1))
            sh_m = jnp.roll(m, (-dr, -dc), axis=(0, 1))
            if dr != 0:
                # rows rolled down by -dr: the first -dr rows wrapped
                # around from the bottom (causally later) — exclude them
                sh_m = sh_m & (row >= -dr)[:, None]
            keep = keep & ~((sh_ids == ids) & sh_m)
    return keep.reshape(h * w)


def first_in_voxel_mask(
    pts: jax.Array, mask: jax.Array, voxel_size: float, table_size: int
) -> jax.Array:
    """Mark the first valid point of each voxel.

    Returns a bool mask [N] — True for points that survive the downsample.
    """
    n = pts.shape[0]
    slots = spatial_hash(voxel_coords(pts, voxel_size), table_size)
    idx = jnp.arange(n, dtype=jnp.int32)
    cand = jnp.where(mask, idx, _INT_MAX)
    table = jnp.full((table_size,), _INT_MAX, jnp.int32)
    table = table.at[slots].min(cand)
    return mask & (table[slots] == idx)


def _take_pad(col: jax.Array, capacity: int) -> jax.Array:
    """First ``capacity`` entries of a 1-D column, zero-padded if short."""
    if col.shape[0] >= capacity:
        return col[:capacity]
    pad = jnp.zeros((capacity - col.shape[0],), col.dtype)
    return jnp.concatenate([col, pad])


def _perm_sort(keys: tuple) -> tuple:
    """Stable sort of ``keys`` carrying ONLY a permutation payload.

    Returns ``(*sorted_keys, perm)``. Payload columns are then fetched with
    one row gather by ``perm`` (usually sliced to the output capacity
    first). Sorting the payload columns along instead is what the original
    formulation did, but on an earlier backend multi-operand sort compile
    time grew with every operand at >=32k width and dominated the cold
    pipeline compile (on the GPU: not measured).
    """
    n = keys[0].shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    return jax.lax.sort(tuple(keys) + (iota,), num_keys=len(keys),
                        is_stable=True)


def compact(
    pts: jax.Array, mask: jax.Array, capacity: int, fill: float = 0.0,
    decimate_overflow: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Pack masked points to the front of a fixed-size [capacity, 3] buffer.

    Implemented as ONE stable sort by the inverted mask: keepers bubble to
    the front in original order (stable), then slice to capacity, instead
    of the obvious cumsum+scatter formulation. Points beyond ``capacity`` are dropped — or, with
    ``decimate_overflow=True``, the overflow is spread EVENLY over the
    keepers in scan order (keep position p iff ``(p*capacity) % n_keep <
    capacity``: exactly ``capacity`` evenly-spaced survivors) instead of
    truncating the tail. A range-image scan is column-ordered, so plain
    truncation cuts off the END of the sweep — a spatial bias — while
    even decimation degrades resolution isotropically (the behavior a
    capacity knob should have for ICP sources). No-op when the keepers
    fit: every position satisfies the test, and the cost is one
    elementwise mask fold before the same single sort.
    """
    if decimate_overflow:
        # i32 product bound (x64 stays off)
        assert pts.shape[0] * capacity < 2**31, (
            "decimate_overflow: N*capacity must fit int32")
        pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
        n_keep = jnp.maximum(pos[-1] + 1, 1)
        mask = mask & ((pos * capacity) % n_keep < capacity)
    drop = (~mask).astype(jnp.int32)
    _, perm = _perm_sort((drop,))
    head = _take_pad(perm, capacity)         # pad rows masked out below
    out = pts.at[head].get(mode="fill", fill_value=fill)
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), capacity)
    out_mask = jnp.arange(capacity, dtype=jnp.int32) < count
    out = jnp.where(out_mask[:, None], out, fill)
    return out, out_mask


def compact_with_payload(
    pts: jax.Array,
    payload: jax.Array,
    mask: jax.Array,
    capacity: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Like :func:`compact` but carries a per-point payload column (e.g.
    deskew timestamps). payload shape [N] or [N, K]."""
    pay2d = payload if payload.ndim == 2 else payload[:, None]
    drop = (~mask).astype(jnp.int32)
    _, perm = _perm_sort((drop,))
    head = _take_pad(perm, capacity)
    out = pts.at[head].get(mode="fill", fill_value=0.0)
    outp = pay2d.at[head].get(mode="fill", fill_value=0)
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), capacity)
    out_mask = jnp.arange(capacity, dtype=jnp.int32) < count
    out = jnp.where(out_mask[:, None], out, 0.0)
    outp = jnp.where(out_mask[:, None], outp, 0)
    if payload.ndim == 1:
        outp = outp[:, 0]
    return out, outp, out_mask


def first_in_voxel_sorted(
    pts: jax.Array, mask: jax.Array, voxel_size: float, capacity: int
) -> tuple[jax.Array, jax.Array]:
    """First-point-per-voxel dedup via ONE stable sort — no scatters.

    Sorts by (dropped, voxel-hash) with xyz payloads: valid points bubble
    to the front grouped by voxel, original scan order preserved within a
    voxel (stable), so run-starts are exactly the first-in-scan-order
    survivors the table-based :func:`first_in_voxel_mask` selects. Returns
    the REORDERED points plus their keep mask, sliced to ``capacity`` —
    callers that don't care about point order (map insert, a following
    compact) use this to replace a scatter-min + gather round trip with
    one sort.

    Hash aliasing between distinct voxels drops the losing voxel's points
    like the table variant, but at 31-bit hash width (~1e-4 points/scan)
    instead of table width.

    When the input is wider than ``capacity``, run starts are computed at
    FULL width and the keepers are compacted to the front with a second
    stable sort before slicing — a dense scan whose valid count exceeds
    ``capacity`` loses only unique voxels beyond capacity, never valid
    points hidden behind sliced-away runs (the silent-drop failure of a
    naive slice). When the input already fits, the single-sort fast path
    is exact and the second sort is skipped.
    """
    n = pts.shape[0]
    h = spatial_hash(voxel_coords(pts, voxel_size), 1 << 31)
    drop = (~mask).astype(jnp.int32)
    d, hh, perm = _perm_sort((drop, h))
    n_valid = jnp.sum(mask.astype(jnp.int32))
    if n <= capacity:
        d = _take_pad(d, capacity)
        hh = _take_pad(hh, capacity)
        head = _take_pad(perm, capacity)
        out = pts.at[head].get(mode="fill", fill_value=0.0)
        first = jnp.concatenate(
            [jnp.ones((1,), bool), hh[1:] != hh[:-1]])
        in_range = jnp.arange(capacity, dtype=jnp.int32) < n_valid
        keep = (d == 0) & first & in_range
        out = jnp.where(keep[:, None], out, 0.0)
        return out, keep
    first = jnp.concatenate([jnp.ones((1,), bool), hh[1:] != hh[:-1]])
    in_range = jnp.arange(n, dtype=jnp.int32) < n_valid
    keep_full = (d == 0) & first & in_range
    # second (key, iota) sort over the once-sorted order, composed into
    # ONE final row gather from the ORIGINAL points by perm[perm2]
    _, perm2 = _perm_sort(((~keep_full).astype(jnp.int32),))
    head = _take_pad(perm2, capacity)
    final_idx = perm.at[head].get(mode="fill", fill_value=0)
    out = pts.at[final_idx].get(mode="fill", fill_value=0.0)
    count = jnp.minimum(jnp.sum(keep_full.astype(jnp.int32)), capacity)
    out_mask = jnp.arange(capacity, dtype=jnp.int32) < count
    out = jnp.where(out_mask[:, None], out, 0.0)
    return out, out_mask


def voxel_downsample(
    pts: jax.Array,
    mask: jax.Array,
    voxel_size: float,
    capacity: int,
    table_size: int,
) -> tuple[jax.Array, jax.Array]:
    """First-point-per-voxel downsample into a fixed-capacity buffer."""
    keep = first_in_voxel_mask(pts, mask, voxel_size, table_size)
    return compact(pts, keep, capacity)


def range_clip_mask(
    pts: jax.Array, mask: jax.Array, min_range: float, max_range: float
) -> jax.Array:
    """kiss-icp ``Preprocess`` equivalent: clip by point norm
    (reference pipeline step ``src/ptudes/kiss.py:93``; CLI defaults 1/70 m,
    ``src/ptudes/cli/ekf_bench.py:356-363``)."""
    d2 = jnp.sum(pts * pts, axis=-1)
    return mask & (d2 >= min_range * min_range) & (d2 <= max_range * max_range)
