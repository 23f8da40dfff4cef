"""Fixed-capacity voxel hash map in device memory.

JAX replacement for kiss-icp's C++ ``VoxelHashMap`` (reference call
sites ``src/ptudes/kiss.py:108-114,129,161``): a persistent local map that
supports

* ``insert``  — scatter up to ``max_points_per_voxel`` points per voxel,
* ``query``   — nearest neighbor over the 27- (or 7-) voxel neighborhood,
* ``remove_far`` — distance-based eviction around the current origin,

all with static shapes, pure-functional updates, and only scatter/gather
primitives, so the whole structure lives in the ``lax.scan`` carry of the
odometry loop (SURVEY.md section 7, stage 4).

Layout — designed around gather cost, which grows with the NUMBER of
gathered rows more than with bytes: all per-slot metadata lives in ONE
packed row

    meta   [C, 8] int32 — [fingerprint, count, rep_x, rep_y, rep_z]
                          (rep = first point, f32 bitcast; fp 0 = free)
    points [C, P] int32 — stored points QUANTIZED to 3 x 10-bit sub-voxel
                          offsets (voxel_size/1024 resolution — 0.3 mm at
                          0.3 m voxels, far below lidar noise)

Quantized point storage exists for the INSERT path, not memory: a
single-element i32 scatter per point replaces a 3-wide f32 window
update. Decoding
needs the voxel corner, recovered anywhere as ``voxel_coords(rep)`` —
the representative is a full-precision stored point INSIDE its voxel,
so the floor at decode time reproduces the insert-time coordinate
exactly.

so a query fetches fingerprint + count + representative point with a
single row gather per (neighbor, probe). The NN search then ranks the
neighborhood by representative distance and gathers the full point list
only for the two best candidates (``approx=True``, default) or for all
found voxels (``approx=False``, exact, used by tests). Fingerprint
aliasing (two voxel keys, same 32-bit fingerprint AND same slot) has
probability ~2^-32 per probe and at worst injects one wrong NN candidate.

Insert protocol: (A) every point first searches its FULL probe chain for an
existing entry; (B) still-unresolved points claim free slots round by
round, arbitrated by scatter-min of batch index — same-voxel losers match
the winner's slot in the same round's post-claim check. Because lookup
precedes claiming and both insert and query scan the whole chain, eviction
(slots reset free) never creates duplicate or unreachable entries.

Keep the load factor low (capacity >= ~8x expected voxels) so the default
2-probe chains cover effectively all collisions; a key that cannot be
resolved within the chain is dropped (insert) or reported not-found
(query).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .voxel import voxel_coords

_INT_MAX = np.int32(2**31 - 1)  # numpy: no device-array creation at import

# neighborhood offsets sorted by L1 norm: [0] = center, [1:7] = faces,
# [7:19] = edges, [19:27] = corners — so slicing [:7] gives the face
# neighborhood and [:27] the full one
_NEIGHBOR_OFFSETS = np.array(
    sorted(
        [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
        key=lambda o: (abs(o[0]) + abs(o[1]) + abs(o[2])),
    ),
    dtype=np.int32,
)

META_W = 8  # padded row width (32 B, lane-friendly)

QBITS = 10                # sub-voxel quantization bits per axis
QSCALE = 1 << QBITS       # 1024 steps -> voxel_size/1024 resolution
_QMASK = QSCALE - 1


def pack_points(pts: jax.Array, coords: jax.Array,
                voxel_size: float) -> jax.Array:
    """Quantize points (..., 3) to one int32 each: 3 x QBITS sub-voxel
    offsets relative to ``coords`` (their ``voxel_coords``)."""
    frac = pts / voxel_size - coords.astype(pts.dtype)       # [0, 1)
    q = jnp.clip((frac * QSCALE).astype(jnp.int32), 0, _QMASK)
    return q[..., 0] | (q[..., 1] << QBITS) | (q[..., 2] << (2 * QBITS))


def unpack_points(packed: jax.Array, coords: jax.Array,
                  voxel_size: float) -> jax.Array:
    """Inverse of :func:`pack_points` to mid-step precision: (..., 3) f32
    from (...,) int32 + the voxel coordinate (broadcast against packed)."""
    q = jnp.stack([
        packed & _QMASK,
        (packed >> QBITS) & _QMASK,
        (packed >> (2 * QBITS)) & _QMASK,
    ], axis=-1).astype(jnp.float32)
    return (coords.astype(jnp.float32) + (q + 0.5) * (1.0 / QSCALE)) \
        * voxel_size


class VoxelHashMap(NamedTuple):
    meta: jax.Array    # [C, 8] int32 packed per-slot metadata
    points: jax.Array  # [C, P] int32 quantized points (see pack_points)

    # --- decoded views (cheap, fused by XLA) ---
    @property
    def fps(self) -> jax.Array:
        return self.meta[:, 0]

    @property
    def counts(self) -> jax.Array:
        return self.meta[:, 1]

    @property
    def reps(self) -> jax.Array:
        return jax.lax.bitcast_convert_type(self.meta[:, 2:5], jnp.float32)


def _mix(h: jax.Array) -> jax.Array:
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    return h ^ (h >> 16)


def _fingerprint_and_slot(
    coords: jax.Array, capacity: int
) -> tuple[jax.Array, jax.Array]:
    """64 bits of mixed hash per voxel coord: one 32-bit word -> fingerprint
    (never 0), another -> home slot."""
    c = coords.astype(jnp.uint32)
    h1 = _mix(c[..., 0] * jnp.uint32(73856093)) \
        ^ (_mix(c[..., 1] * jnp.uint32(19349669)) * jnp.uint32(0x9E3779B9)) \
        ^ (_mix(c[..., 2] * jnp.uint32(83492791)) * jnp.uint32(0x517CC1B7))
    slot = (_mix(h1) & jnp.uint32(capacity - 1)).astype(jnp.int32)
    fp = _mix(h1 ^ jnp.uint32(0xDEADBEEF))
    fp = jnp.where(fp == 0, jnp.uint32(1), fp).astype(jnp.int32)
    return fp, slot


def gather_rows(table: jax.Array, s: jax.Array,
                fill: int = 0) -> jax.Array:
    """Row gather ``table[s]`` with OOB fill — with the index tensor
    reshaped to a (flat/2, 2) matrix first (ROADMAP 3.6: an earlier
    backend's gather lowering ran faster per row with a small minor index
    dimension; whether it pays on the GPU is not measured).
    Order-preserving reshape, so the result (reshaped back) is
    bit-identical. Result shape: ``s.shape + (table.shape[-1],)``.
    """
    shp = s.shape
    flatn = 1
    for d in shp:
        flatn *= d
    if flatn % 2 == 0 and flatn >= 4096 and shp[-1:] != (2,):
        s2 = s.reshape(flatn // 2, 2)
        rows = table.at[s2].get(mode="fill", fill_value=fill)
        return rows.reshape(shp + (table.shape[-1],))
    return table.at[s].get(mode="fill", fill_value=fill)


def create(capacity: int, max_points_per_voxel: int) -> VoxelHashMap:
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    return VoxelHashMap(
        meta=jnp.zeros((capacity, META_W), jnp.int32),
        points=jnp.zeros((capacity, max_points_per_voxel), jnp.int32),
    )


def stored_points(m: VoxelHashMap, voxel_size: float) -> jax.Array:
    """Decode the WHOLE table to (C, P, 3) f32 (exports/tests — the hot
    paths decode only gathered candidate rows)."""
    corners = voxel_coords(m.reps, voxel_size)               # [C, 3]
    return unpack_points(m.points, corners[:, None, :], voxel_size)


def num_points(m: VoxelHashMap) -> jax.Array:
    return jnp.sum(m.counts)


def num_voxels(m: VoxelHashMap) -> jax.Array:
    return jnp.sum((m.counts > 0).astype(jnp.int32))


def is_empty(m: VoxelHashMap) -> jax.Array:
    return num_points(m) == 0


@partial(jax.jit, inline=True,
         static_argnames=("voxel_size", "max_probes"))
def insert(
    m: VoxelHashMap,
    pts: jax.Array,          # [N, 3]
    mask: jax.Array,         # [N] bool
    *,
    voxel_size: float,
    max_probes: int = 2,
) -> VoxelHashMap:
    """Insert masked points (kiss ``VoxelHashMap::AddPoints`` semantics:
    append until the voxel holds ``max_points_per_voxel`` points)."""
    cap = m.meta.shape[0]
    ppv = m.points.shape[1]
    n = pts.shape[0]

    coords = voxel_coords(pts, voxel_size)
    fp, h0 = _fingerprint_and_slot(coords, cap)
    idx = jnp.arange(n, dtype=jnp.int32)

    fps = m.meta[:, 0]
    slot = jnp.full((n,), cap, jnp.int32)                    # cap = "dropped"
    resolved = ~mask

    # phase A — lookup over the full probe chain
    for r in range(max_probes):
        s = (h0 + r) & (cap - 1)
        match = (~resolved) & (fps[s] == fp)
        slot = jnp.where(match, s, slot)
        resolved = resolved | match

    # phase B — claim rounds
    is_new = jnp.zeros((n,), bool)
    for r in range(max_probes):
        s = (h0 + r) & (cap - 1)
        free = fps[s] == 0
        want = (~resolved) & free
        claim = jnp.full((cap,), _INT_MAX, jnp.int32)
        claim = claim.at[s].min(jnp.where(want, idx, _INT_MAX), mode="drop")
        won = want & (claim[s] == idx)
        fps = fps.at[jnp.where(won, s, cap)].set(fp, mode="drop")
        match = (~resolved) & (fps[s] == fp)
        slot = jnp.where(match, s, slot)
        is_new = is_new | won
        resolved = resolved | match

    # rank within slot (stable by batch index) via sort + run position
    order = jnp.argsort(slot, stable=True)
    slot_sorted = slot[order]
    pos = jnp.arange(n, dtype=jnp.int32)
    run_start = jnp.where(
        jnp.concatenate([jnp.array([True]), slot_sorted[1:] != slot_sorted[:-1]]),
        pos,
        0,
    )
    run_start = jax.lax.associative_scan(jnp.maximum, run_start)
    rank = jnp.zeros((n,), jnp.int32).at[order].set(pos - run_start)

    counts = m.meta[:, 1]
    base = counts.at[slot].get(mode="fill", fill_value=0)
    write_pos = base + rank
    accept = resolved & (write_pos < ppv)

    # NOTE: keep the 2D-coordinate scatter — reshaping the carried [C,P]
    # buffer to scatter at a linear row index defeats XLA's in-place
    # aliasing of the lax.scan carry and copies the whole map every scan.
    tgt_slot = jnp.where(accept, slot, cap)                  # OOB -> dropped
    points = m.points.at[tgt_slot, jnp.where(accept, write_pos, 0)].set(
        pack_points(pts, coords, voxel_size), mode="drop"
    )
    # column-wise updates as flat 1D/row scatters (no windowed scatters
    # into [C, 8] columns), then one row-stack
    counts = counts.at[tgt_slot].add(accept.astype(jnp.int32), mode="drop")
    rep_tgt = jnp.where(accept & (write_pos == 0), slot, cap)
    pts_i32 = jax.lax.bitcast_convert_type(pts, jnp.int32)
    reps_i32 = m.meta[:, 2:5].at[rep_tgt].set(pts_i32, mode="drop")
    meta = jnp.concatenate(
        [fps[:, None], counts[:, None], reps_i32, m.meta[:, 5:]], axis=1)
    return VoxelHashMap(meta=meta, points=points)


@partial(jax.jit, inline=True,
         static_argnames=("voxel_size", "max_probes", "new_capacity",
                          "overflow", "logical_capacity", "batch_rows"))
def insert_deduped(
    m: VoxelHashMap,
    pts: jax.Array,          # [N, 3] — MUST be deduped at voxel_size/2
    mask: jax.Array,         # [N] bool
    *,
    voxel_size: float,
    max_probes: int = 2,
    new_capacity: int = 8192,
    overflow: bool | str = True,
    slot_base: jax.Array | None = None,  # [N] int32 per-point slot offset
    logical_capacity: int | None = None,
    batch_rows: int | None = None,
    evict_origin: jax.Array | None = None,  # [3] fuse remove_far here
    evict_r2: jax.Array | None = None,      # [] squared radius (inf = none)
) -> VoxelHashMap:
    """Occupancy-deduped insert for sub-voxel-unique batches.

    Precondition: at most one masked point per (voxel_size/2) cell — what
    the kiss frame downsample guarantees. Each map voxel then stores at
    most 8 points, one per sub-voxel octant, tracked as a bitmask in the
    packed meta row (col 5). Points whose octant is already occupied are
    skipped BEFORE the expensive scatters, which run on a compacted
    ``new_capacity`` buffer — so steady-state insert cost scales with the
    number of genuinely new points (scene turnover), not with frame size.
    Points dropped by the compaction capacity are retried naturally on the
    next scan (they remain "new" until stored).

    ``overflow`` selects how new points beyond ``new_capacity`` are
    handled: ``True`` = always run the chunked fori_loop (exact, but even
    its zero-trip execution costs ~0.45 ms at bench shapes — the map
    rides in the while carry); ``"cond"`` = exact, but the fori_loop sits
    under ONE ``lax.cond`` so scans with no overflow pay only the
    untaken-branch boundary (~0.1 ms); ``False`` = no loop at all, the
    new set decimates evenly to ``new_capacity`` and the rest retries.

    kiss-icp parity note: kiss appends until max_points_per_voxel with no
    spatial constraint inside the voxel; the octant rule stores a strictly
    better-spread subset (>= 1 point per occupied half-resolution cell),
    which is what the NN search and plane fits actually consume.

    ``evict_origin``/``evict_r2``: fold the post-insert distance eviction
    (:func:`remove_far` semantics — evict AFTER insert, around the new
    pose) into this insert's meta rebuild. remove_far as a separate op
    re-streams the full meta table (read + write ~32 MB at 2^19 slots);
    fused here it is a cheap ``where`` on the column arrays
    already in flight. Freshly inserted scan points are range-clipped to
    max_range and can never be evicted by it, so fused order == separate
    order.

    Batched-replica mode (``slot_base``/``logical_capacity``/``batch_rows``;
    see :func:`insert_deduped_batched`): the table holds B independent maps
    in disjoint slot ranges ``[b*logical_capacity, (b+1)*logical_capacity)``
    and every probe adds the point's ``slot_base``. All scatters stay
    UNBATCHED single ops over the flat table — ``vmap``ping this insert
    instead lowers to batched scatters.
    """
    cap_total = m.meta.shape[0]
    cap = cap_total if logical_capacity is None else logical_capacity
    ppv = m.points.shape[1]
    assert ppv >= 8, "insert_deduped stores up to 8 octant points per voxel"
    assert cap & (cap - 1) == 0 and cap_total % cap == 0

    def at_base(s, base):
        return s if base is None else base + s

    coords = voxel_coords(pts, voxel_size)
    sub = voxel_coords(pts, 0.5 * voxel_size) - 2 * coords   # [N,3] in {0,1}
    sub_id = sub[:, 0] + 2 * sub[:, 1] + 4 * sub[:, 2]       # [N] 0..7
    fp, h0 = _fingerprint_and_slot(coords, cap)

    # --- phase A at full width: one meta-row gather per probe gives
    # fingerprint + occupancy together
    slot = jnp.full((pts.shape[0],), cap_total, jnp.int32)
    occ = jnp.zeros((pts.shape[0],), jnp.int32)
    found = jnp.zeros((pts.shape[0],), bool)
    free_seen = jnp.zeros((pts.shape[0],), bool)
    for r in range(max_probes):
        s = at_base((h0 + r) & (cap - 1), slot_base)
        rows = gather_rows(m.meta, s)                        # [N, 8]
        match = (rows[:, 0] == fp) & ~found
        slot = jnp.where(match, s, slot)
        occ = jnp.where(match, rows[:, 5], occ)
        found = found | match
        free_seen = free_seen | (rows[:, 0] == 0)

    # "new" = storable-new only: octant-free points of an existing voxel,
    # or points whose probe chain has a free slot to claim. Points whose
    # whole chain is occupied by OTHER voxels are unstorable under the
    # probe policy — without this test they would be re-marked new every
    # scan and permanently waste chunk capacity on doomed claim attempts
    # (with max_probes=1 at ~6% load that is ~6% of every frame).
    is_new = mask & jnp.where(
        found, ~((occ >> sub_id) & 1).astype(bool), free_seen)
    if batch_rows is not None and batch_rows > 1:
        # batched-replica mode: chunk budget, decimation and chunk
        # MEMBERSHIP are all per replica — flat chunk c then contains
        # exactly the points each replica's own chunk c would, so claim
        # rounds see the same intra-replica contenders in the same order
        # and the stored content matches B independent inserts exactly
        # (flat-position chunking instead shifts probe-chain interactions
        # across chunk boundaries and diverges at high load factors)
        per = new_capacity // batch_rows
        nb = is_new.reshape(batch_rows, -1)
        pos_b = jnp.cumsum(nb.astype(jnp.int32), axis=1) - 1
        if overflow is False:
            # per-replica even decimation (the single-sequence rule)
            assert nb.shape[1] * per < 2**31
            n_b = jnp.maximum(pos_b[:, -1:] + 1, 1)
            nb = nb & ((pos_b * per) % n_b < per)
            is_new = nb.reshape(-1)
            pos_b = jnp.cumsum(nb.astype(jnp.int32), axis=1) - 1
        new_pos = pos_b.reshape(-1)          # per-replica position
        chunk_den = per                       # chunk c: pos in [c*per, ...)
        n_new = jnp.max(pos_b[:, -1]) + 1     # chunk trips = worst replica
    else:
        new_pos = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        chunk_den = new_capacity
        n_new = jnp.sum(is_new.astype(jnp.int32))

    from .voxel import compact_with_payload
    payload = jnp.stack(
        [slot, found.astype(jnp.int32)]
        + ([] if slot_base is None else [slot_base]), axis=1)  # [N, 2|3]

    def insert_chunk(state, chunk_mask):
        """Claim + write one compacted chunk of new points."""
        fps, counts, occ_col, reps_i32, points = state
        cpts, cpay, cmask = compact_with_payload(
            pts, payload, chunk_mask, new_capacity)
        cslot = jnp.where(cmask, cpay[:, 0], cap_total)
        cfound = cmask & (cpay[:, 1] > 0)
        cbase = None if slot_base is None else cpay[:, 2]

        ccoords = voxel_coords(cpts, voxel_size)
        csub = voxel_coords(cpts, 0.5 * voxel_size) - 2 * ccoords
        csub_id = jnp.where(
            cmask, csub[:, 0] + 2 * csub[:, 1] + 4 * csub[:, 2], 0)
        cfp, ch0 = _fingerprint_and_slot(ccoords, cap)
        cidx = jnp.arange(new_capacity, dtype=jnp.int32)

        # claim rounds for points whose voxel doesn't exist yet
        resolved = ~cmask | cfound
        for r in range(max_probes):
            s = at_base((ch0 + r) & (cap - 1), cbase)
            free = fps[s] == 0
            want = (~resolved) & free
            claim = jnp.full((cap_total,), _INT_MAX, jnp.int32)
            claim = claim.at[s].min(jnp.where(want, cidx, _INT_MAX),
                                    mode="drop")
            won = want & (claim[s] == cidx)
            fps = fps.at[jnp.where(won, s, cap_total)].set(cfp, mode="drop")
            match = (~resolved) & (fps[s] == cfp)
            cslot = jnp.where(match, s, cslot)
            resolved = resolved | match

        accept = cmask & (cslot < cap_total) & resolved

        # batch occupancy bits per slot (distinct octants -> add == or)
        bit = jnp.where(accept, jnp.int32(1) << csub_id, 0)
        tgt = jnp.where(accept, cslot, cap_total)
        batch_bits = jnp.zeros((cap_total,), jnp.int32).at[tgt].add(
            bit, mode="drop")

        # rank within batch = popcount of lower bits; base = stored count
        x = batch_bits[tgt] & ((jnp.int32(1) << csub_id) - 1)
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        rank = (((x + (x >> 4)) & 0x0F0F0F0F) * 0x01010101) >> 24

        base = counts.at[cslot].get(mode="fill", fill_value=0)
        write_pos = base + rank
        accept = accept & (write_pos < ppv)
        tgt = jnp.where(accept, cslot, cap_total)

        points = points.at[tgt, jnp.where(accept, write_pos, 0)].set(
            pack_points(cpts, ccoords, voxel_size), mode="drop")
        counts = counts.at[tgt].add(accept.astype(jnp.int32), mode="drop")
        occ_col = occ_col.at[tgt].add(
            jnp.where(accept, jnp.int32(1) << csub_id, 0), mode="drop")
        rep_tgt = jnp.where(accept & (write_pos == 0), cslot, cap_total)
        pts_i32 = jax.lax.bitcast_convert_type(cpts, jnp.int32)
        reps_i32 = reps_i32.at[rep_tgt].set(pts_i32, mode="drop")
        return fps, counts, occ_col, reps_i32, points

    state = (m.meta[:, 0], m.meta[:, 1], m.meta[:, 5], m.meta[:, 2:5],
             m.points)
    # chunk 0 always runs; overflow chunks (bootstrap scans where most of
    # the frame is new) run inside ONE dynamic-trip fori_loop — zero
    # iterations in steady state. A per-chunk lax.cond chain costs one
    # carry-copy boundary per cond even on the untaken branch; the single
    # while pays that boundary once — but even a ZERO-trip dynamic loop
    # carries the full map state, so pipelines run ONLY the bootstrap
    # scans with overflow=True (models/lio.run_sequence).
    # ``overflow=False`` has no loop at all: the new-point set DECIMATES
    # EVENLY (same Bresenham rule as voxel.compact) to the chunk budget
    # and the rest stays "new" and retries next scan. Even decimation
    # instead of first-N truncation matters: insert order is scan order,
    # so truncation starved the END of every frontier sweep and cost ATE
    # 0.0205 -> 0.0251 on the bench scene; decimation degrades the
    # frontier isotropically instead (measured parity with full overflow).
    n_chunks = max(1, -(-pts.shape[0] // new_capacity))
    pre_decimated = (overflow is False and batch_rows is not None
                     and batch_rows > 1)   # row-wise decimation done above
    if overflow or n_chunks == 1 or pre_decimated:
        state = insert_chunk(state, is_new & (new_pos < chunk_den))
    else:
        assert pts.shape[0] * new_capacity < 2**31
        state = insert_chunk(
            state,
            is_new & ((new_pos * new_capacity) % jnp.maximum(n_new, 1)
                      < new_capacity))
    if n_chunks > 1 and overflow:
        needed = (n_new + chunk_den - 1) // chunk_den

        def chunk_body(c, st):
            lo = c * chunk_den
            return insert_chunk(
                st, is_new & (new_pos >= lo) & (new_pos < lo + chunk_den))

        def run_rest(st):
            return jax.lax.fori_loop(
                1, jnp.minimum(needed, n_chunks), chunk_body, st)

        if overflow == "cond":
            state = jax.lax.cond(needed > 1, run_rest, lambda st: st, state)
        else:
            state = run_rest(state)

    fps, counts, occ_col, reps_i32, points = state
    if evict_origin is not None:
        assert evict_r2 is not None
        reps_f = jax.lax.bitcast_convert_type(reps_i32, jnp.float32)
        d2 = jnp.sum((reps_f - evict_origin[None, :]) ** 2, axis=-1)
        evict = (counts > 0) & (d2 > evict_r2)
        zero = jnp.int32(0)
        fps = jnp.where(evict, zero, fps)
        counts = jnp.where(evict, zero, counts)
        occ_col = jnp.where(evict, zero, occ_col)
    meta = jnp.concatenate(
        [fps[:, None], counts[:, None], reps_i32, occ_col[:, None],
         m.meta[:, 6:]], axis=1)
    return VoxelHashMap(meta=meta, points=points)


def create_batched(batch: int, capacity: int,
                   max_points_per_voxel: int) -> VoxelHashMap:
    """B independent maps in ONE flat table (disjoint slot ranges).

    The batched-replica pipeline (``parallel.batched``) carries this flat
    layout so the map insert runs as single unbatched scatters; per-replica
    views for the (vmap-safe) gather/dense stages are just reshapes:
    ``meta.reshape(B, C, 8)`` / ``points.reshape(B, C, P)``.
    """
    assert capacity & (capacity - 1) == 0
    return VoxelHashMap(
        meta=jnp.zeros((batch * capacity, META_W), jnp.int32),
        points=jnp.zeros((batch * capacity, max_points_per_voxel),
                         jnp.int32),
    )


@partial(jax.jit, inline=True,
         static_argnames=("voxel_size", "max_probes", "new_capacity",
                          "overflow", "logical_capacity"))
def insert_deduped_batched(
    m: VoxelHashMap,         # flat [(B*C), ...] (create_batched layout)
    pts: jax.Array,          # [B, N, 3] — each row deduped at voxel_size/2
    mask: jax.Array,         # [B, N] bool
    *,
    voxel_size: float,
    max_probes: int = 2,
    new_capacity: int = 8192,   # per-replica new-point budget
    overflow: bool | str = True,
    logical_capacity: int,
) -> VoxelHashMap:
    """Insert B replicas' frames into the flat B-map table in ONE pass.

    Replica b's points hash into slots ``[b*C, (b+1)*C)`` — keys never
    collide across replicas, so correctness matches B independent
    :func:`insert_deduped` calls exactly (for the exact overflow modes the
    final map CONTENT is identical: the octant rule is content-addressed
    and per-replica inputs are sub-voxel-unique). The point: every scatter
    stays a single unbatched op, where ``vmap``ping the insert lowers to
    batched scatters.
    """
    b, n, _ = pts.shape
    base = (jnp.arange(b * n, dtype=jnp.int32) // n) * logical_capacity
    return insert_deduped(
        m, pts.reshape(b * n, 3), mask.reshape(b * n),
        voxel_size=voxel_size, max_probes=max_probes,
        new_capacity=b * new_capacity, overflow=overflow,
        slot_base=base, logical_capacity=logical_capacity, batch_rows=b)


@partial(jax.jit, inline=True, static_argnames=("logical_capacity",))
def remove_far_batched(
    m: VoxelHashMap,          # flat [(B*C), ...]
    origins: jax.Array,       # [B, 3]
    max_range2: jax.Array,    # [B]
    *,
    logical_capacity: int,
) -> VoxelHashMap:
    """Per-replica :func:`remove_far` over the flat B-map table
    (elementwise — reshaped views, no scatters)."""
    b = origins.shape[0]
    meta3 = m.meta.reshape(b, logical_capacity, META_W)
    occupied = meta3[:, :, 1] > 0
    reps = jax.lax.bitcast_convert_type(meta3[:, :, 2:5], jnp.float32)
    d2 = jnp.sum((reps - origins[:, None, :]) ** 2, axis=-1)
    evict = occupied & (d2 > max_range2[:, None])
    keep_cols = jnp.asarray([0, 0, 1, 1, 1, 0, 1, 1], jnp.int32)[None, None]
    meta = jnp.where(evict[..., None], meta3 * keep_cols, meta3)
    return VoxelHashMap(meta=meta.reshape(m.meta.shape), points=m.points)


def _argmin_select(d2: jax.Array, pts3: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(min d2, pts3 row at the first argmin) via one-hot reductions.

    take_along_axis lowers to a row gather; compare+reduce over the
    candidate axis is elementwise work at the same result (ROADMAP 3.6:
    not re-measured on the GPU)."""
    dmin = jnp.min(d2, axis=-1)
    oneh = d2 == dmin[:, None]
    oneh = oneh & (jnp.cumsum(oneh.astype(jnp.int32), axis=-1) == 1)
    nn = jnp.sum(jnp.where(oneh[..., None], pts3, 0.0), axis=1)
    return dmin, nn


class QueryResult(NamedTuple):
    nn: jax.Array      # [M, 3] nearest stored point
    d2: jax.Array      # [M] squared distance (inf if not found)
    found: jax.Array   # [M] bool
    slot: jax.Array    # [M] int32 slot of the voxel containing nn (cap if none)


@partial(
    jax.jit,
    static_argnames=("voxel_size", "max_probes", "approx", "neighborhood"),
)
def query(
    m: VoxelHashMap,
    q: jax.Array,            # [M, 3]
    *,
    voxel_size: float,
    max_probes: int = 2,
    approx: bool = True,
    neighborhood: int = 27,
) -> QueryResult:
    """Nearest stored neighbor of each query point over adjacent voxels
    (kiss-icp ``GetClosestNeighbor`` semantics; ``neighborhood`` = 27 for
    the full cube, 7 for center+faces — ~4x fewer gather rows, misses NNs
    that sit across an edge/corner, which robust ICP tolerates).

    Also reports the winning voxel's slot so callers can fetch the voxel's
    full point list (e.g. for point-to-plane normal fits) without a second
    search.
    """
    assert neighborhood in (7, 27)
    cap = m.meta.shape[0]
    ppv = m.points.shape[1]
    mnum = q.shape[0]

    qc = voxel_coords(q, voxel_size)                          # [M, 3]
    offsets = jnp.asarray(_NEIGHBOR_OFFSETS[:neighborhood])   # [J, 3]
    keys = qc[:, None, :] + offsets[None, :, :]               # [M, J, 3]
    fp, h0 = _fingerprint_and_slot(keys, cap)                 # [M, J]

    found_slot = jnp.full((mnum, neighborhood), cap, jnp.int32)
    found = jnp.zeros((mnum, neighborhood), bool)
    cnt = jnp.zeros((mnum, neighborhood), jnp.int32)
    rep = jnp.zeros((mnum, neighborhood, 3), jnp.float32)
    for r in range(max_probes):
        s = (h0 + r) & (cap - 1)
        rows = gather_rows(m.meta, s)                         # [M, J, 8]
        match = (rows[..., 0] == fp) & ~found
        found_slot = jnp.where(match, s, found_slot)
        cnt = jnp.where(match, rows[..., 1], cnt)
        rep = jnp.where(
            match[..., None],
            jax.lax.bitcast_convert_type(rows[..., 2:5], jnp.float32),
            rep,
        )
        found = found | match

    # stage 1: rank neighbor voxels by representative-point distance
    rep_d2 = jnp.sum((rep - q[:, None, :]) ** 2, axis=-1)     # [M, J]
    rep_d2 = jnp.where(found, rep_d2, jnp.inf)

    if approx:
        # stage 2 over two candidate voxels: the rep-nearest one and the
        # query's own (center) voxel — the latter guarantees exact self-
        # matches (offsets[0] is the center voxel)
        rd_min = jnp.min(rep_d2, axis=-1)                     # [M]
        oneh = rep_d2 == rd_min[:, None]
        oneh = oneh & (jnp.cumsum(oneh.astype(jnp.int32), -1) == 1)
        best_slot = jnp.sum(found_slot * oneh, axis=-1)
        best_rep = jnp.sum(rep * oneh[..., None], axis=1)     # [M, 3]
        best_ok = jnp.isfinite(rd_min)
        center_slot = found_slot[:, 0]
        center_rep = rep[:, 0]
        center_ok = found[:, 0]

        best_d2 = jnp.full((mnum,), jnp.inf, jnp.float32)
        best_nn = jnp.zeros((mnum, 3), jnp.float32)
        win_slot = jnp.full((mnum,), cap, jnp.int32)
        for sl, rp, ok in ((best_slot, best_rep, best_ok),
                           (center_slot, center_rep, center_ok)):
            packed = m.points.at[sl].get(mode="fill", fill_value=0)
            vox_pts = unpack_points(
                packed, voxel_coords(rp, voxel_size)[:, None, :],
                voxel_size)                                   # [M, P, 3]
            c = m.meta.at[sl, 1].get(mode="fill", fill_value=0)
            d2 = jnp.sum((vox_pts - q[:, None, :]) ** 2, axis=-1)
            valid = (jnp.arange(ppv, dtype=jnp.int32)[None, :]
                     < c[:, None]) & ok[:, None]
            d2 = jnp.where(valid, d2, jnp.inf)
            dmin, nn = _argmin_select(d2, vox_pts)
            better = dmin < best_d2
            best_nn = jnp.where(better[:, None], nn, best_nn)
            win_slot = jnp.where(better, sl, win_slot)
            best_d2 = jnp.where(better, dmin, best_d2)
        ok = jnp.isfinite(best_d2)
        return QueryResult(
            jnp.where(ok[:, None], best_nn, 0.0), best_d2, ok, win_slot)

    # exact: running min over all neighbors' full point lists
    best_d2 = jnp.full((mnum,), jnp.inf, jnp.float32)
    best_nn = jnp.zeros((mnum, 3), jnp.float32)
    win_slot = jnp.full((mnum,), cap, jnp.int32)
    for j in range(neighborhood):
        sl = found_slot[:, j]
        packed = m.points.at[sl].get(mode="fill", fill_value=0)
        vox_pts = unpack_points(
            packed, voxel_coords(rep[:, j], voxel_size)[:, None, :],
            voxel_size)
        d2 = jnp.sum((vox_pts - q[:, None, :]) ** 2, axis=-1)
        valid = (jnp.arange(ppv, dtype=jnp.int32)[None, :]
                 < cnt[:, j:j + 1]) & found[:, j:j + 1]
        d2 = jnp.where(valid, d2, jnp.inf)
        dmin, nn = _argmin_select(d2, vox_pts)
        better = dmin < best_d2
        best_nn = jnp.where(better[:, None], nn, best_nn)
        win_slot = jnp.where(better, sl, win_slot)
        best_d2 = jnp.where(better, dmin, best_d2)
    ok = jnp.isfinite(best_d2)
    return QueryResult(
        jnp.where(ok[:, None], best_nn, 0.0), best_d2, ok, win_slot)


@partial(jax.jit, inline=True)
def remove_far(
    m: VoxelHashMap, origin: jax.Array, max_range2: jax.Array
) -> VoxelHashMap:
    """Evict voxels whose representative (first) point is farther than
    sqrt(max_range2) from origin (kiss ``RemovePointsFarFromLocation``)."""
    occupied = m.counts > 0
    d2 = jnp.sum((m.reps - origin[None, :]) ** 2, axis=-1)
    evict = occupied & (d2 > max_range2)
    # zero fp (col 0), count (col 1) and octant occupancy (col 5);
    # reps/points become dead storage
    keep_cols = jnp.asarray([0, 0, 1, 1, 1, 0, 1, 1], jnp.int32)[None, :]
    meta = jnp.where(evict[:, None], m.meta * keep_cols, m.meta)
    return VoxelHashMap(meta=meta, points=m.points)
