"""Robust ICP (Gauss-Newton) against the voxel hash map.

JAX equivalent of ``kiss_icp.registration.register_frame`` (reference
call site ``src/ptudes/kiss.py:108-114``): the hottest code of the whole
reference pipeline (SURVEY.md section 3.1).

Two loss modes:

``loss="point"`` — kiss-icp parity: point-to-point with the robust weight
    w(r^2) = kernel^2 / (kernel + r^2)^2, kernel = sigma/3, correspondences
    re-searched each iteration within 3*sigma, J_i = [-hat(p_i) | I3] at
    the transformed point, update T <- exp(dx) @ T, early stop at
    ||dx|| < 1e-4 realised as a convergence mask inside a fixed-trip-count
    ``lax.fori_loop``.

``loss="plane"`` (default in the LIO pipeline) — point-to-plane using
    normals fitted on the fly from each matched voxel's stored points
    (``ops.plane``): residual s = n . (p - centroid), row = [(p x n), n].
    Correspondences whose voxel is non-planar (planarity below threshold
    or too few points) fall back to the point-to-point residual, so sparse
    structure still constrains the solve. Point-to-plane removes the
    sampling-pattern tangential forces ("ring-lock") that make pure
    point-to-point odometry wobble and smear the map on flat ground —
    a deliberate improvement over the reference (LOAM/FAST-LIO lineage).

Device mapping: the NN search is gather-bound (hash map probes); the GN
build is one einsum over stacked row Jacobians. A Tikhonov floor keeps
the 6x6 solve nonsingular, which also yields dx = 0 on an empty map — the
first frame then returns the initial guess exactly like kiss does.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geom import se3, so3
from ..geom.linalg import solve_spd6
from . import backend, hashmap
from .plane import smallest_eigvec_sym3, voxel_plane


class IcpResult(NamedTuple):
    pose: jax.Array        # [4, 4] refined pose (world_T_scan)
    num_corr: jax.Array    # correspondences used in the last iteration
    iterations: jax.Array  # iterations until convergence (== max if never)
    # model deviation |trans| / |log rot| of guess^-1 @ pose, filled by
    # the fused-loop kernel (computed in its epilogue — the adaptive
    # threshold inputs); None on paths that leave it to the caller
    dev_t: jax.Array | None = None
    dev_r: jax.Array | None = None


class CandidateSet(NamedTuple):
    """Per-source-point NN candidates, gathered ONCE per registration.

    The voxel map is immutable during ICP and a good initial guess moves
    the pose by millimeters per GN iteration, so the candidate voxels
    (top-V of the 27-neighborhood by representative distance at the guess
    pose) are valid for every iteration. This turns the reference's
    per-iteration hash queries (the gather-bound hot loop,
    ``kiss_icp::registration`` re-searching NNs each step) into one gather
    + K iterations of pure dense elementwise math and reductions.

    The plane fit is PER POINT over the whole gathered candidate patch
    (cross-voxel), not per voxel: single-scan maps hold only 1-3 points
    per voxel — never enough for a voxel-local fit — which forces
    point-to-point matching whose tangential NN bias systematically
    underestimates motion on ground-dominated scenes. The patch fit gives
    valid ground normals from the very first map scan. (A capability the
    reference cannot express: kiss-icp only ever sees one voxel's points
    per correspondence.)
    """
    pts: jax.Array       # [M, V*P, 3] candidate points
    valid: jax.Array     # [M, V*P] bool
    normal: jax.Array    # [M, 3] per-point patch plane normal
    centroid: jax.Array  # [M, 3]
    quality: jax.Array   # [M] planarity in [0, 1]


def gather_candidates(
    vmap_: hashmap.VoxelHashMap,
    pts_w: jax.Array,          # [M, 3] query points (source at guess pose)
    *,
    voxel_size: float,
    max_probes: int = 2,
    neighborhood: int = 27,
    n_voxels: int = 4,
    fit_planes: bool = True,
    plane_radius: float | None = None,
    slot_base: jax.Array | None = None,
    logical_capacity: int | None = None,
) -> CandidateSet:
    """Fetch the ``n_voxels`` nearest candidate voxels' point lists.

    Ranking is by representative-point distance (first stored point per
    voxel, carried in the packed meta row), same as the approx query. The
    per-point patch plane fit (for the point-to-plane loss) happens here
    too: voxel contents don't change during ICP, so normals are
    loop-invariant. ``plane_radius`` bounds the patch around the query
    point (default 1.5 * voxel_size).

    ``slot_base``/``logical_capacity``: flat multi-replica table mode
    (``hashmap.create_batched`` layout) — hashing uses the logical
    per-replica capacity and every probe adds the scalar ``slot_base``
    (= replica * logical_capacity). The point of this plumbing: the
    replica-batched driver vmaps the scan step with the table UNBATCHED
    (in_axes None) and only ``slot_base`` batched, so these gathers
    lower as single flat-index-space gathers instead of batched gathers
    (which serialize per row per replica, like the batched scatters the
    flat insert already avoids — docs/PERF.md).
    """
    cap_total = vmap_.meta.shape[0]
    cap = cap_total if logical_capacity is None else logical_capacity
    ppv = vmap_.points.shape[1]
    mnum = pts_w.shape[0]
    from .voxel import voxel_coords

    qc = voxel_coords(pts_w, voxel_size)                      # [M, 3]
    if neighborhood == 4:
        # octant-directed: the query's sub-voxel position picks center +
        # the 3 face neighbors on ITS side — the half-space where the
        # true NN lives unless it is farther than the opposing face
        # (> voxel_size/2 + eps away, already beyond typical 3*sigma).
        # 4 meta rows/point instead of 7 (the gather is row-serialized).
        frac = pts_w / voxel_size - qc.astype(pts_w.dtype)    # [M, 3] in [0,1)
        side = jnp.where(frac >= 0.5, 1, -1).astype(jnp.int32)
        zeros = jnp.zeros_like(side)
        offsets = jnp.stack([
            zeros,
            jnp.stack([side[:, 0], zeros[:, 0], zeros[:, 0]], -1),
            jnp.stack([zeros[:, 0], side[:, 1], zeros[:, 0]], -1),
            jnp.stack([zeros[:, 0], zeros[:, 0], side[:, 2]], -1),
        ], axis=1)                                            # [M, 4, 3]
        keys = qc[:, None, :] + offsets
    else:
        offsets = jnp.asarray(
            hashmap._NEIGHBOR_OFFSETS[:neighborhood])         # [J, 3]
        keys = qc[:, None, :] + offsets[None, :, :]           # [M, J, 3]
    fp, h0 = hashmap._fingerprint_and_slot(keys, cap)         # [M, J]

    found_slot = jnp.full((mnum, neighborhood), cap_total, jnp.int32)
    found = jnp.zeros((mnum, neighborhood), bool)
    cnt = jnp.zeros((mnum, neighborhood), jnp.int32)
    rep = jnp.zeros((mnum, neighborhood, 3), jnp.float32)
    for r in range(max_probes):
        s = (h0 + r) & (cap - 1)
        if slot_base is not None:
            s = s + slot_base
        rows = hashmap.gather_rows(vmap_.meta, s)
        match = (rows[..., 0] == fp) & ~found
        found_slot = jnp.where(match, s, found_slot)
        cnt = jnp.where(match, rows[..., 1], cnt)
        rep = jnp.where(
            match[..., None],
            jax.lax.bitcast_convert_type(rows[..., 2:5], jnp.float32),
            rep,
        )
        found = found | match

    rep_d2 = jnp.sum((rep - pts_w[:, None, :]) ** 2, axis=-1)
    rep_d2 = jnp.where(found, rep_d2, jnp.inf)

    # iterative top-V selection by one-hot multiply-sums instead of
    # take_along_axis row gathers (3 per V step); ROADMAP 3.6 asks
    # whether that still pays on the GPU
    jidx = jnp.arange(neighborhood, dtype=jnp.int32)[None, :]
    sel_slot, sel_cnt, sel_ok, sel_rep = [], [], [], []
    d = rep_d2
    for _ in range(n_voxels):
        j = jnp.argmin(d, axis=-1)                            # [M]
        oneh = (jidx == j[:, None])                           # [M, J]
        sel_slot.append(jnp.sum(found_slot * oneh, axis=-1))
        sel_cnt.append(jnp.sum(cnt * oneh, axis=-1))
        sel_rep.append(jnp.sum(rep * oneh[..., None], axis=1))
        sel_ok.append(jnp.isfinite(
            jnp.sum(jnp.where(oneh, d, 0.0), axis=-1)))
        d = jnp.where(oneh, jnp.inf, d)
    slot_v = jnp.stack(sel_slot, axis=1)                      # [M, V]
    cnt_v = jnp.where(jnp.stack(sel_ok, 1), jnp.stack(sel_cnt, 1), 0)
    rep_v = jnp.stack(sel_rep, axis=1)                        # [M, V, 3]

    packed = hashmap.gather_rows(vmap_.points, slot_v)        # [M, V, P]
    from .voxel import voxel_coords as _vc
    vox_pts = hashmap.unpack_points(
        packed, _vc(rep_v, voxel_size)[:, :, None, :], voxel_size)
    valid = (jnp.arange(ppv, dtype=jnp.int32)[None, None, :]
             < cnt_v[:, :, None])                             # [M, V, P]
    cpts = vox_pts.reshape(mnum, n_voxels * ppv, 3)
    cvalid = valid.reshape(mnum, n_voxels * ppv)

    if fit_planes:
        r = 1.5 * voxel_size if plane_radius is None else plane_radius
        d2g = jnp.sum((cpts - pts_w[:, None, :]) ** 2, axis=-1)
        w = (cvalid & (d2g <= r * r)).astype(jnp.float32)     # [M, C]
        n_in = jnp.sum(w, axis=-1)                            # [M]
        denom = jnp.maximum(n_in, 1.0)
        centroid = jnp.sum(cpts * w[..., None], axis=1) / denom[:, None]
        d = (cpts - centroid[:, None, :]) * w[..., None]
        cov = jnp.einsum("mpi,mpj->mij", d, d) / denom[:, None, None]
        normal, quality = smallest_eigvec_sym3(cov)
        quality = jnp.where(n_in >= 4, quality, 0.0)
    else:
        normal = jnp.zeros((mnum, 3), jnp.float32)
        centroid = jnp.zeros((mnum, 3), jnp.float32)
        quality = jnp.zeros((mnum,), jnp.float32)

    return CandidateSet(
        pts=cpts, valid=cvalid,
        normal=normal, centroid=centroid, quality=quality,
    )


def gn_from_candidates(
    t_cur: jax.Array,         # [4, 4]
    source: jax.Array,        # [N, 3]
    source_mask: jax.Array,   # [N]
    cand: CandidateSet,
    kernel: jax.Array,
    max_d2: jax.Array,
    *,
    loss: str,
    plane_min_quality: float,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One GN normal-equation build against a fixed candidate set.

    Pure dense math (no gathers). Returns (jtj [6,6], jtr [6],
    n_corr, total_weight) — additive across point shards, so the sharded
    pipeline psums them directly (the one hot-loop collective).
    """
    n = source.shape[0]
    eye3 = jnp.eye(3, dtype=jnp.float32)
    cand_inf = jnp.where(cand.valid, 0.0, jnp.inf)            # [N, C]

    pts_w = se3.transform(t_cur, source)                      # [N, 3]
    d2 = jnp.sum((cand.pts - pts_w[:, None, :]) ** 2, axis=-1) + cand_inf
    d2min, nn = hashmap._argmin_select(d2, cand.pts)          # no row gather
    found = jnp.isfinite(d2min)
    corr = source_mask & found & (d2min <= max_d2)
    r_vec = pts_w - nn

    if loss == "plane":
        use_plane = corr & (cand.quality >= plane_min_quality)
        s = jnp.sum(cand.normal * (pts_w - cand.centroid), axis=-1)
        w_pl = jnp.where(
            use_plane,
            (kernel * kernel) / jnp.square(kernel + s * s), 0.0)
        row = jnp.concatenate(
            [jnp.cross(pts_w, cand.normal), cand.normal], axis=-1)
        jtj_pl = jnp.einsum("ni,nj->ij", row * w_pl[:, None], row)
        jtr_pl = jnp.einsum("ni,n->i", row * w_pl[:, None], s)
        use_point = corr & ~use_plane
        w_pl_sum = jnp.sum(w_pl)
    else:
        use_point = corr
        jtj_pl = jnp.zeros((6, 6), jnp.float32)
        jtr_pl = jnp.zeros((6,), jnp.float32)
        w_pl_sum = 0.0

    w_pt = jnp.where(
        use_point,
        (kernel * kernel) / jnp.square(kernel + d2min), 0.0)
    hat_p = so3.hat(pts_w)
    j = jnp.concatenate(
        [-hat_p, jnp.broadcast_to(eye3, (n, 3, 3))], axis=-1)
    jw = j * w_pt[:, None, None]
    jtj = jnp.einsum("nij,nik->jk", jw, j) + jtj_pl
    jtr = jnp.einsum("nij,ni->j", jw, r_vec) + jtr_pl
    total_w = jnp.sum(w_pt) + w_pl_sum
    return jtj, jtr, jnp.sum(corr), total_w


def drift_metric(t_gather: jax.Array, t_cur: jax.Array) -> jax.Array:
    """Worst-case candidate staleness: translation + rotation sweep at a
    nominal 17.5 m lever arm (half a typical clip range)."""
    rel = se3.inv(t_gather) @ t_cur
    dt = jnp.linalg.norm(se3.trans(rel))
    theta = jnp.linalg.norm(so3.log_rotmat(se3.rot(rel)))
    return dt + theta * 0.5 * 35.0


@partial(
    jax.jit,
    inline=True,
    static_argnames=(
        "voxel_size", "max_probes", "max_iterations", "loss",
        "plane_min_quality", "prior_rot_weight", "prior_trans_weight",
        "neighborhood", "n_voxels", "plane_radius", "gn_backend",
        "refresh_drift", "gn_unroll", "axis_name", "logical_capacity",
    ),
)
def register_frame_cached(
    source: jax.Array,        # [N, 3] deskewed, voxelized source points
    source_mask: jax.Array,   # [N] bool
    vmap_: hashmap.VoxelHashMap,
    initial_guess: jax.Array,  # [4, 4]
    max_distance: jax.Array,   # scalar: 3 * sigma
    kernel: jax.Array,         # scalar: sigma / 3
    *,
    voxel_size: float,
    max_probes: int = 2,
    max_iterations: int = 50,
    convergence: float = 1e-4,
    loss: str = "plane",
    plane_min_quality: float = 0.2,
    prior_rot_weight: float = 0.0,
    prior_trans_weight: float = 0.0,
    neighborhood: int = 27,
    n_voxels: int = 4,
    plane_radius: float | None = None,
    gn_backend: str = "auto",
    refresh_drift: float = 0.5,
    gn_unroll: int = 1,
    axis_name: str | None = None,
    slot_base: jax.Array | None = None,
    logical_capacity: int | None = None,
) -> IcpResult:
    """Gather-once robust GN ICP (see :class:`CandidateSet`).

    Same objective as :func:`register_frame` but with the NN candidates
    (and plane fits) hoisted out of the iteration loop: per iteration only
    a dense [M, V*P] distance + argmin + GN normal-equation build remain —
    no hash probes, no gathers, no data-dependent memory traffic.

    ``gn_backend``: "xla" runs the loop as a ``while_loop`` around
    :func:`gn_from_candidates`; "triton" runs the whole loop in one
    kernel (``ops.pallas_icp``; requires frozen candidates and no
    ``axis_name``); "auto" lets ``ops.backend`` pick from the platform,
    and takes the XLA loop wherever the kernel cannot run.

    ``axis_name``: when set (inside shard_map), ``source``/``source_mask``
    are this device's shard of the full source and the 6x6 GN system is
    ``psum``-reduced over the named mesh axis each iteration — the ONE
    hot-loop collective of the point-sharded pipeline (~200 bytes/iter).
    The initial guess and map must be replicated; the returned pose,
    counts and iteration numbers are then identical on all shards.

    ``gn_unroll``: GN steps per ``while_loop`` body (no-refresh path
    only). Each step is convergence-masked (dx = 0, counters frozen once
    converged), so the result is IDENTICAL for any unroll factor; the
    while boundary is paid once per ``gn_unroll`` steps instead of once
    per step, and ``gn_unroll=max_iterations`` is a fixed-count loop with
    no data-dependent predicate.
    """
    assert loss in ("point", "plane")
    refresh = refresh_drift > 0.0
    if gn_backend == "auto":
        gn_backend = backend.choose("gn_loop")
        if axis_name is not None or refresh:
            gn_backend = "xla"
    if gn_backend not in ("xla", "triton"):
        raise ValueError(f"unknown gn_backend {gn_backend!r}")
    if gn_backend == "triton" and (axis_name is not None or refresh):
        raise ValueError(
            "the fused GN kernel needs frozen candidates "
            "(nn_refresh_drift=0) and cannot psum under a point mesh")
    max_d2 = max_distance * max_distance
    guess = initial_guess.astype(jnp.float32)
    guess_inv = se3.inv(guess)
    # re-gather when the pose has drifted > refresh_drift voxels from the
    # gather pose — keeps candidates exact while a poor guess is still
    # moving, freezes them (one gather total) once the solve is in the
    # basin. refresh_drift == 0 removes the refresh cond from the loop
    # entirely (the cheap branch still pays carry copies every iteration).
    refresh_th = refresh_drift * voxel_size

    def fetch(t_at):
        return gather_candidates(
            vmap_, se3.transform(t_at, source),
            voxel_size=voxel_size, max_probes=max_probes,
            neighborhood=neighborhood, n_voxels=n_voxels,
            fit_planes=(loss == "plane"), plane_radius=plane_radius,
            slot_base=slot_base, logical_capacity=logical_capacity,
        )

    cand0 = fetch(guess)

    if gn_backend == "triton":
        from .pallas_icp import icp_loop
        pose, n_corr, iters, dev_t, dev_r = icp_loop(
            source, source_mask, cand0, guess, kernel, max_d2, convergence,
            plane_min_quality=plane_min_quality,
            max_iterations=max_iterations,
            prior_rot_weight=prior_rot_weight,
            prior_trans_weight=prior_trans_weight, loss=loss)
        return IcpResult(pose=pose, num_corr=n_corr, iterations=iters,
                         dev_t=dev_t, dev_r=dev_r)

    def gn_step(t_cur, cand, converged, n_corr, iters):
        # freeze on the iteration cap as well as convergence: with
        # gn_unroll > 1 the while cond is only checked per BODY, so the
        # per-step mask must enforce the cap to keep any unroll factor
        # result-identical to unroll=1
        converged = jnp.logical_or(converged, iters >= max_iterations)
        jtj, jtr, corr_n, total_w = gn_from_candidates(
            t_cur, source, source_mask, cand, kernel, max_d2,
            loss=loss, plane_min_quality=plane_min_quality)

        if axis_name is not None:
            # the one hot-loop collective: 6x6 system over the mesh
            jtj = jax.lax.psum(jtj, axis_name)
            jtr = jax.lax.psum(jtr, axis_name)
            corr_n = jax.lax.psum(corr_n, axis_name)
            total_w = jax.lax.psum(total_w, axis_name)

        if prior_rot_weight > 0.0 or prior_trans_weight > 0.0:
            xi = se3.log_pose(t_cur @ guess_inv)
            wp = total_w * jnp.asarray(
                [prior_rot_weight] * 3 + [prior_trans_weight] * 3,
                jnp.float32)
            jtj = jtj + jnp.diag(wp)
            jtr = jtr + wp * xi

        jtj = jtj + 1e-8 * jnp.eye(6, dtype=jtj.dtype)
        dx = solve_spd6(jtj, -jtr)
        dx = jnp.where(converged, 0.0, dx)

        t_new = se3.exp_twist(dx) @ t_cur
        now_conv = jnp.linalg.norm(dx) < convergence
        iters = jnp.where(converged, iters, iters + 1)
        return (t_new, converged | now_conv,
                jnp.where(converged, n_corr, corr_n), iters)

    z32 = jnp.asarray(0, jnp.int32)
    if refresh:
        def body(carry):
            t_cur, t_gather, cand, converged, n_corr, iters = carry
            stale = drift_metric(t_gather, t_cur) > refresh_th
            cand = jax.lax.cond(stale, lambda: fetch(t_cur), lambda: cand)
            t_gather = jnp.where(stale, t_cur, t_gather)
            t_new, conv, n_corr, iters = gn_step(
                t_cur, cand, converged, n_corr, iters)
            return (t_new, t_gather, cand, conv, n_corr, iters)

        def cond(carry):
            return jnp.logical_and(~carry[3], carry[5] < max_iterations)

        init = (guess, guess, cand0, jnp.asarray(False), z32, z32)
        t_final, _, _, _, n_corr, iters = jax.lax.while_loop(
            cond, body, init)
    else:
        # candidates frozen: closure capture, 4-scalar carry — no multi-MB
        # CandidateSet copies through the loop boundary
        def body(carry):
            for _ in range(max(1, gn_unroll)):
                carry = gn_step(carry[0], cand0, carry[1], carry[2],
                                carry[3])
            return carry

        def cond(carry):
            return jnp.logical_and(~carry[1], carry[3] < max_iterations)

        init = (guess, jnp.asarray(False), z32, z32)
        t_final, _, n_corr, iters = jax.lax.while_loop(cond, body, init)
    return IcpResult(pose=t_final, num_corr=n_corr, iterations=iters)


@partial(
    jax.jit,
    inline=True,
    static_argnames=(
        "voxel_size", "max_probes", "max_iterations", "approx", "loss",
        "plane_min_quality", "prior_rot_weight", "prior_trans_weight",
        "neighborhood",
    ),
)
def register_frame(
    source: jax.Array,        # [N, 3] deskewed, voxelized source points
    source_mask: jax.Array,   # [N] bool
    vmap_: hashmap.VoxelHashMap,
    initial_guess: jax.Array,  # [4, 4]
    max_distance: jax.Array,   # scalar: 3 * sigma
    kernel: jax.Array,         # scalar: sigma / 3
    *,
    voxel_size: float,
    max_probes: int = 4,
    max_iterations: int = 50,
    convergence: float = 1e-4,
    approx: bool = True,
    loss: str = "point",
    plane_min_quality: float = 0.2,
    prior_rot_weight: float = 0.0,
    prior_trans_weight: float = 0.0,
    neighborhood: int = 27,
) -> IcpResult:
    """Run fixed-iteration robust GN ICP; returns the refined world pose.

    ``prior_*_weight`` > 0 adds a motion-prior penalty pulling the solution
    toward ``initial_guess`` (the constant-velocity or EKF prediction):
    cost += w * Sum(corr_weights) * ||log(T @ guess^-1)||^2 per component
    group. This bounds how far sampling-noise forces can random-walk the
    pose when the point cost is locally flat — the failure mode of pure
    ICP odometry on self-similar geometry. Weights are relative to the
    total correspondence weight, so the prior scales with scene support.
    Zero (kiss parity) disables it.
    """
    assert loss in ("point", "plane")
    max_d2 = max_distance * max_distance
    n = source.shape[0]
    eye3 = jnp.eye(3, dtype=jnp.float32)
    guess_inv = se3.inv(initial_guess.astype(jnp.float32))

    def body(carry):
        t_cur, converged, n_corr, iters = carry

        pts_w = se3.transform(t_cur, source)
        res = hashmap.query(
            vmap_, pts_w, voxel_size=voxel_size, max_probes=max_probes,
            approx=approx, neighborhood=neighborhood,
        )
        corr = source_mask & res.found & (res.d2 <= max_d2)
        r_vec = pts_w - res.nn                               # [N, 3]

        if loss == "plane":
            packed = vmap_.points.at[res.slot].get(
                mode="fill", fill_value=0)                   # [N, P]
            # res.nn lives in the winning voxel -> its floor recovers the
            # voxel coordinate needed to decode the packed point list
            from .voxel import voxel_coords as _vc
            vox_pts = hashmap.unpack_points(
                packed, _vc(res.nn, voxel_size)[:, None, :], voxel_size)
            cnt = vmap_.meta.at[res.slot, 1].get(mode="fill", fill_value=0)
            normal, centroid, quality = voxel_plane(vox_pts, cnt)
            use_plane = corr & (quality >= plane_min_quality)
            s = jnp.sum(normal * (pts_w - centroid), axis=-1)  # [N]
            w_pl = jnp.where(
                use_plane,
                (kernel * kernel) / jnp.square(kernel + s * s), 0.0)
            row = jnp.concatenate(
                [jnp.cross(pts_w, normal), normal], axis=-1)  # [N, 6]
            jtj_pl = jnp.einsum("ni,nj->ij", row * w_pl[:, None], row)
            jtr_pl = jnp.einsum("ni,n->i", row * w_pl[:, None], s)

            use_point = corr & ~use_plane
        else:
            use_point = corr
            jtj_pl = jnp.zeros((6, 6), jnp.float32)
            jtr_pl = jnp.zeros((6,), jnp.float32)

        w_pt = jnp.where(
            use_point,
            (kernel * kernel) / jnp.square(kernel + res.d2), 0.0)
        hat_p = so3.hat(pts_w)                               # [N, 3, 3]
        j = jnp.concatenate(
            [-hat_p, jnp.broadcast_to(eye3, (n, 3, 3))], axis=-1)
        jw = j * w_pt[:, None, None]
        jtj = jnp.einsum("nij,nik->jk", jw, j) + jtj_pl
        jtr = jnp.einsum("nij,ni->j", jw, r_vec) + jtr_pl

        if prior_rot_weight > 0.0 or prior_trans_weight > 0.0:
            # motion prior: penalize xi = log(T @ guess^-1) (left twist);
            # d xi / d dx = I to first order, so it adds a diagonal block
            # and a restoring force
            total_w = jnp.sum(w_pt) + (
                jnp.sum(w_pl) if loss == "plane" else 0.0)
            xi = se3.log_pose(t_cur @ guess_inv)             # [6] rot,trans
            wp = total_w * jnp.asarray(
                [prior_rot_weight] * 3 + [prior_trans_weight] * 3,
                jnp.float32)
            jtj = jtj + jnp.diag(wp)
            jtr = jtr + wp * xi

        # Tikhonov floor: invertible with zero correspondences -> dx = 0
        jtj = jtj + 1e-8 * jnp.eye(6, dtype=jtj.dtype)
        dx = solve_spd6(jtj, -jtr)
        dx = jnp.where(converged, 0.0, dx)

        t_new = se3.exp_twist(dx) @ t_cur
        now_conv = jnp.linalg.norm(dx) < convergence
        iters = jnp.where(converged, iters, iters + 1)
        return (
            t_new,
            converged | now_conv,
            jnp.where(converged, n_corr, jnp.sum(corr)),
            iters,
        )

    def cond(carry):
        _, converged, _, iters = carry
        return jnp.logical_and(~converged, iters < max_iterations)

    init = (
        initial_guess.astype(jnp.float32),
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    # while_loop exits as soon as the convergence mask latches — on
    # typical scans that is 5-15 iterations instead of the worst case
    t_final, _, n_corr, iters = jax.lax.while_loop(cond, body, init)
    return IcpResult(pose=t_final, num_corr=n_corr, iterations=iters)
