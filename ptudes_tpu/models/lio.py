"""Fused lidar-inertial odometry pipeline: one jit-compiled ``scan_step``
under ``lax.scan``.

This is the flagship model — the JAX re-design of the reference's
``ptudes ekf-bench ouster`` hot loop (``src/ptudes/cli/ekf_bench.py:493-563``,
call stack SURVEY.md section 3.1):

    per scan:  [<=K IMU samples] -> EKF predict (inner lax.scan)
               pose guess (const-velocity | EKF prediction | GT)
               deskew -> clip -> voxelize -> robust ICP -> map update
               EKF update with the ICP pose

The whole step is a pure function over a static-shape ``LioState``; a full
sequence runs as ``lax.scan(scan_step, state, batches)`` entirely on
device, and ``vmap`` over the leading axis of states+batches gives
multi-bag replay / parameter sweeps (SURVEY.md section 2c).

``guess='ekf'`` is the reference's ``--use-imu-prediction`` loosely-coupled
LIO mode (``src/ptudes/cli/ekf_bench.py:342-345,533-535``); ``'gt'`` is the
``--use-gt-guess`` sanity mode; ``'kiss'`` is plain const-velocity kiss.
Scans with no interleaved IMU samples are skipped exactly like the
reference does (``src/ptudes/cli/ekf_bench.py:512-518``) — realised as a
masked state update.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..geom import se3
from ..ops.projection import XyzLut, scan_to_points
from . import esekf, kiss
from .esekf import EkfState, Imu
from .kiss import KissAux, KissState


class LioState(NamedTuple):
    kiss: KissState
    ekf: EkfState


class ScanBatch(NamedTuple):
    """Per-scan input; stack along a leading axis for lax.scan."""
    range_m: jax.Array    # [H, W] meters, 0 = no return
    scan_ts: jax.Array    # [] f32 seconds
    imu: Imu              # lacc/avel [K, 3], ts [K]
    imu_valid: jax.Array  # [K] bool
    guess_pose: jax.Array  # [4, 4] external guess (gt mode; else identity)


class LioOut(NamedTuple):
    kiss_pose: jax.Array   # [4, 4]
    ekf_pose: jax.Array    # [4, 4]
    scan_valid: jax.Array  # bool — False for skipped scans (no IMUs)
    ekf_vel: jax.Array     # [3]
    ekf_bias_gyr: jax.Array  # [3]
    ekf_bias_acc: jax.Array  # [3]
    ekf_grav: jax.Array    # [3]
    ekf_cov_diag: jax.Array  # [18]
    aux: KissAux
    # IMU-rate EKF history ([K] per scan, aligned with batch.imu_valid)
    # when the step is built with log=True; None otherwise. The scan's
    # pose-update is folded into its last valid IMU entry (updated=True
    # there), matching the reference's knot semantics.
    flog: esekf.FilterLog | None = None


# --- packed per-scan output -------------------------------------------
# Every LioOut field stacked by lax.scan costs one dynamic-update-slice
# per scan step; the scan drivers therefore carry ONE flat f32 row per
# scan and unpack it after the scan. Layout (all f32; ints/bools are
# exact in f32 at their value ranges — counts < 2^24):
_PK_KISS_POSE = 0      # 16
_PK_EKF_POSE = 16      # 16
_PK_VALID = 32         # 1
_PK_VEL = 33           # 3
_PK_BG = 36            # 3
_PK_BA = 39            # 3
_PK_GRAV = 42          # 3
_PK_COV = 45           # 18
_PK_AUX = 63           # 7: sigma, dt, drot, n_corr, iters, src_cnt, map_pts
PK_MAP_POINTS = 69     # aux slot the batched driver overwrites
_PK_W = 70


def _pack_out(out: LioOut) -> jax.Array:
    a = out.aux
    return jnp.concatenate([
        out.kiss_pose.reshape(16),
        out.ekf_pose.reshape(16),
        out.scan_valid.reshape(1).astype(jnp.float32),
        out.ekf_vel, out.ekf_bias_gyr, out.ekf_bias_acc, out.ekf_grav,
        out.ekf_cov_diag,
        jnp.stack([
            a.sigma, a.err_dt, a.err_drot,
            a.num_corr.astype(jnp.float32),
            a.iterations.astype(jnp.float32),
            a.source_count.astype(jnp.float32),
            a.map_points.astype(jnp.float32),
        ]),
    ]).astype(jnp.float32)


def unpack_out(p: jax.Array) -> LioOut:
    """Inverse of the packed scan output: [..., _PK_W] -> LioOut."""
    lead = p.shape[:-1]

    def f(lo, n):
        return p[..., lo:lo + n]

    return LioOut(
        kiss_pose=f(_PK_KISS_POSE, 16).reshape(lead + (4, 4)),
        ekf_pose=f(_PK_EKF_POSE, 16).reshape(lead + (4, 4)),
        scan_valid=p[..., _PK_VALID].astype(bool),
        ekf_vel=f(_PK_VEL, 3),
        ekf_bias_gyr=f(_PK_BG, 3),
        ekf_bias_acc=f(_PK_BA, 3),
        ekf_grav=f(_PK_GRAV, 3),
        ekf_cov_diag=f(_PK_COV, 18),
        aux=KissAux(
            sigma=p[..., _PK_AUX + 0],
            err_dt=p[..., _PK_AUX + 1],
            err_drot=p[..., _PK_AUX + 2],
            num_corr=p[..., _PK_AUX + 3].astype(jnp.int32),
            iterations=p[..., _PK_AUX + 4].astype(jnp.int32),
            source_count=p[..., _PK_AUX + 5].astype(jnp.int32),
            map_points=p[..., _PK_AUX + 6].astype(jnp.int32),
        ),
        flog=None,
    )


def init_state(cfg: PipelineConfig,
               init_grav=None, init_bacc=None, init_bgyr=None) -> LioState:
    return LioState(
        kiss=kiss.init_state(cfg.kiss, cfg.cap),
        ekf=esekf.init_state(cfg.ekf, init_grav=init_grav,
                             init_bacc=init_bacc, init_bgyr=init_bgyr),
    )


def make_scan_step(lut: XyzLut, cfg: PipelineConfig,
                   insert_overflow: bool | str = True, log: bool = False,
                   axis_name: str | None = None,
                   defer_insert: bool = False,
                   pack_out: bool = False,
                   map_logical_capacity: int | None = None):
    """Build the jittable scan_step closure over the projection LUT.

    ``insert_overflow=False`` builds the STEADY-state body: the map insert
    handles at most ``cap.max_new_per_scan`` genuinely-new points and
    leaves the rest to retry next scan, skipping the overflow chunk loop
    whose carry boundary carries the whole map. run_sequence runs the
    first (bootstrap) scan with the full-overflow body so the initial
    frame lands in the map in one step.

    ``log=True`` additionally emits the IMU-rate EKF history in
    ``LioOut.flog`` (one FilterLog entry per padded IMU slot; filter by
    ``batch.imu_valid`` on host) — the observability surface the
    reference's ``ESEKF(_logging=True)`` provides for the flagship mode
    (``src/ptudes/cli/ekf_bench.py:640-650``).

    ``axis_name``: build the step for use inside ``shard_map`` with ICP
    points sharded over the named mesh axis (see
    ``kiss.register_scan``) — the SAME step otherwise, so the sharded
    pipeline honors every config knob the single-device one does.

    ``defer_insert``: skip the map insert/evict and return
    ``(state, (out, kiss.DeferredInsert))`` instead of ``(state, out)`` —
    the batched-replica driver (``parallel.batched``) vmaps this step and
    runs the map update itself as flat unbatched scatters.

    ``pack_out``: emit the per-scan output as ONE flat f32 row (see
    :func:`unpack_out`) instead of the LioOut pytree — the lax.scan
    drivers use this to pay one output dynamic-update-slice per scan
    instead of ~15 (log mode excluded: the FilterLog arrays stay
    unpacked).

    ``map_logical_capacity``: flat multi-replica map mode (requires
    ``defer_insert``) — ``state.kiss.local_map`` is the UNBATCHED flat
    B-replica table (``hashmap.create_batched``) and the step takes a
    third argument, the replica's scalar slot base. The batched driver
    vmaps this step with ``in_axes=None`` on the map leaves so the ICP
    candidate gathers stay unbatched (batched gathers row-serialize per
    replica, like the batched scatters the flat insert avoids)."""
    assert not (pack_out and log), "pack_out applies to the log=False path"
    if map_logical_capacity is not None:
        assert defer_insert, "flat-map mode requires defer_insert"

    def scan_step(state: LioState, batch: ScanBatch,
                  map_slot_base: jax.Array | None = None):
        # 1. EKF predict over the scan's IMU block (reference interleaves
        #    ~10 IMUs per scan, ekf_bench.py:491-518)
        flog = None
        need_twist = cfg.deskew_mode == "ekf" and cfg.kiss.deskew
        kernel_twist = None
        if log:
            ekf0_pose = esekf.pose_mat(state.ekf)
            ekf1, flog = esekf.process_imu_batch(
                state.ekf, batch.imu, batch.imu_valid, cfg=cfg.ekf,
                log=True)
        elif need_twist:
            # the predict form also emits the deskew twist (the kernel
            # computes it in its epilogue — no XLA pose algebra)
            ekf1, kernel_twist = esekf.process_imu_batch(
                state.ekf, batch.imu, batch.imu_valid, cfg=cfg.ekf,
                want_twist=True)
        else:
            ekf1 = esekf.process_imu_batch(
                state.ekf, batch.imu, batch.imu_valid, cfg=cfg.ekf)

        # 2. device-side projection
        pts, mask, ts01 = scan_to_points(
            lut, batch.range_m, decimate=cfg.col_decimation)

        # 3. initial-guess policy (ekf_bench.py:533-548)
        if cfg.guess == "ekf":
            guess, use_guess = esekf.pose_mat(ekf1), True
        elif cfg.guess == "gt":
            guess, use_guess = batch.guess_pose, True
        else:
            guess, use_guess = None, False

        # deskew twist: the IMU window (prev_scan_ts, scan_ts] IS the sweep
        # (scan ts = last column ts), so the EKF's integrated motion over
        # the block deskews the sweep exactly — including accelerations,
        # where kiss's const-velocity model lags and smears the map
        deskew_twist = None
        if need_twist:
            deskew_twist = (kernel_twist if kernel_twist is not None
                            else se3.log_pose(
                                se3.inv(ekf0_pose)
                                @ esekf.pose_mat(ekf1)))

        # skip scans with no interleaved IMUs (the reference `continue`s
        # before KISS/update, ekf_bench.py:512-518): the gate rides INTO
        # register_scan (masked insert inputs) instead of a post-hoc
        # jnp.where over the state tree, which would stream the whole
        # carried map through a select every scan
        has_imu = jnp.any(batch.imu_valid)
        h, w, _ = lut.direction.shape
        reg = kiss.register_scan(
            state.kiss, pts, mask, ts01, cfg=cfg.kiss, cap=cfg.cap,
            initial_guess=guess, use_guess=use_guess,
            deskew_twist=deskew_twist, update_ok=has_imu,
            grid_hw=(h, w // cfg.col_decimation),
            insert_overflow=insert_overflow, axis_name=axis_name,
            defer_insert=defer_insert,
            map_slot_base=map_slot_base,
            map_logical_capacity=map_logical_capacity,
            map_frozen=cfg.map_frozen)
        if defer_insert:
            kiss1, pose, aux, deferred = reg
        else:
            kiss1, pose, aux = reg

        # 4. EKF update with the ICP pose (ekf_bench.py:555); small-state
        #    select only (18x18 cov + vectors)
        ekf2 = esekf.process_pose(ekf1, pose, cfg=cfg.ekf)
        ekf_out = esekf.masked_update(ekf1, ekf2, has_imu)
        out_state = LioState(kiss=kiss1, ekf=ekf_out)
        if map_logical_capacity is not None:
            # flat-map mode: return an EMPTY map placeholder — the flat
            # table is carried by the driver, and returning the (vmap-
            # unbatched) full table would make vmap broadcast B copies
            out_state = out_state._replace(kiss=out_state.kiss._replace(
                local_map=jax.tree.map(lambda x: x[:0],
                                       out_state.kiss.local_map)))

        if log:
            # fold the pose update into the scan's LAST valid IMU entry
            # (the reference's update replaces the nav knot at the same
            # timestamp; knot markers come from `updated`)
            k = batch.imu_valid.shape[0]
            last = jnp.sum(batch.imu_valid.astype(jnp.int32)) - 1
            knot = (jnp.arange(k) == last) & has_imu

            def put(seq, post_val):
                m = knot.reshape((k,) + (1,) * (seq.ndim - 1))
                return jnp.where(m, post_val[None], seq)

            flog = esekf.FilterLog(
                ts=flog.ts,
                pos=put(flog.pos, ekf_out.pos),
                vel=put(flog.vel, ekf_out.vel),
                att_q=put(flog.att_q, ekf_out.quat),
                bias_gyr=put(flog.bias_gyr, ekf_out.bias_gyr),
                bias_acc=put(flog.bias_acc, ekf_out.bias_acc),
                grav=put(flog.grav, ekf_out.grav),
                cov_diag=put(flog.cov_diag, jnp.diag(ekf_out.cov)),
                updated=knot,
            )

        out = LioOut(
            # skipped scans (no IMUs) report the FROZEN odometry pose: the
            # reference emits no pose at all for them (`continue`), so the
            # dense output must not leak the discarded ICP result computed
            # from a stale guess
            kiss_pose=jnp.where(has_imu, pose, state.kiss.pose),
            ekf_pose=esekf.pose_mat(out_state.ekf),
            scan_valid=has_imu,
            ekf_vel=out_state.ekf.vel,
            ekf_bias_gyr=out_state.ekf.bias_gyr,
            ekf_bias_acc=out_state.ekf.bias_acc,
            ekf_grav=out_state.ekf.grav,
            ekf_cov_diag=jnp.diag(out_state.ekf.cov),
            aux=aux,
            flog=flog,
        )
        if pack_out:
            out = _pack_out(out)
        if defer_insert:
            return out_state, (out, deferred)
        return out_state, out

    return scan_step


@partial(jax.jit, static_argnames=("cfg", "log"))
def run_sequence(
    state: LioState, batches: ScanBatch, lut: XyzLut, *,
    cfg: PipelineConfig, log: bool = False,
) -> tuple[LioState, LioOut]:
    """lax.scan the fused step over stacked batches (device-resident).

    The FIRST scan runs unrolled with the full-overflow insert (the whole
    initial frame is new and must land in the map at once); the steady
    tail scans with the overflow-free body — mid-sequence bursts beyond
    ``cap.max_new_per_scan`` new points simply retry on following scans.

    ``log=True`` emits the IMU-rate EKF history (``LioOut.flog``, shape
    [N, K] entries; filter with ``batches.imu_valid`` on host).
    """
    n = batches.range_m.shape[0]
    k = n if cfg.bootstrap_scans < 0 else min(cfg.bootstrap_scans, n)
    pk = not log
    unpack = unpack_out if pk else (lambda o: o)
    if cfg.map_frozen:
        # localization-only: no inserts, so no boot/steady split either
        step = make_scan_step(lut, cfg, insert_overflow=False, log=log,
                              pack_out=pk)
        state, out = jax.lax.scan(step, state, batches,
                                  unroll=max(cfg.scan_unroll, 1))
        return state, unpack(out)
    boot = make_scan_step(lut, cfg, insert_overflow=True, log=log,
                          pack_out=pk)
    if k >= n:
        state, out = jax.lax.scan(boot, state, batches)
        return state, unpack(out)
    steady = make_scan_step(lut, cfg,
                            insert_overflow=cfg.steady_insert_mode,
                            log=log, pack_out=pk)
    ur = max(cfg.scan_unroll, 1)
    if k == 0:
        state, out = jax.lax.scan(steady, state, batches, unroll=ur)
        return state, unpack(out)
    head = jax.tree.map(lambda x: x[:k], batches)
    state, out_h = jax.lax.scan(boot, state, head)
    rest = jax.tree.map(lambda x: x[k:], batches)
    state, out_t = jax.lax.scan(steady, state, rest, unroll=ur)
    out = jax.tree.map(
        lambda a, b: jnp.concatenate([a, b], axis=0), out_h, out_t)
    return state, unpack(out)


def flatten_filter_log(flog: esekf.FilterLog,
                       imu_valid: jax.Array) -> esekf.FilterLog:
    """Host-side: flatten a [N, K]-shaped FilterLog from
    ``run_sequence(log=True)`` to the valid IMU-rate entries [T] —
    the shape the plotting functions (``viz.graphs.ekf_graphs``/
    ``ekf_error_graphs``) consume."""
    v = np.asarray(imu_valid).reshape(-1)

    def flat(x):
        x = np.asarray(x)
        return x.reshape((-1,) + x.shape[2:])[v]

    return esekf.FilterLog(*[flat(getattr(flog, f))
                             for f in esekf.FilterLog._fields])


def time_origin(scan_ts, imu_ts) -> float:
    """The f64 time origin :func:`build_batches` subtracts before the f32
    cast. Record it (e.g. in a state checkpoint) and pass it back via
    ``build_batches(..., time_origin=...)`` to continue a run: the carried
    EKF timestamp is relative to this origin, so a resumed segment must
    rebase against the ORIGINAL origin, not its own start."""
    t0 = min(float(scan_ts[0]) if len(scan_ts) else np.inf,
             float(imu_ts[0]) if len(imu_ts) else np.inf)
    return t0 if np.isfinite(t0) else 0.0


_time_origin_fn = time_origin  # un-shadowed alias for build_batches


def build_batches(
    cfg: PipelineConfig,
    range_m: np.ndarray,       # [N, H, W] meters
    scan_ts: np.ndarray,       # [N]
    imu_lacc: np.ndarray,      # [M, 3]
    imu_avel: np.ndarray,      # [M, 3]
    imu_ts: np.ndarray,        # [M]
    guess_poses: np.ndarray | None = None,  # [N, 4, 4] for gt mode
    time_origin: float | None = None,
    prev_scan_ts: float | None = None,
) -> ScanBatch:
    """Host-side batcher: window IMU samples per scan interval.

    Scan i gets the IMU samples with ts in (scan_ts[i-1], scan_ts[i]]
    (first scan: everything up to its timestamp), padded/truncated to
    ``cfg.max_imu_per_scan`` — the reference streams them interleaved
    (``src/ptudes/data.py:49-77``); here they become a dense [N, K] block.

    ``prev_scan_ts`` (absolute, same clock as ``scan_ts``/``imu_ts``)
    seeds the first scan's window lower bound: a run resumed from a
    checkpoint must pass the checkpoint's last scan timestamp here so IMU
    samples already integrated into the carried EKF state are not re-fed
    (re-feeding them would mechanize backwards with negative dt).

    Timestamps are rebased to the sequence start in float64 on host before
    the float32 cast: real captures carry epoch-scale clocks (~1.7e9 s)
    where f32 resolution is ~128 s, which would collapse every IMU dt to 0.
    """
    scan_ts = np.asarray(scan_ts, np.float64)
    imu_ts = np.asarray(imu_ts, np.float64)
    t0 = (_time_origin_fn(scan_ts, imu_ts)
          if time_origin is None else float(time_origin))
    scan_ts = scan_ts - t0
    imu_ts = imu_ts - t0
    n = len(scan_ts)
    k = cfg.max_imu_per_scan
    lacc = np.zeros((n, k, 3), np.float32)
    avel = np.zeros((n, k, 3), np.float32)
    ts = np.zeros((n, k), np.float32)
    valid = np.zeros((n, k), bool)
    prev = -np.inf if prev_scan_ts is None else float(prev_scan_ts) - t0
    dropped = 0
    for i, t1 in enumerate(scan_ts):
        sel = np.where((imu_ts > prev) & (imu_ts <= t1))[0]
        if len(sel) > k:
            dropped += len(sel) - k
            sel = sel[-k:]
        m = len(sel)
        lacc[i, :m] = imu_lacc[sel]
        avel[i, :m] = imu_avel[sel]
        ts[i, :m] = imu_ts[sel]
        valid[i, :m] = True
        prev = t1
    if dropped:
        import warnings
        warnings.warn(
            f"{dropped} IMU samples dropped: more than max_imu_per_scan="
            f"{k} in some scan intervals")
    if guess_poses is None:
        guess_poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    return ScanBatch(
        range_m=jnp.asarray(range_m, jnp.float32),
        scan_ts=jnp.asarray(scan_ts, jnp.float32),
        imu=Imu(lacc=jnp.asarray(lacc), avel=jnp.asarray(avel),
                ts=jnp.asarray(ts)),
        imu_valid=jnp.asarray(valid),
        guess_pose=jnp.asarray(guess_poses, jnp.float32),
    )
