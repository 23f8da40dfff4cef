"""Error-state EKF for IMU odometry, pure-functional in JAX.

JAX re-design of the reference ``ESEKF`` (``src/ptudes/ins/es_ekf.py``):
the 18-dim error state  [dpos, dvel, datt, dbias_gyr, dbias_acc, dgrav]
with block indices POS/VEL/PHI/BG/BA/G = 0,3,6,9,12,15
(``src/ptudes/ins/es_ekf.py:65-71``), IMU mechanization predict, and 6-DoF
pose update with attitude-covariance projection and error reset.

Differences from the reference (all deliberate improvements):
  * pure functions over a NamedTuple state -> works under jit / lax.scan /
    vmap (multi-sequence replay);
  * f32 with optional Joseph-form covariance update + symmetrization
    instead of the reference's f64 + (I-KJ)P, which keeps the filter
    stable in single precision;
  * the error state is folded immediately at update time: the reference's
    ``_nav_err`` is provably always zero at ``processPose`` entry (it is
    reset at the end of every update and never touched in predict), so the
    dead ``dpos``/``datt_v`` residual terms are omitted.

Tuning constants are numerically identical to the reference
(``src/ptudes/ins/es_ekf.py:101-119``, measurement defaults ``:289-292``).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import GRAV
from ..config import EkfConfig
from ..geom import se3, so3
from ..geom.linalg import solve_spd6
from ..ops import backend

STATE_RANK = 18
POS, VEL, PHI, BG, BA, G = 0, 3, 6, 9, 12, 15

# numpy (not jnp) on purpose: creating device arrays at import time would
# initialize jax's default backend before callers can select a platform
# (the multi-chip dryrun flips to a virtual CPU mesh after import).
DOWN = np.asarray([0.0, 0.0, -1.0])
UP = np.asarray([0.0, 0.0, 1.0])


class EkfState(NamedTuple):
    pos: jax.Array        # [3]
    vel: jax.Array        # [3]
    quat: jax.Array       # [4] xyzw attitude (body->world)
    bias_gyr: jax.Array   # [3]
    bias_acc: jax.Array   # [3]
    grav: jax.Array       # [3]
    cov: jax.Array        # [18, 18]
    imu_ts: jax.Array     # last processed IMU timestamp (s)
    initialized: jax.Array  # bool: first IMU only latches the timestamp


class Imu(NamedTuple):
    """One IMU sample (SI units: m/s^2, rad/s, s) — reference
    ``src/ptudes/ins/data.py:12-31``. Stack along a leading axis for
    sequences."""
    lacc: jax.Array
    avel: jax.Array
    ts: jax.Array


def init_cov(cfg: EkfConfig) -> jnp.ndarray:
    """Initial covariance, reproducing the reference's quirk of squaring the
    rotvec of the (10, 10, 10) deg XYZ-Euler for the attitude block
    (``src/ptudes/ins/es_ekf.py:104-107,126-137``)."""
    rpy = jnp.full((3,), jnp.deg2rad(cfg.init_att_rpy_deg))
    att_rotvec = so3.quat_to_rotvec(so3.quat_from_euler_xyz(rpy))
    d = jnp.concatenate([
        jnp.full((3,), cfg.init_pos_std**2),
        jnp.full((3,), cfg.init_vel_std**2),
        att_rotvec**2,
        jnp.full((3,), cfg.init_bg_std**2),
        jnp.full((3,), cfg.init_ba_std**2),
        jnp.full((3,), cfg.init_grav_std**2),
    ])
    return jnp.diag(d).astype(jnp.float32)


def init_state(
    cfg: EkfConfig,
    init_grav: jax.Array | None = None,
    init_bacc: jax.Array | None = None,
    init_bgyr: jax.Array | None = None,
) -> EkfState:
    z3 = jnp.zeros(3, jnp.float32)
    return EkfState(
        pos=z3,
        vel=z3,
        quat=jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32),
        bias_gyr=z3 if init_bgyr is None else jnp.asarray(init_bgyr, jnp.float32),
        bias_acc=z3 if init_bacc is None else jnp.asarray(init_bacc, jnp.float32),
        grav=(GRAV * DOWN).astype(jnp.float32)
        if init_grav is None else jnp.asarray(init_grav, jnp.float32),
        cov=init_cov(cfg),
        imu_ts=jnp.asarray(0.0, jnp.float32),
        initialized=jnp.asarray(False),
    )


def pose_mat(s: EkfState) -> jax.Array:
    """Current nav pose as 4x4 (reference ``NavState.pose_mat``)."""
    return se3.make_pose(so3.quat_to_mat(s.quat), s.pos)


def _set_blk(m: jax.Array, i: int, j: int, b: jax.Array) -> jax.Array:
    return m.at[i:i + 3, j:j + 3].set(b)


@partial(jax.jit, inline=True, static_argnames=("cfg",))
def process_imu(s: EkfState, imu: Imu, *, cfg: EkfConfig) -> EkfState:
    """EKF predict (reference ``processImu`` + ``_insMech``,
    ``src/ptudes/ins/es_ekf.py:191-257``). The first sample only latches the
    timestamp, like the reference's ``_imu_initialized`` gate.

    Samples at or before the carried timestamp are no-ops (dt clamped to 0,
    timestamp kept monotonic): stale/replayed IMU data must not mechanize
    the state backwards or inject negative process noise."""
    dt = jnp.maximum(imu.ts - s.imu_ts, 0.0)
    ts_next = jnp.maximum(imu.ts, s.imu_ts)

    r_prev = so3.quat_to_mat(s.quat)
    acc_body = imu.lacc - s.bias_acc
    avel_body = imu.avel - s.bias_gyr
    dtheta = avel_body * dt
    rot_dtheta = so3.exp_rotvec(dtheta)

    # --- mechanization
    lacc_g = r_prev @ acc_body
    acc_total = lacc_g + s.grav
    pos = s.pos + s.vel * dt + 0.5 * acc_total * dt * dt
    vel = s.vel + acc_total * dt
    quat = so3.quat_mul(s.quat, so3.mat_to_quat(rot_dtheta))

    # --- error-state transition (Fx), blocks per reference :216-223
    eye3 = jnp.eye(3, dtype=jnp.float32)
    fx = jnp.eye(STATE_RANK, dtype=jnp.float32)
    fx = _set_blk(fx, POS, VEL, dt * eye3)
    fx = _set_blk(fx, VEL, PHI, -dt * (r_prev @ so3.hat(acc_body)))
    fx = _set_blk(fx, VEL, BA, -dt * r_prev)
    # gravity-error block intentionally disabled, as in the reference :219-221
    fx = _set_blk(fx, PHI, PHI, rot_dtheta.T)
    fx = _set_blk(fx, PHI, BG, -dt * eye3)

    # --- process noise (reference :226-233)
    w = jnp.zeros((STATE_RANK, STATE_RANK), jnp.float32)
    w = _set_blk(w, VEL, VEL, (dt * cfg.acc_bias_std) ** 2 * eye3)
    w = _set_blk(w, PHI, PHI, (dt * cfg.gyr_bias_std) ** 2 * eye3)
    w = _set_blk(w, BA, BA, dt * cfg.acc_vrw**2 * eye3)
    w = _set_blk(w, BG, BG, dt * cfg.gyr_arw**2 * eye3)

    cov = fx @ s.cov @ fx.T + w
    cov = 0.5 * (cov + cov.T)  # keep symmetric in f32

    new = EkfState(
        pos=pos, vel=vel, quat=quat,
        bias_gyr=s.bias_gyr, bias_acc=s.bias_acc, grav=s.grav,
        cov=cov, imu_ts=ts_next, initialized=jnp.asarray(True),
    )
    # first IMU (or invalid) only latches ts
    latch = s._replace(imu_ts=imu.ts, initialized=jnp.asarray(True))
    return jax.tree.map(
        lambda a, b: jnp.where(s.initialized, a, b), new, latch
    )


def default_meas_cov(cfg: EkfConfig) -> jnp.ndarray:
    """blkdiag(pos 0.02^2, att 0.01^2) — reference ``:289-292``."""
    return jnp.diag(
        jnp.concatenate([
            jnp.full((3,), cfg.meas_pos_std**2),
            jnp.full((3,), cfg.meas_att_std**2),
        ])
    ).astype(jnp.float32)


@partial(jax.jit, inline=True, static_argnames=("cfg",))
def process_pose(
    s: EkfState,
    pose_meas: jax.Array,              # [4, 4]
    *,
    cfg: EkfConfig,
    meas_cov: jax.Array | None = None,
) -> EkfState:
    """EKF update from a 6-DoF pose measurement (reference ``processPose``,
    ``src/ptudes/ins/es_ekf.py:259-327``)."""
    if meas_cov is None:
        meas_cov = default_meas_cov(cfg)

    r_k = so3.quat_to_mat(s.quat)

    # residual: translation + log(Rk^-1 R_meas); the reference's dR/_nav_err
    # terms are identically zero at this point (see module docstring)
    resid = jnp.concatenate([
        se3.trans(pose_meas) - s.pos,
        so3.log_rotmat(r_k.T @ se3.rot(pose_meas)),
    ])

    jp = jnp.zeros((6, STATE_RANK), jnp.float32)
    jp = jp.at[0:3, POS:POS + 3].set(jnp.eye(3))
    jp = jp.at[3:6, PHI:PHI + 3].set(jnp.eye(3))

    p = s.cov
    smat = jp @ p @ jp.T + meas_cov
    # K = P J^T S^-1 via an unrolled SPD solve (S is 6x6 SPD);
    # jnp.linalg.inv lowers to an LU custom call with real latency
    k = solve_spd6(smat, (p @ jp.T).T).T
    dx = k @ resid

    ikj = jnp.eye(STATE_RANK, dtype=jnp.float32) - k @ jp
    if cfg.joseph_form:
        cov = ikj @ p @ ikj.T + k @ meas_cov @ k.T
    else:
        cov = ikj @ p
    cov = 0.5 * (cov + cov.T)

    dpos, dvel, dphi = dx[POS:POS + 3], dx[VEL:VEL + 3], dx[PHI:PHI + 3]
    dbg, dba, dgrav = dx[BG:BG + 3], dx[BA:BA + 3], dx[G:G + 3]

    # inject error into nominal state (reference :313-319)
    quat = so3.quat_mul(s.quat, so3.rotvec_to_quat(dphi))

    # attitude covariance projection G_theta P_phi G_theta^T (reference :322-324)
    g_theta = jnp.eye(3) - so3.hat(0.5 * dphi)
    phi_blk = cov[PHI:PHI + 3, PHI:PHI + 3]
    cov = cov.at[PHI:PHI + 3, PHI:PHI + 3].set(g_theta @ phi_blk @ g_theta.T)

    return EkfState(
        pos=s.pos + dpos,
        vel=s.vel + dvel,
        quat=quat,
        bias_gyr=s.bias_gyr + dbg,
        bias_acc=s.bias_acc + dba,
        grav=s.grav + dgrav,
        cov=cov,
        imu_ts=s.imu_ts,
        initialized=s.initialized,
    )


def masked_update(old: EkfState, new: EkfState, apply: jax.Array) -> EkfState:
    """Select ``new`` where ``apply`` else ``old`` (pytree where) — the tool
    for padded IMU blocks and conditional pose corrections under lax.scan."""
    return jax.tree.map(lambda a, b: jnp.where(apply, b, a), old, new)


class FilterLog(NamedTuple):
    """Per-IMU-step filter history (the reference's ``_logging=True``
    recordings, ``src/ptudes/ins/es_ekf.py:171-179,331-365``) as stacked
    arrays instead of python lists."""
    ts: jax.Array         # [T]
    pos: jax.Array        # [T, 3]
    vel: jax.Array        # [T, 3]
    att_q: jax.Array      # [T, 4]
    bias_gyr: jax.Array   # [T, 3]
    bias_acc: jax.Array   # [T, 3]
    grav: jax.Array       # [T, 3]
    cov_diag: jax.Array   # [T, 18]
    updated: jax.Array    # [T] bool — pose correction applied at this step


@partial(jax.jit, inline=True, static_argnames=("cfg",))
def run_filter(
    s: EkfState,
    imus: Imu,             # stacked [T]
    corr_mask: jax.Array,  # [T] bool — apply pose correction after step t
    corr_poses: jax.Array,  # [T, 4, 4]
    *,
    cfg: EkfConfig,
    meas_cov: jax.Array | None = None,
) -> tuple[EkfState, FilterLog]:
    """IMU-rate filter run under lax.scan with optional pose corrections —
    the engine behind `ekf-bench sim` and `ekf-bench nc`
    (reference ``src/ptudes/cli/ekf_bench.py:135-149,271-297``)."""

    def step(state, inp):
        imu, do_corr, pose = inp
        state = process_imu(state, imu, cfg=cfg)
        corrected = process_pose(state, pose, cfg=cfg, meas_cov=meas_cov)
        state = masked_update(state, corrected, do_corr)
        log = FilterLog(
            ts=imu.ts, pos=state.pos, vel=state.vel, att_q=state.quat,
            bias_gyr=state.bias_gyr, bias_acc=state.bias_acc,
            grav=state.grav, cov_diag=jnp.diag(state.cov),
            updated=do_corr,
        )
        return state, log

    return jax.lax.scan(step, s, (imus, corr_mask, corr_poses))


@partial(jax.jit, inline=True, static_argnames=("cfg",))
def _process_imu_batch_assoc(
    s: EkfState, imus: Imu, valid: jax.Array, *, cfg: EkfConfig,
) -> EkfState:
    """Batched-covariance predict block.

    Same math as K sequential :func:`process_imu` calls, restructured for
    a short op chain: the nav mechanization (a genuinely serial, tiny
    scalar chain) stays an unrolled scan, but the K serialized 18x18
    covariance updates ``P <- Fx P Fx^T + W`` become

        P' = G_1 P G_1^T + sum_k G_{k+1} W_k G_{k+1}^T,
        G_k = F_K @ ... @ F_k  (suffix products, log-depth assoc. scan)

    i.e. 4 levels of batched [K,18,18] matmuls + one compound update.
    Differences vs the unrolled chain are pure f32 reassociation (~1e-3
    absolute on cov entries of magnitude ~100; the unrolled chain also
    symmetrizes every step, this form once at the end) — far below the
    process-noise floor of a single IMU interval.

    Invalid (padded) samples get dt = 0, hence F = I and W = 0 — exact
    no-ops in the product — and the first valid sample of an uninitialized
    filter only latches the timestamp, like :func:`process_imu`.
    """
    eye3 = jnp.eye(3, dtype=jnp.float32)

    def nav_step(carry, inp):
        pos, vel, quat, ts, init = carry
        lacc, avel, t, ok = inp
        eff = ok & init
        dt = jnp.where(eff, jnp.maximum(t - ts, 0.0), 0.0)
        r_prev = so3.quat_to_mat(quat)
        acc_body = lacc - s.bias_acc
        avel_body = avel - s.bias_gyr
        rot_dtheta = so3.exp_rotvec(avel_body * dt)
        acc_total = r_prev @ acc_body + s.grav
        pos = pos + vel * dt + 0.5 * acc_total * dt * dt
        vel = vel + acc_total * dt
        quat = jnp.where(
            eff, so3.quat_mul(quat, so3.mat_to_quat(rot_dtheta)), quat)
        # first valid sample of an uninitialized filter latches ts directly
        # (process_imu's latch branch assigns imu_ts = imu.ts, no max) —
        # keeps the two forms identical for ts below the 0.0 init value
        ts = jnp.where(
            ok, jnp.where(init, jnp.maximum(t, ts), t), ts)
        init = init | ok
        return ((pos, vel, quat, ts, init),
                (r_prev, acc_body, rot_dtheta, dt))

    carry0 = (s.pos, s.vel, s.quat, s.imu_ts, s.initialized)
    (pos, vel, quat, ts, init), (r_prev, acc_body, rot_d, dt) = jax.lax.scan(
        nav_step, carry0, (imus.lacc, imus.avel, imus.ts, valid),
        unroll=True)

    def build_fw(r_prev, acc_body, rot_dtheta, dt):
        # identical blocks to process_imu (reference es_ekf.py:216-233);
        # dt = 0 (masked samples) gives exactly F = I, W = 0
        fx = jnp.eye(STATE_RANK, dtype=jnp.float32)
        fx = _set_blk(fx, POS, VEL, dt * eye3)
        fx = _set_blk(fx, VEL, PHI, -dt * (r_prev @ so3.hat(acc_body)))
        fx = _set_blk(fx, VEL, BA, -dt * r_prev)
        fx = _set_blk(fx, PHI, PHI, rot_dtheta.T)
        fx = _set_blk(fx, PHI, BG, -dt * eye3)
        wdiag = jnp.zeros((STATE_RANK,), jnp.float32)
        wdiag = wdiag.at[VEL:VEL + 3].set((dt * cfg.acc_bias_std) ** 2)
        wdiag = wdiag.at[PHI:PHI + 3].set((dt * cfg.gyr_bias_std) ** 2)
        wdiag = wdiag.at[BA:BA + 3].set(dt * cfg.acc_vrw**2)
        wdiag = wdiag.at[BG:BG + 3].set(dt * cfg.gyr_arw**2)
        return fx, wdiag

    fx, wdiag = jax.vmap(build_fw)(r_prev, acc_body, rot_d, dt)

    # suffix products G_k = F_K ... F_k. NOTE argument order: under
    # reverse=True, associative_scan feeds combine(earlier, later) such
    # that a @ b yields the descending product (verified against a direct
    # fold — b @ a silently gives the ascending one, a ~1e-2 cov error)
    gs = jax.lax.associative_scan(
        lambda a, b: jnp.matmul(a, b), fx, reverse=True)
    g1 = gs[0]
    gnext = jnp.concatenate(
        [gs[1:], jnp.eye(STATE_RANK, dtype=jnp.float32)[None]], axis=0)
    cov = g1 @ s.cov @ g1.T + jnp.einsum(
        "kij,kj,klj->il", gnext, wdiag, gnext)
    cov = 0.5 * (cov + cov.T)

    return EkfState(
        pos=pos, vel=vel, quat=quat,
        bias_gyr=s.bias_gyr, bias_acc=s.bias_acc, grav=s.grav,
        cov=cov, imu_ts=ts, initialized=init,
    )


@partial(jax.jit, inline=True,
         static_argnames=("cfg", "log", "want_twist"))
def process_imu_batch(
    s: EkfState, imus: Imu, valid: jax.Array, *, cfg: EkfConfig,
    log: bool = False, want_twist: bool = False,
):
    """Run a padded block of IMU samples through predict under lax.scan
    (the per-scan inner loop of the fused pipeline, SURVEY.md section 7.6).

    ``cfg.predict_batch`` selects the structure ("auto": ``ops.backend``
    picks from the platform): "assoc" runs the covariance chain as a
    log-depth associative scan (see :func:`_process_imu_batch_assoc`, f32
    reassociation differences only), "unroll" is the step-by-step chain
    bit-matching K sequential :func:`process_imu` calls, "triton" the
    one-launch kernel (``ops.pallas_ekf.predict_block``).

    With ``log=True`` returns ``(state, FilterLog)`` with one entry per
    (padded) IMU slot — the fused pipeline's IMU-rate history (the
    reference's ``_logging=True`` recordings for the flagship ouster mode,
    ``src/ptudes/ins/es_ekf.py:171-179``). Logging is side-effect-free,
    exactly like the reference (``es_ekf.py:171-179``): the CARRIED state
    is always the one ``log=False`` would return — under "assoc"/"triton"
    the log path runs the unrolled chain only to emit the per-step
    history and carries the assoc/kernel-form state forward, so
    observability never perturbs the trajectory (the per-step
    ``cov_diag`` entries are the unrolled chain's, which differ from the
    carried covariance by f32 reassociation only)."""
    form = backend.resolve("ekf_predict", cfg.predict_batch)
    if form not in ("assoc", "unroll", "triton"):
        raise ValueError(
            f"EkfConfig.predict_batch must be 'auto', 'assoc', 'unroll' "
            f"or 'triton', got {cfg.predict_batch!r}")

    def _twist(st):
        # log(T_in^-1 @ T_out) — the EKF deskew twist (the kernel
        # computes it in its epilogue)
        return se3.log_pose(se3.inv(pose_mat(s)) @ pose_mat(st))

    def fast_form():
        if form == "triton":
            from ..ops.pallas_ekf import predict_block
            return predict_block(s, imus, valid, cfg=cfg,
                                 want_twist=want_twist)
        st = _process_imu_batch_assoc(s, imus, valid, cfg=cfg)
        return (st, _twist(st)) if want_twist else st

    use_fast = form in ("assoc", "triton")
    if not log and use_fast:
        return fast_form()
    assert not (want_twist and log), \
        "want_twist applies to the log=False paths"

    def step(state, inp):
        imu, ok = inp
        nxt = process_imu(state, imu, cfg=cfg)
        state = masked_update(state, nxt, ok)
        if not log:
            return state, None
        fl = FilterLog(
            ts=imu.ts, pos=state.pos, vel=state.vel, att_q=state.quat,
            bias_gyr=state.bias_gyr, bias_acc=state.bias_acc,
            grav=state.grav, cov_diag=jnp.diag(state.cov),
            updated=jnp.asarray(False),
        )
        return state, fl

    # fully unrolled: K is small (<=16) and each step is tiny 18x18 math —
    # unrolling lets XLA fuse across steps instead of paying per-iteration
    # loop overhead on sub-microsecond bodies
    out, flog = jax.lax.scan(step, s, (imus, valid), unroll=True)
    if log and use_fast:
        # carry the fast-form state so log=True and log=False runs are
        # bit-identical; the unrolled chain above only feeds the history
        out = fast_form()
    if log:
        return out, flog
    return (out, _twist(out)) if want_twist else out
