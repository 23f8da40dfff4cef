"""Pallas kernel (Triton route): the per-scan EKF predict block in ONE
launch.

``esekf.process_imu_batch`` runs K IMU mechanization + covariance steps
per scan: about 60 small XLA ops in the associative-scan form and about
300 unrolled. On the GPU each op is a launch far longer than its few
thousand FMAs. :func:`predict_block` does the whole block in one
program:

* the nav chain (pos/vel/attitude mechanization — a genuinely serial,
  tiny scalar recurrence) runs in scalars, with the attitude in
  rotation-matrix form composed via the same Rodrigues scalars as
  ``ops.pallas_icp``;
* the covariance chain ``P <- F P F^T + W`` runs on the 18x18 covariance
  padded to a 32x32 register tile, two IEEE-f32 products per step —
  the UNROLLED chain's structure (per-step symmetrization included).

Semantics: identical math to the XLA forms (reference
``src/ptudes/ins/es_ekf.py:191-257``); differences are f32 rounding only
(matrix-form attitude composition, summation order), pinned by
tolerance parity tests. (A one-launch pose update was tried too and did
not beat XLA's form end to end: PERF.md, PR 1.)

Products use ``pl.dot(..., allow_tf32=False)``: the global
``jax_default_matmul_precision`` does not reach inside a Triton kernel,
and TF32 keeps ~3 decimal digits — far too few for a covariance chain.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .pallas_icp import _log_pose_scalars, _rodrigues_scalars

STATE = 18
POS, VEL, PHI, BG, BA = 0, 3, 6, 9, 12
TILE = 32   # covariance tile: 18x18 padded to a power of two

# predict scal input [32]: state scalars
_I_POS, _I_VEL, _I_R = 0, 3, 6           # pos[3] vel[3] R[9] (row-major)
_I_BG, _I_BA, _I_G = 15, 18, 21          # biases + gravity
_I_TS, _I_INIT = 24, 25                  # carried ts, initialized flag
# imu input [K, 8]: [lacc3 | avel3 | ts | valid]
# predict scal output [32]: pos[3] vel[3] R[9] ts init twist[6]
_O_POS, _O_VEL, _O_R, _O_TS, _O_INIT = 0, 3, 6, 15, 16
_O_TWIST = 17   # log(T_in^-1 @ T_out) — the EKF deskew twist

_PARAMS = pltr.CompilerParams(num_warps=4, num_stages=1)


def _rot_scalars(wx, wy, wz):
    return _rodrigues_scalars(wx, wy, wz)[0]


def _matmul3_scalars(a, b):
    return tuple(
        a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
        for i in range(3) for j in range(3))


def _iota2():
    ir = jax.lax.broadcasted_iota(jnp.int32, (TILE, TILE), 0)
    ic = jax.lax.broadcasted_iota(jnp.int32, (TILE, TILE), 1)
    return ir, ic


def _dot(a, b, trans_b=False):
    return pl.dot(a, b, trans_b=trans_b, allow_tf32=False)


def _make_predict_kernel(k_steps: int, acc_bias_std: float,
                         gyr_bias_std: float, acc_vrw: float,
                         gyr_arw: float):
    def kernel(scal_ref, imu_ref, cov_ref, out_ref, cov_out_ref):
        pos = [scal_ref[_I_POS + i] for i in range(3)]
        vel = [scal_ref[_I_VEL + i] for i in range(3)]
        r = [scal_ref[_I_R + i] for i in range(9)]
        bg = [scal_ref[_I_BG + i] for i in range(3)]
        ba = [scal_ref[_I_BA + i] for i in range(3)]
        grav = [scal_ref[_I_G + i] for i in range(3)]
        ts = scal_ref[_I_TS]
        init = scal_ref[_I_INIT]              # 0.0 / 1.0
        r0, p0 = list(r), list(pos)           # entry pose for the twist

        p = cov_ref[...]                      # [TILE, TILE]
        ir, ic = _iota2()
        eye = jnp.where(ir == ic, 1.0, 0.0)
        in_blk = [(ir >= b) & (ir < b + 3) for b in (VEL, PHI, BG, BA)]

        for k in range(k_steps):
            lacc = [imu_ref[k, i] for i in range(3)]
            avel = [imu_ref[k, 3 + i] for i in range(3)]
            t_k = imu_ref[k, 6]
            ok = imu_ref[k, 7]                # 0.0 / 1.0
            eff = ok * init
            dt = jnp.maximum(t_k - ts, 0.0) * eff

            acc_body = [lacc[i] - ba[i] for i in range(3)]
            rd = _rot_scalars(*[(avel[i] - bg[i]) * dt for i in range(3)])

            # mechanization (matches process_imu: masked samples dt=0
            # leave pos/vel unchanged; attitude gated explicitly)
            acc_tot = [r[3 * i] * acc_body[0] + r[3 * i + 1] * acc_body[1]
                       + r[3 * i + 2] * acc_body[2] + grav[i]
                       for i in range(3)]
            new_pos = [pos[i] + vel[i] * dt + 0.5 * acc_tot[i] * dt * dt
                       for i in range(3)]
            new_vel = [vel[i] + acc_tot[i] * dt for i in range(3)]
            r_next = _matmul3_scalars(r, rd)
            r_new = [jnp.where(eff > 0, r_next[i], r[i]) for i in range(9)]

            # covariance: F P F^T + W; dt = 0 gives exactly F = I, W = 0
            h = (0.0, -acc_body[2], acc_body[1],
                 acc_body[2], 0.0, -acc_body[0],
                 -acc_body[1], acc_body[0], 0.0)
            rh = _matmul3_scalars(r, h)
            fx = eye
            for i in range(3):
                fx = jnp.where((ir == POS + i) & (ic == VEL + i), dt, fx)
                fx = jnp.where((ir == PHI + i) & (ic == BG + i), -dt, fx)
                for j in range(3):
                    fx = jnp.where((ir == VEL + i) & (ic == PHI + j),
                                   -dt * rh[3 * i + j], fx)
                    fx = jnp.where((ir == VEL + i) & (ic == BA + j),
                                   -dt * r[3 * i + j], fx)
                    # PHI x PHI block: rot_dtheta^T
                    fx = jnp.where((ir == PHI + i) & (ic == PHI + j),
                                   rd[3 * j + i], fx)
            wdiag = jnp.where(
                ir == ic,
                jnp.where(in_blk[0], (dt * acc_bias_std) ** 2, 0.0)
                + jnp.where(in_blk[1], (dt * gyr_bias_std) ** 2, 0.0)
                + jnp.where(in_blk[2], dt * gyr_arw ** 2, 0.0)
                + jnp.where(in_blk[3], dt * acc_vrw ** 2, 0.0),
                0.0)
            p_new = _dot(_dot(fx, p), fx, trans_b=True) + wdiag
            p = 0.5 * (p_new + p_new.T)

            pos, vel, r = new_pos, new_vel, r_new
            # first valid sample of an uninitialized filter latches ts
            # directly (esekf.process_imu latch branch)
            ts = jnp.where(
                ok > 0, jnp.where(init > 0, jnp.maximum(t_k, ts), t_k), ts)
            init = jnp.maximum(init, ok)

        for i in range(3):
            out_ref[_O_POS + i] = pos[i]
            out_ref[_O_VEL + i] = vel[i]
        for i in range(9):
            out_ref[_O_R + i] = r[i]
        out_ref[_O_TS] = ts
        out_ref[_O_INIT] = init
        cov_out_ref[...] = p

        # deskew twist log(T_in^-1 @ T_out) — the EKF-integrated sweep
        # motion the LIO pipeline feeds to deskew_by_twist
        r0t = (r0[0], r0[3], r0[6], r0[1], r0[4], r0[7],
               r0[2], r0[5], r0[8])
        rel_r = _matmul3_scalars(r0t, r)
        dp = [pos[i] - p0[i] for i in range(3)]
        rel_t = tuple(r0t[3 * i] * dp[0] + r0t[3 * i + 1] * dp[1]
                      + r0t[3 * i + 2] * dp[2] for i in range(3))
        tw = _log_pose_scalars(rel_r, rel_t)
        for i in range(6):
            out_ref[_O_TWIST + i] = tw[i]

    return kernel


def _pad_cov(cov):
    return jnp.pad(cov.astype(jnp.float32),
                   ((0, TILE - STATE), (0, TILE - STATE)))


@partial(jax.jit, inline=True,
         static_argnames=("cfg", "interpret", "want_twist"))
def predict_block(s, imus, valid, *, cfg, interpret: bool = False,
                  want_twist: bool = False):
    """One-launch EKF predict over a padded IMU block.

    Same in/out contract as ``esekf._process_imu_batch_assoc``: takes an
    ``EkfState`` + stacked ``Imu[K]`` + valid mask, returns the advanced
    ``EkfState``. The biases and gravity are predict-invariant
    (reference es_ekf.py:191-257) and pass through.

    ``want_twist=True`` additionally returns ``log(T_in^-1 @ T_out)``
    (the EKF deskew twist, computed in the kernel epilogue).
    """
    from ..geom import so3
    from ..models.esekf import EkfState

    k = valid.shape[0]
    scal = jnp.concatenate([
        s.pos, s.vel, so3.quat_to_mat(s.quat).reshape(9),
        s.bias_gyr, s.bias_acc, s.grav,
        jnp.stack([s.imu_ts, s.initialized.astype(jnp.float32)]),
        jnp.zeros((6,))]).astype(jnp.float32)
    imu_rows = jnp.concatenate([
        imus.lacc.astype(jnp.float32),
        imus.avel.astype(jnp.float32),
        imus.ts.astype(jnp.float32)[:, None],
        valid.astype(jnp.float32)[:, None],
    ], axis=1)                                        # [K, 8]

    kern = _make_predict_kernel(k, cfg.acc_bias_std, cfg.gyr_bias_std,
                                cfg.acc_vrw, cfg.gyr_arw)
    out, cov = pl.pallas_call(
        kern,
        out_shape=(jax.ShapeDtypeStruct((32,), jnp.float32),
                   jax.ShapeDtypeStruct((TILE, TILE), jnp.float32)),
        backend="triton", compiler_params=_PARAMS, interpret=interpret,
        name="ekf_predict",
    )(scal, imu_rows, _pad_cov(s.cov))

    st = EkfState(
        pos=out[_O_POS:_O_POS + 3],
        vel=out[_O_VEL:_O_VEL + 3],
        quat=so3.mat_to_quat(out[_O_R:_O_R + 9].reshape(3, 3)),
        bias_gyr=s.bias_gyr, bias_acc=s.bias_acc, grav=s.grav,
        cov=cov[:STATE, :STATE],
        imu_ts=out[_O_TS],
        initialized=out[_O_INIT] > 0,
    )
    if want_twist:
        return st, out[_O_TWIST:_O_TWIST + 6]
    return st
