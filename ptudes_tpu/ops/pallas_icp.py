"""Pallas kernel (Triton route): the whole robust GN ICP loop in one launch.

``ops.icp.register_frame_cached`` with frozen candidates runs the GN
iteration as an XLA ``while_loop``. On XLA:GPU its predicate goes back to
the host on every trip, and its body is several small kernels (distance
+ select, moment reductions, the 6x6 solve and the SE(3) update). This
kernel runs the whole loop in ONE program: each trip streams the frozen
candidate tensors from L2 in chunks of ``chunk`` points, keeps the 45
moment sums as per-lane vector accumulators (one block reduction each
per trip, not per chunk), then solves the 6x6 system and applies the
SE(3) update in scalars, and exits when the step converges.

Semantics match the XLA loop (``gn_backend="xla"``) — frozen
candidates, convergence-masked early exit, robust point/plane dual loss,
optional motion prior — with one documented deviation: the in-kernel
``log`` of the prior's relative pose uses the direct axis-angle formula
(stable for |rot| well below pi) instead of the quaternion path. ICP
refinement poses stay within a few degrees of the guess.

Reference behavior being replaced: the per-iteration C++ hot call
``kiss_icp::registration::register_frame`` (reference
``src/ptudes/kiss.py:108-114``).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

_EPS = 1e-8    # small-angle switch, matches geom.so3._EPS
_BIG = 1e30    # distance offset of an invalid candidate

# scal layout [32]
_S_KERN, _S_MAXD2, _S_PLQ, _S_CONV2 = 0, 1, 2, 3
_S_PRW, _S_PTW = 4, 5
_S_POSE = 8       # 8..19: guess, row-major [r00 r01 r02 t0; ...]
_S_POSE_INV = 20  # 20..31: inverse guess, same layout

# out layout [16]: 0..11 pose, 12 n_corr, 13 iters,
# 14 |trans(guess^-1 pose)|, 15 |log rot(guess^-1 pose)| (the model
# deviation the adaptive threshold consumes)
_O_POSE, _O_NCORR, _O_ITERS, _O_DEVT, _O_DEVR = 0, 12, 13, 14, 15

# per-point rows of the ``rows`` input
_R_SRC, _R_NRM, _R_CEN, _R_QUAL, _R_MASK = 0, 3, 6, 9, 10
_N_ROWS = 16

_POSE_KEYS = (0, 1, 2, 4, 5, 6, 8, 9, 10, 3, 7, 11)  # R row-major, then t

# launch shape: one program of NUM_WARPS warps; a [chunk, C] candidate
# tile holds TILE_ELEMS floats per operand
NUM_WARPS, NUM_STAGES, TILE_ELEMS = 4, 1, 2048


def _solve_spd6_scalars(a, b):
    """Unrolled scalar Cholesky solve on 6x6 python lists of traced
    scalars (same algorithm as geom.linalg.solve_spd6)."""
    n = 6
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i][j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = jnp.sqrt(jnp.maximum(s, 1e-12))
            else:
                l[i][j] = s / l[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return x


def _rodrigues_scalars(wx, wy, wz):
    """exp(rotvec) as 9 scalars (row-major), Rodrigues with the same
    small-angle series as geom.so3.exp_rotvec."""
    t2 = wx * wx + wy * wy + wz * wz
    theta = jnp.sqrt(t2)
    small = theta < _EPS
    safe_t2 = jnp.where(small, 1.0, t2)
    a = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(theta) / jnp.sqrt(safe_t2))
    b = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(theta)) / safe_t2)
    # R = I + a K + b K^2, K = hat(w)
    xx, yy, zz = wx * wx, wy * wy, wz * wz
    xy, xz, yz = wx * wy, wx * wz, wy * wz
    r00 = 1.0 + b * (-yy - zz)
    r11 = 1.0 + b * (-xx - zz)
    r22 = 1.0 + b * (-xx - yy)
    r01 = -a * wz + b * xy
    r10 = a * wz + b * xy
    r02 = a * wy + b * xz
    r20 = -a * wy + b * xz
    r12 = -a * wx + b * yz
    r21 = a * wx + b * yz
    return (r00, r01, r02, r10, r11, r12, r20, r21, r22), (theta, t2, a, b)


def _exp_twist_scalars(dx):
    """se(3) exp of a 6-twist [rot, trans] -> 3x4 scalars (R, t), same
    series as geom.se3.exp_twist."""
    wx, wy, wz = dx[0], dx[1], dx[2]
    vx, vy, vz = dx[3], dx[4], dx[5]
    rr, (theta, t2, _a, b) = _rodrigues_scalars(wx, wy, wz)
    small = theta < _EPS
    safe_t2 = jnp.where(small, 1.0, t2)
    c = jnp.where(
        small,
        1.0 / 6.0 - t2 / 120.0,
        (theta - jnp.sin(theta)) / (safe_t2 * jnp.sqrt(safe_t2)),
    )
    # V = I + b K + c K^2
    xx, yy, zz = wx * wx, wy * wy, wz * wz
    xy, xz, yz = wx * wy, wx * wz, wy * wz
    v00 = 1.0 + c * (-yy - zz)
    v11 = 1.0 + c * (-xx - zz)
    v22 = 1.0 + c * (-xx - yy)
    v01 = -b * wz + c * xy
    v10 = b * wz + c * xy
    v02 = b * wy + c * xz
    v20 = -b * wy + c * xz
    v12 = -b * wx + c * yz
    v21 = b * wx + c * yz
    tx = v00 * vx + v01 * vy + v02 * vz
    ty = v10 * vx + v11 * vy + v12 * vz
    tz = v20 * vx + v21 * vy + v22 * vz
    return rr, (tx, ty, tz)


def _compose_scalars(ra, ta, rb, tb):
    """(Ra, ta) o (Rb, tb): R = Ra Rb, t = Ra tb + ta (12-scalar pose)."""
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = ra
    b00, b01, b02, b10, b11, b12, b20, b21, b22 = rb
    r = (
        a00 * b00 + a01 * b10 + a02 * b20,
        a00 * b01 + a01 * b11 + a02 * b21,
        a00 * b02 + a01 * b12 + a02 * b22,
        a10 * b00 + a11 * b10 + a12 * b20,
        a10 * b01 + a11 * b11 + a12 * b21,
        a10 * b02 + a11 * b12 + a12 * b22,
        a20 * b00 + a21 * b10 + a22 * b20,
        a20 * b01 + a21 * b11 + a22 * b21,
        a20 * b02 + a21 * b12 + a22 * b22,
    )
    t = (
        a00 * tb[0] + a01 * tb[1] + a02 * tb[2] + ta[0],
        a10 * tb[0] + a11 * tb[1] + a12 * tb[2] + ta[1],
        a20 * tb[0] + a21 * tb[1] + a22 * tb[2] + ta[2],
    )
    return r, t


def _log_pose_scalars(r, t):
    """SE(3) log as 6 scalars. Direct axis-angle formula (NOT the
    quaternion path geom.so3.log_rotmat uses): stable for |rot| << pi.
    The rotation vector's magnitude comes from vee(R - R^T), so the
    f32 coarseness of arccos near 1 only touches the O(theta^2)
    factor."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = r
    tr = r00 + r11 + r22
    theta = jnp.arccos(jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0))
    t2 = theta * theta
    small = theta < 1e-4
    sin_t = jnp.sin(theta)
    # w = theta / (2 sin theta) * vee(R - R^T)
    fac = jnp.where(small, 0.5 + t2 / 12.0,
                    theta / jnp.maximum(2.0 * sin_t, _EPS))
    wx = fac * (r21 - r12)
    wy = fac * (r02 - r20)
    wz = fac * (r10 - r01)
    # V^{-1} = I - K/2 + cot_term K^2 (same series as geom.se3.log_pose)
    safe_t2 = jnp.where(small, 1.0, t2)
    half = 0.5 * theta
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), _EPS))
        / safe_t2,
    )
    xx, yy, zz = wx * wx, wy * wy, wz * wz
    xy, xz, yz = wx * wy, wx * wz, wy * wz
    i00 = 1.0 + cot_term * (-yy - zz)
    i11 = 1.0 + cot_term * (-xx - zz)
    i22 = 1.0 + cot_term * (-xx - yy)
    i01 = 0.5 * wz + cot_term * xy
    i10 = -0.5 * wz + cot_term * xy
    i02 = -0.5 * wy + cot_term * xz
    i20 = 0.5 * wy + cot_term * xz
    i12 = 0.5 * wx + cot_term * yz
    i21 = -0.5 * wx + cot_term * yz
    vx = i00 * t[0] + i01 * t[1] + i02 * t[2]
    vy = i10 * t[0] + i11 * t[1] + i12 * t[2]
    vz = i20 * t[0] + i21 * t[1] + i22 * t[2]
    return (wx, wy, wz, vx, vy, vz)


def _chunk_moments(pose, rows_ref, cx_ref, cy_ref, cz_ref, inf_ref, off,
                   chunk, kern, max_d2, plane_q):
    """The 45 per-point moment terms of one chunk of points at ``pose``,
    as [chunk] vectors (row layout of the normal-equation assembly in
    :func:`_make_loop_kernel`)."""
    r, t = pose[:9], pose[9:]
    sl = pl.ds(off, chunk)

    def row(i):
        return rows_ref[i, sl]

    sx, sy, sz = row(_R_SRC), row(_R_SRC + 1), row(_R_SRC + 2)
    nx, ny, nz = row(_R_NRM), row(_R_NRM + 1), row(_R_NRM + 2)
    ccx, ccy, ccz = row(_R_CEN), row(_R_CEN + 1), row(_R_CEN + 2)
    quality, mask = row(_R_QUAL), row(_R_MASK)

    px = r[0] * sx + r[1] * sy + r[2] * sz + t[0]
    py = r[3] * sx + r[4] * sy + r[5] * sz + t[1]
    pz = r[6] * sx + r[7] * sy + r[8] * sz + t[2]

    cx = cx_ref[sl, :]                                  # [chunk, C]
    cy = cy_ref[sl, :]
    cz = cz_ref[sl, :]
    d2 = ((cx - px[:, None]) ** 2 + (cy - py[:, None]) ** 2
          + (cz - pz[:, None]) ** 2 + inf_ref[sl, :])
    d2min = jnp.min(d2, axis=1)
    # first-occurrence one-hot of the minimum (hashmap._argmin_select)
    col = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
    kmin = jnp.min(jnp.where(d2 == d2min[:, None], col, 1 << 30), axis=1)
    oneh = col == kmin[:, None]
    qx = jnp.sum(jnp.where(oneh, cx, 0.0), axis=1)
    qy = jnp.sum(jnp.where(oneh, cy, 0.0), axis=1)
    qz = jnp.sum(jnp.where(oneh, cz, 0.0), axis=1)

    found = d2min < 0.5 * _BIG
    corr = (mask > 0.0) & found & (d2min <= max_d2)

    s = nx * (px - ccx) + ny * (py - ccy) + nz * (pz - ccz)
    use_pl = corr & (quality >= plane_q)
    w_pl = jnp.where(use_pl, (kern * kern) / ((kern + s * s) ** 2), 0.0)
    ax = py * nz - pz * ny                              # a = p x n
    ay = pz * nx - px * nz
    az = px * ny - py * nx

    use_pt = corr & jnp.logical_not(use_pl)
    w_pt = jnp.where(use_pt, (kern * kern) / ((kern + d2min) ** 2), 0.0)
    rx, ry, rz = px - qx, py - qy, pz - qz

    terms = [
        w_pt,
        w_pt * px, w_pt * py, w_pt * pz,
        w_pt * px * px, w_pt * py * py, w_pt * pz * pz,
        w_pt * px * py, w_pt * px * pz, w_pt * py * pz,
        w_pt * (py * rz - pz * ry),
        w_pt * (pz * rx - px * rz),
        w_pt * (px * ry - py * rx),
        w_pt * rx, w_pt * ry, w_pt * rz,
    ]
    rvec = (ax, ay, az, nx, ny, nz)
    for u in range(6):
        for v in range(u, 6):
            terms.append(w_pl * rvec[u] * rvec[v])
    for u in range(6):
        terms.append(w_pl * rvec[u] * s)
    terms.append(jnp.where(corr, 1.0, 0.0))
    terms.append(w_pl)
    return terms


_N_TERMS = 45


def _normal_equations(sums):
    """6x6 JtJ (python lists) and Jtr from the 45 moment sums."""
    sw = sums[0]
    spx, spy, spz = sums[1], sums[2], sums[3]
    pxx, pyy, pzz = sums[4], sums[5], sums[6]
    pxy, pxz, pyz = sums[7], sums[8], sums[9]
    # point-to-point: JtJ = [trace*I - Spp, hat(Sp); -hat(Sp), Sw*I]
    trc = pxx + pyy + pzz
    zero = jnp.float32(0.0)
    a = [[zero] * 6 for _ in range(6)]
    a[0][0], a[1][1], a[2][2] = trc - pxx, trc - pyy, trc - pzz
    a[0][1], a[0][2], a[1][2] = -pxy, -pxz, -pyz
    a[0][4], a[0][5] = -spz, spy
    a[1][3], a[1][5] = spz, -spx
    a[2][3], a[2][4] = -spy, spx
    a[3][3] = a[4][4] = a[5][5] = sw
    b = list(sums[10:16])
    # plane rows = [p x n | n], residual s
    k = 16
    for u in range(6):
        for v in range(u, 6):
            a[u][v] = a[u][v] + sums[k]
            k += 1
    for u in range(6):
        b[u] = b[u] + sums[k]
        k += 1
    for u in range(6):
        for v in range(u):
            a[u][v] = a[v][u]
    return a, b


def _make_loop_kernel(max_iterations: int, use_prior: bool, n_chunks: int,
                      chunk: int):
    def kernel(rows_ref, cx_ref, cy_ref, cz_ref, inf_ref, scal_ref,
               out_ref):
        kern = scal_ref[_S_KERN]
        max_d2 = scal_ref[_S_MAXD2]
        plane_q = scal_ref[_S_PLQ]
        conv2 = scal_ref[_S_CONV2]
        prw = scal_ref[_S_PRW]
        ptw = scal_ref[_S_PTW]
        gi = tuple(scal_ref[_S_POSE_INV + k] for k in _POSE_KEYS)
        gi_r, gi_t = gi[:9], gi[9:]

        def body(carry):
            pose, _conv, _n_corr, iters = carry

            def chunk_body(i, acc):
                terms = _chunk_moments(
                    pose, rows_ref, cx_ref, cy_ref, cz_ref, inf_ref,
                    i * chunk, chunk, kern, max_d2, plane_q)
                return tuple(a + b for a, b in zip(acc, terms))

            acc0 = tuple(jnp.zeros((chunk,), jnp.float32)
                         for _ in range(_N_TERMS))
            acc = jax.lax.fori_loop(0, n_chunks, chunk_body, acc0)
            sums = [jnp.sum(v) for v in acc]
            a, b = _normal_equations(sums)
            n_corr = sums[43]
            tot_w = sums[0] + sums[44]

            r, t = pose[:9], pose[9:]
            if use_prior:
                rel_r, rel_t = _compose_scalars(r, t, gi_r, gi_t)
                xi = _log_pose_scalars(rel_r, rel_t)
                for u in range(6):
                    wp = tot_w * (prw if u < 3 else ptw)
                    a[u][u] = a[u][u] + wp
                    b[u] = b[u] + wp * xi[u]
            for u in range(6):
                a[u][u] = a[u][u] + jnp.float32(1e-8)
            dx = _solve_spd6_scalars(a, [-bb for bb in b])

            dr, dt = _exp_twist_scalars(dx)
            new_r, new_t = _compose_scalars(dr, dt, r, t)
            dx2 = sum(d * d for d in dx)
            return (tuple(new_r) + tuple(new_t), dx2 < conv2, n_corr,
                    iters + 1)

        def cond(carry):
            return jnp.logical_and(jnp.logical_not(carry[1]),
                                   carry[3] < max_iterations)

        pose0 = tuple(scal_ref[_S_POSE + k] for k in _POSE_KEYS)
        init = (pose0, jnp.bool_(False), jnp.float32(0.0), jnp.int32(0))
        pose, _, n_corr, iters = jax.lax.while_loop(cond, body, init)
        for k, sk in enumerate(_POSE_KEYS):
            out_ref[_O_POSE + sk] = pose[k]
        out_ref[_O_NCORR] = n_corr
        out_ref[_O_ITERS] = iters.astype(jnp.float32)

        # model deviation guess^-1 @ pose for the adaptive threshold
        # (kiss AdaptiveThreshold inputs, reference src/ptudes/kiss.py:116-128)
        dev_r, dev_t = _compose_scalars(gi_r, gi_t, pose[:9], pose[9:])
        out_ref[_O_DEVT] = jnp.sqrt(
            dev_t[0] ** 2 + dev_t[1] ** 2 + dev_t[2] ** 2)
        w = _log_pose_scalars(dev_r, (0.0, 0.0, 0.0))
        out_ref[_O_DEVR] = jnp.sqrt(w[0] ** 2 + w[1] ** 2 + w[2] ** 2)

    return kernel


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def kernel_inputs(source, source_mask, cand, loss: str, chunk: int):
    """The kernel's operands from a gathered ``icp.CandidateSet``, padded
    to the block shapes Triton needs: candidates to a power of two per
    point (invalid padding), points to a whole number of chunks
    (masked padding). Returns (rows [16, Np], cx, cy, cz, inf [Np, Cp])."""
    n, c = cand.valid.shape
    cp = _next_pow2(c)
    np_ = -(-n // chunk) * chunk
    if loss == "plane":
        normal, centroid, quality = cand.normal, cand.centroid, cand.quality
    else:
        normal = jnp.zeros((n, 3), jnp.float32)
        centroid = jnp.zeros((n, 3), jnp.float32)
        quality = jnp.full((n,), -1.0, jnp.float32)   # never >= threshold
    rows = jnp.concatenate([
        source.astype(jnp.float32), normal, centroid, quality[:, None],
        source_mask.astype(jnp.float32)[:, None],
        jnp.zeros((n, _N_ROWS - 11), jnp.float32)], axis=1).T
    rows = jnp.pad(rows, ((0, 0), (0, np_ - n)))
    pad = ((0, np_ - n), (0, cp - c))
    cx, cy, cz = (jnp.pad(cand.pts[:, :, i], pad) for i in range(3))
    inf = jnp.pad(jnp.where(cand.valid, 0.0, jnp.float32(_BIG)), pad,
                  constant_values=_BIG)
    return rows, cx, cy, cz, inf


def chunk_rows(n_candidates: int) -> int:
    """Points per chunk: a [chunk, C] tile of TILE_ELEMS floats per
    operand."""
    return max(16, TILE_ELEMS // _next_pow2(n_candidates))


@partial(jax.jit, inline=True, static_argnames=(
    "plane_min_quality", "max_iterations", "prior_rot_weight",
    "prior_trans_weight", "loss", "interpret"))
def icp_loop(
    source: jax.Array,        # [N, 3] source points (body frame)
    source_mask: jax.Array,   # [N] bool
    cand,                     # icp.CandidateSet gathered at the guess
    initial_guess: jax.Array,  # [4, 4]
    kernel: jax.Array,
    max_d2: jax.Array,
    convergence: jax.Array | float = 1e-4,
    *,
    plane_min_quality: float = 0.2,
    max_iterations: int = 50,
    prior_rot_weight: float = 0.0,
    prior_trans_weight: float = 0.0,
    loss: str = "plane",
    interpret: bool = False,
):
    """Run the whole frozen-candidate GN ICP in one kernel launch.

    Returns (pose [4,4], n_corr, iters, dev_t, dev_r): the pose triple of
    the XLA while_loop (to f32 summation order), plus the model-deviation
    norms of ``guess^-1 @ pose`` computed in the kernel epilogue.
    """
    from ..geom import se3

    chunk = chunk_rows(cand.valid.shape[1])
    rows, cx, cy, cz, inf = kernel_inputs(source, source_mask, cand, loss,
                                          chunk)
    guess = initial_guess.astype(jnp.float32)
    ginv = se3.inv(guess)
    conv = jnp.asarray(convergence, jnp.float32)
    scal = jnp.concatenate([
        jnp.stack([kernel.astype(jnp.float32), max_d2.astype(jnp.float32),
                   jnp.float32(plane_min_quality), conv * conv,
                   jnp.float32(prior_rot_weight),
                   jnp.float32(prior_trans_weight),
                   jnp.float32(0.0), jnp.float32(0.0)]),
        guess[:3].reshape(12), ginv[:3].reshape(12)])

    kern_fn = _make_loop_kernel(
        max_iterations,
        use_prior=(prior_rot_weight > 0.0 or prior_trans_weight > 0.0),
        n_chunks=rows.shape[1] // chunk, chunk=chunk)
    out = pl.pallas_call(
        kern_fn,
        out_shape=jax.ShapeDtypeStruct((16,), jnp.float32),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=NUM_STAGES),
        interpret=interpret,
        name="icp_gn_loop",
    )(rows, cx, cy, cz, inf, scal)

    pose = jnp.concatenate(
        [out[:12].reshape(3, 4),
         jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32)], axis=0)
    return (pose, out[_O_NCORR].astype(jnp.int32),
            out[_O_ITERS].astype(jnp.int32),
            out[_O_DEVT], out[_O_DEVR])
