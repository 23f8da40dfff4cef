"""f64 numpy oracle of the kiss-icp odometry algorithm (no JAX).

Used to A/B the device pipeline and as the honest CPU baseline for bench.py:
same voxelization semantics (first point per voxel), same adaptive
threshold, same robust GN. The ICP inner loop's exact NN runs over a
fast-build per-registration KD-tree (``scipy.spatial.cKDTree``, built
once per scan — the map is immutable during ICP); the packed-key
``searchsorted`` voxel-hash structure below provides the kiss insert/
evict semantics (points grouped per voxel, ppv cap, whole-voxel
eviction) and a vectorized 27-neighborhood query for A/B use. Not part
of the shipped framework — a debugging/validation/baseline tool.

Reference behavior mirrored: ``/root/reference/src/ptudes/kiss.py:83-131``
(deskew -> clip -> double voxelize -> adaptive sigma -> robust GN ->
threshold update -> map insert/evict).

:class:`OracleLio` adds the POLICY-IDENTICAL baseline of the flagship
loosely-coupled pipeline (reference ``ptudes ekf-bench ouster
--use-imu-prediction``, ``src/ptudes/cli/ekf_bench.py:493-563``): a
minimal f64 ES-EKF (the reference math, ``src/ptudes/ins/es_ekf.py:
191-327``) supplies the deskew twist and ICP initial guess, and fuses
the ICP pose back — the same per-scan policy the device pipeline runs, so
bench.py's relative quality gate compares like with like.
"""
import numpy as np
from scipy.spatial.transform import Rotation as R

_OFF = 1 << 20  # 21-bit biased voxel coordinates packed into int64


def pack_keys(coords):
    """[..., 3] int voxel coords -> packed int64 keys."""
    c = coords.astype(np.int64) + _OFF
    return (c[..., 0] << 42) | (c[..., 1] << 21) | c[..., 2]


_NEIGHBORS = np.stack(np.meshgrid(*([np.arange(-1, 2)] * 3),
                                  indexing="ij"), -1).reshape(-1, 3)


def voxel_down(points, vs):
    keys = pack_keys(np.floor(points / vs))
    _, idx = np.unique(keys, return_index=True)  # 1-D unique: ~10x the
    #                                              axis=0 structured sort
    return points[np.sort(idx)]


def hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def exp_twist(dx):  # [rot, trans]
    T = np.eye(4)
    T[:3, :3] = R.from_rotvec(dx[:3]).as_matrix()
    theta = np.linalg.norm(dx[:3])
    w = dx[:3]
    K = hat(w)
    if theta < 1e-9:
        V = np.eye(3)
    else:
        V = (np.eye(3) + (1 - np.cos(theta)) / theta**2 * K
             + (theta - np.sin(theta)) / theta**3 * K @ K)
    T[:3, 3] = V @ dx[3:]
    return T


def log_pose(T):
    """se(3) log: [rotvec, V^-1 t]."""
    w = R.from_matrix(T[:3, :3]).as_rotvec()
    theta = np.linalg.norm(w)
    K = hat(w)
    if theta < 1e-9:
        Vinv = np.eye(3) - 0.5 * K
    else:
        Vinv = (np.eye(3) - 0.5 * K
                + (1.0 / theta**2)
                * (1.0 - theta * np.sin(theta) / (2.0 * (1.0 - np.cos(theta))))
                * (K @ K))
    return np.concatenate([w, Vinv @ T[:3, 3]])


def deskew_by_twist(pts, scales, twist):
    """Apply exp(scale_i * twist) per point (vectorized Rodrigues) — the
    same const-velocity mid-scan-anchor model as kiss-icp's compensator
    and the repo's ops/deskew.py."""
    w, v = twist[:3], twist[3:]
    theta2 = float(w @ w)
    theta = np.sqrt(theta2)
    if theta < 1e-8:
        return pts + scales[:, None] * v
    st = scales * theta
    sin_st, cos_st = np.sin(st), np.cos(st)
    a = sin_st / theta
    b = (1.0 - cos_st) / theta2
    wxp = np.cross(np.broadcast_to(w, pts.shape), pts)
    wwxp = np.cross(np.broadcast_to(w, pts.shape), wxp)
    rotated = pts + a[:, None] * wxp + b[:, None] * wwxp
    cc = (st - sin_st) / (theta2 * theta)
    wxv = np.cross(w, v)
    wwxv = np.cross(w, wxv)
    t = scales[:, None] * v + b[:, None] * wxv + cc[:, None] * wwxv
    return rotated + t


class VoxelHashMapNp:
    """kiss-icp's VoxelHashMap, vectorized: points stored grouped by
    packed voxel key in sorted flat arrays; the 27-neighborhood NN query
    is a batched binary search + dense distance argmin."""

    def __init__(self, voxel_size, max_points_per_voxel, max_range):
        self.vs = voxel_size
        self.ppv = max_points_per_voxel
        self.max_range = max_range
        self.point_keys = np.zeros(0, np.int64)   # sorted, grouped
        self.pts = np.zeros((0, 3))
        self.uniq = np.zeros(0, np.int64)
        self.starts = np.zeros(0, np.int64)
        self.counts = np.zeros(0, np.int64)

    def __len__(self):
        return len(self.pts)

    def _reindex(self):
        self.uniq, self.starts, self.counts = np.unique(
            self.point_keys, return_index=True, return_counts=True)

    def insert(self, new_pts):
        new_keys = pack_keys(np.floor(new_pts / self.vs))
        keys = np.concatenate([self.point_keys, new_keys])
        pts = np.concatenate([self.pts, new_pts])
        # stable sort keeps existing points first within each voxel (the
        # "voxel full -> drop new point" kiss insert semantics)
        order = np.argsort(keys, kind="stable")
        keys, pts = keys[order], pts[order]
        uniq, starts, counts = np.unique(keys, return_index=True,
                                         return_counts=True)
        rank = np.arange(len(keys)) - np.repeat(starts, counts)
        keep = rank < self.ppv
        self.point_keys, self.pts = keys[keep], pts[keep]
        self._reindex()

    def evict(self, origin):
        """Drop whole voxels whose FIRST stored point is beyond max_range
        of origin (kiss semantics)."""
        if not len(self.uniq):
            return
        reps = self.pts[self.starts]
        far = np.linalg.norm(reps - origin, axis=1) > self.max_range
        if not far.any():
            return
        drop_pts = np.repeat(far, self.counts)
        self.point_keys = self.point_keys[~drop_pts]
        self.pts = self.pts[~drop_pts]
        self._reindex()

    def query(self, src_w, max_d):
        """Per-point NN over the 27-neighborhood. Returns (dist, nn_pts,
        found) for each query point."""
        if not len(self.uniq):
            s = len(src_w)
            return (np.full(s, np.inf), np.zeros((s, 3)), np.zeros(s, bool))
        qc = np.floor(src_w / self.vs).astype(np.int64)
        keys27 = pack_keys(qc[:, None, :] + _NEIGHBORS[None, :, :])  # [S,27]
        pos = np.searchsorted(self.uniq, keys27)
        posc = np.minimum(pos, len(self.uniq) - 1)
        ok = self.uniq[posc] == keys27                               # [S,27]
        starts = self.starts[posc]
        counts = np.where(ok, self.counts[posc], 0)
        idx = starts[..., None] + np.arange(self.ppv)                # [S,27,P]
        valid = np.arange(self.ppv) < counts[..., None]
        cand = self.pts[np.minimum(idx, len(self.pts) - 1)]          # [S,27,P,3]
        d2 = np.sum((cand - src_w[:, None, None, :]) ** 2, axis=-1)
        d2[~valid] = np.inf
        flat = d2.reshape(len(src_w), -1)
        j = np.argmin(flat, axis=1)
        d2min = flat[np.arange(len(src_w)), j]
        nn = cand.reshape(len(src_w), -1, 3)[np.arange(len(src_w)), j]
        found = np.isfinite(d2min) & (d2min <= max_d * max_d)
        return np.sqrt(d2min), nn, found


class OracleKiss:
    def __init__(self, voxel_size=0.3, max_range=30.0, min_range=1.0,
                 ppv=20, initial_threshold=2.0, min_motion=0.1,
                 max_iters=100, loss="point", plane_min_quality=0.2,
                 plane_radius=None, prior_rot_weight=0.0,
                 prior_trans_weight=0.0):
        self.vs = voxel_size
        self.max_range = max_range
        self.min_range = min_range
        self.ppv = ppv
        self.sse = 0.0
        self.nsm = 0
        self.init_th = initial_threshold
        self.min_motion = min_motion
        self.max_iters = max_iters
        # loss="plane": per-point patch plane fit at the guess pose +
        # point-to-plane rows with point-to-point fallback, and the
        # guess-anchored motion prior — the SAME registration objective
        # the device pipeline runs (ops/icp.py gn_from_candidates), so the
        # baseline measures the same algorithm, not kiss's point-to-point
        self.loss = loss
        self.plane_min_quality = plane_min_quality
        self.plane_radius = (1.5 * voxel_size if plane_radius is None
                             else plane_radius)
        self.prior_rot_weight = prior_rot_weight
        self.prior_trans_weight = prior_trans_weight
        self.map = VoxelHashMapNp(voxel_size, ppv, max_range)
        self.poses = []

    def sigma(self):
        if self.nsm < 1:
            return self.init_th
        return np.sqrt(self.sse / self.nsm)

    def map_points(self):
        return self.map.pts

    def register(self, pts, guess=None, ts01=None, deskew_twist=None):
        if ts01 is not None and deskew_twist is not None:
            # externally supplied sweep motion (OracleLio passes the
            # EKF's IMU-integrated twist — the device pipeline's
            # deskew_mode="ekf" policy, models/lio.py)
            pts = deskew_by_twist(pts, np.asarray(ts01) - 0.5,
                                  np.asarray(deskew_twist, np.float64))
        elif ts01 is not None and len(self.poses) >= 2:
            delta = np.linalg.inv(self.poses[-2]) @ self.poses[-1]
            pts = deskew_by_twist(pts, np.asarray(ts01) - 0.5,
                                  log_pose(delta))
        d = np.linalg.norm(pts, axis=1)
        pts = pts[(d > self.min_range) & (d < self.max_range)]
        frame_ds = voxel_down(pts, self.vs * 0.5)
        source = voxel_down(frame_ds, self.vs * 1.5)
        sig = self.sigma()
        if guess is None:
            if len(self.poses) >= 2:
                pred = np.linalg.inv(self.poses[-2]) @ self.poses[-1]
            else:
                pred = np.eye(4)
            guess = (self.poses[-1] if self.poses else np.eye(4)) @ pred

        T = guess.copy()
        iters = 0
        if len(self.map):
            # exact NN via a per-registration KD-tree over the flat map
            # array (the map is immutable during ICP). Unbalanced fast
            # build: 34 ms at 280k points on this host, 5.6 ms per query
            # round — the honest CPU cost of this algorithm, vs the
            # 27-neighborhood hash walk kiss C++ does (same result).
            from scipy.spatial import cKDTree
            mp = self.map.pts
            tree = cKDTree(mp, balanced_tree=False, compact_nodes=False)
            kernel = sig / 3.0
            max_d = 3.0 * sig
            guess_inv = np.linalg.inv(guess)

            normal = centroid = quality = None
            if self.loss == "plane":
                # per-point patch plane fit at the GUESS pose, fixed for
                # the whole registration — the device pipeline's gather-once
                # policy (ops/icp.py CandidateSet / prep_with_plane)
                src_g = source @ guess[:3, :3].T + guess[:3, 3]
                k = min(16, len(mp))
                dist, j = tree.query(
                    src_g, k=k, workers=-1,
                    distance_upper_bound=self.plane_radius)
                if k == 1:
                    dist, j = dist[:, None], j[:, None]
                okn = np.isfinite(dist)
                nbr = mp[np.where(okn, j, 0)]                 # [S, k, 3]
                w = okn.astype(np.float64)
                n_in = w.sum(1)
                denom = np.maximum(n_in, 1.0)
                centroid = (nbr * w[..., None]).sum(1) / denom[:, None]
                d = (nbr - centroid[:, None, :]) * w[..., None]
                cov = np.einsum("spi,spj->sij", d, d) / denom[:, None, None]
                lam, vec = np.linalg.eigh(cov)                # ascending
                normal = vec[..., 0]
                quality = np.where(
                    n_in >= 4,
                    (lam[:, 1] - lam[:, 0]) / np.maximum(lam[:, 2], 1e-12),
                    0.0)

            for it in range(self.max_iters):
                iters = it + 1
                src_w = source @ T[:3, :3].T + T[:3, 3]
                dist, j = tree.query(src_w, distance_upper_bound=max_d,
                                     workers=-1)
                corr = np.isfinite(dist)
                jtj = np.zeros((6, 6))
                jtr = np.zeros(6)
                total_w = 0.0
                if self.loss == "plane":
                    use_pl = corr & (quality >= self.plane_min_quality)
                    if use_pl.any():
                        pp = src_w[use_pl]
                        s_res = np.sum(
                            normal[use_pl] * (pp - centroid[use_pl]), 1)
                        w_pl = kernel**2 / (kernel + s_res**2)**2
                        row = np.concatenate(
                            [np.cross(pp, normal[use_pl]),
                             normal[use_pl]], axis=1)
                        rw = row * w_pl[:, None]
                        jtj += rw.T @ row
                        jtr += rw.T @ s_res
                        total_w += w_pl.sum()
                    use_pt = corr & ~use_pl
                else:
                    use_pt = corr
                r = src_w[use_pt] - mp[j[use_pt]]
                p = src_w[use_pt]
                w = kernel**2 / (kernel + np.sum(r * r, axis=1))**2
                # J = [-hat(p) | I], built vectorized (no per-point loop)
                J = np.zeros((len(p), 3, 6))
                J[:, 0, 1] = p[:, 2]
                J[:, 0, 2] = -p[:, 1]
                J[:, 1, 0] = -p[:, 2]
                J[:, 1, 2] = p[:, 0]
                J[:, 2, 0] = p[:, 1]
                J[:, 2, 1] = -p[:, 0]
                J[:, 0, 3] = J[:, 1, 4] = J[:, 2, 5] = 1.0
                Jw = J * w[:, None, None]
                jtj += np.einsum("nij,nik->jk", Jw, J)
                jtr += np.einsum("nij,ni->j", Jw, r)
                total_w += w.sum()
                if self.prior_rot_weight > 0 or self.prior_trans_weight > 0:
                    # guess-anchored motion prior (ops/icp.py)
                    xi = log_pose(T @ guess_inv)
                    wp = total_w * np.array(
                        [self.prior_rot_weight] * 3
                        + [self.prior_trans_weight] * 3)
                    jtj += np.diag(wp)
                    jtr += wp * xi
                jtj += 1e-12 * np.eye(6)
                dx = np.linalg.solve(jtj, -jtr)
                T = exp_twist(dx) @ T
                if np.linalg.norm(dx) < 1e-4:
                    break
        dev = np.linalg.inv(guess) @ T
        err = (np.linalg.norm(dev[:3, 3])
               + 2 * self.max_range * np.sin(
                   0.5 * np.linalg.norm(R.from_matrix(dev[:3, :3]).as_rotvec())))
        if err > self.min_motion:
            self.sse += err**2
            self.nsm += 1
        self.map.insert(frame_ds @ T[:3, :3].T + T[:3, 3])
        self.map.evict(T[:3, 3])
        self.poses.append(T)
        return T, iters, sig


GRAV = 9.782940329221166  # reference constant, src/ptudes/ins/data.py:10


class NumpyEsEkf:
    """Minimal f64 ES-EKF — the reference ESEKF math
    (``src/ptudes/ins/es_ekf.py:191-327``) with the reference tuning
    constants (``:101-119``, meas defaults ``:289-292``), including the
    init-attitude-covariance rotvec^2 quirk. Mirrors the oracle class
    tests/test_esekf.py pins against the JAX filter."""

    def __init__(self):
        self.pos = np.zeros(3)
        self.vel = np.zeros(3)
        self.rot = np.eye(3)
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.grav = GRAV * np.array([0.0, 0.0, -1.0])
        att = R.from_euler("XYZ", [10.0] * 3, degrees=True).as_rotvec()
        self.cov = np.diag(np.concatenate([
            [10.0**2] * 3, [5.0**2] * 3, att**2,
            [1.5**2] * 3, [0.5**2] * 3, [2.5**2] * 3]))
        self.acc_bias_std, self.gyr_bias_std = 0.049, 0.38
        self.acc_vrw, self.gyr_arw = 0.0043, 0.000466
        self.meas_pos_std, self.meas_att_std = 0.02, 0.01
        self.ts = None

    def imu(self, lacc, avel, ts):
        if self.ts is None:
            self.ts = ts
            return
        dt = ts - self.ts
        self.ts = ts
        acc_body = lacc - self.ba
        avel_b = avel - self.bg
        rot_d = R.from_rotvec(avel_b * dt).as_matrix()
        r_prev = self.rot.copy()
        lacc_g = r_prev @ acc_body
        self.pos = (self.pos + self.vel * dt
                    + 0.5 * (lacc_g + self.grav) * dt**2)
        self.vel = self.vel + (lacc_g + self.grav) * dt
        self.rot = r_prev @ rot_d
        f = np.eye(18)
        f[0:3, 3:6] = dt * np.eye(3)
        f[3:6, 6:9] = -dt * r_prev @ hat(acc_body)
        f[3:6, 12:15] = -dt * r_prev
        f[6:9, 6:9] = rot_d.T
        f[6:9, 9:12] = -dt * np.eye(3)
        w = np.zeros((18, 18))
        w[3:6, 3:6] = (dt * self.acc_bias_std) ** 2 * np.eye(3)
        w[6:9, 6:9] = (dt * self.gyr_bias_std) ** 2 * np.eye(3)
        w[12:15, 12:15] = dt * self.acc_vrw**2 * np.eye(3)
        w[9:12, 9:12] = dt * self.gyr_arw**2 * np.eye(3)
        self.cov = f @ self.cov @ f.T + w

    def pose_update(self, pose):
        resid = np.zeros(6)
        resid[:3] = pose[:3, 3] - self.pos
        resid[3:] = R.from_matrix(self.rot.T @ pose[:3, :3]).as_rotvec()
        jp = np.zeros((6, 18))
        jp[0:3, 0:3] = np.eye(3)
        jp[3:6, 6:9] = np.eye(3)
        mc = np.diag([self.meas_pos_std**2] * 3
                     + [self.meas_att_std**2] * 3)
        s = jp @ self.cov @ jp.T + mc
        k = self.cov @ jp.T @ np.linalg.inv(s)
        dx = k @ resid
        self.cov = (np.eye(18) - k @ jp) @ self.cov
        self.pos = self.pos + dx[0:3]
        self.vel = self.vel + dx[3:6]
        self.rot = self.rot @ R.from_rotvec(dx[6:9]).as_matrix()
        self.bg = self.bg + dx[9:12]
        self.ba = self.ba + dx[12:15]
        self.grav = self.grav + dx[15:18]
        g = np.eye(3) - hat(0.5 * dx[6:9])
        self.cov[6:9, 6:9] = g @ self.cov[6:9, 6:9] @ g.T

    def pose_mat(self):
        p = np.eye(4)
        p[:3, :3] = self.rot
        p[:3, 3] = self.pos
        return p


class OracleLio:
    """Policy-identical f64 CPU baseline of the flagship LIO pipeline:
    per scan, EKF predict over the scan's IMU block -> EKF-twist deskew
    -> ICP with the EKF pose as initial guess -> EKF update with the ICP
    pose — the exact loosely-coupled policy the device ``models/lio.py``
    scan_step runs (``guess="ekf"``, ``deskew_mode="ekf"``), so the
    bench's relative quality gate compares the same algorithm, not a
    const-velocity variant of it."""

    def __init__(self, **kiss_kwargs):
        self.kiss = OracleKiss(**kiss_kwargs)
        self.ekf = NumpyEsEkf()

    @property
    def poses(self):
        return self.kiss.poses

    def process(self, pts, ts01, imu_lacc, imu_avel, imu_ts):
        """One scan + its interleaved IMU block (the windowing
        lio.build_batches does). Returns the ICP (kiss) pose."""
        ekf0 = self.ekf.pose_mat()
        for i in range(len(imu_ts)):
            self.ekf.imu(np.asarray(imu_lacc[i], np.float64),
                         np.asarray(imu_avel[i], np.float64),
                         float(imu_ts[i]))
        ekf1 = self.ekf.pose_mat()
        twist = log_pose(np.linalg.inv(ekf0) @ ekf1)
        T, iters, sig = self.kiss.register(
            pts, guess=ekf1, ts01=ts01, deskew_twist=twist)
        self.ekf.pose_update(T)
        return T, iters, sig


if __name__ == "__main__":
    import sys
    sys.path.insert(0, ".")
    from ptudes_tpu.models import sim
    from ptudes_tpu.ops import projection
    import jax.numpy as jnp

    N = 30
    ts, poses = sim.circle_trajectory(N, radius=8.0, speed=2.0, scan_dt=0.1)
    world = sim.make_sim_world(seed=0, extent=25.0, n_boxes=40,
                               keepout_points=poses[:, :3, 3])
    sensor = sim.make_sim_sensor(h=64, w=512, fov_deg=45.0)
    gt0inv = np.linalg.inv(poses[0])
    ok = OracleKiss()
    errs = []
    import time
    t0 = time.monotonic()
    for i in range(N):
        img = sim.render_range_image(world, poses[i], sensor, max_range=60.0,
                                     noise_std=0.01, seed=i)
        pts, mask, _ = projection.scan_to_points(sensor.lut, jnp.asarray(img))
        pts = np.asarray(pts, np.float64)[np.asarray(mask)]
        T, iters, sig = ok.register(pts)
        rel = gt0inv @ poses[i]
        err = np.linalg.norm(T[:3, 3] - rel[:3, 3])
        errs.append(err)
        print(f"scan {i}: err={err:.4f} it={iters} sig={sig:.3f} "
              f"map={len(ok.map)}", flush=True)
    print(f"ATE(mean-sq): {np.mean(np.square(errs))}  "
          f"({N / (time.monotonic() - t0):.2f} scans/s)")
