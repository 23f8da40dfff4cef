"""ES-EKF tests: numpy-f64 oracle for predict/update + sim-as-oracle
convergence (the reference's de-facto correctness test, SURVEY.md sec 4)."""
from functools import partial

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

import jax
import jax.numpy as jnp

from ptudes_tpu import GRAV
from ptudes_tpu.config import EkfConfig
from ptudes_tpu.models import esekf, sim
from ptudes_tpu.models.esekf import Imu

CFG = EkfConfig()
CFG_REF = EkfConfig(joseph_form=False)  # exact reference update form


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Run the EKF predict kernel in the Pallas interpreter (no card
    here): the predict path looks the kernel up at call time."""
    from ptudes_tpu.ops import pallas_ekf
    monkeypatch.setattr(pallas_ekf, "predict_block",
                        partial(pallas_ekf.predict_block, interpret=True))


class NumpyEkf:
    """Minimal f64 oracle implementing the reference ESEKF math
    (src/ptudes/ins/es_ekf.py:191-327)."""

    def __init__(self, cfg: EkfConfig):
        self.cfg = cfg
        self.pos = np.zeros(3)
        self.vel = np.zeros(3)
        self.rot = np.eye(3)
        self.bg = np.zeros(3)
        self.ba = np.zeros(3)
        self.grav = GRAV * np.array([0.0, 0.0, -1.0])
        att = R.from_euler("XYZ", [10.0] * 3, degrees=True).as_rotvec()
        self.cov = np.diag(
            np.concatenate([
                [cfg.init_pos_std**2] * 3,
                [cfg.init_vel_std**2] * 3,
                att**2,
                [cfg.init_bg_std**2] * 3,
                [cfg.init_ba_std**2] * 3,
                [cfg.init_grav_std**2] * 3,
            ])
        )
        self.ts = None

    @staticmethod
    def _hat(v):
        return np.array(
            [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])

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
        self.pos = self.pos + self.vel * dt + 0.5 * (lacc_g + self.grav) * dt**2
        self.vel = self.vel + (lacc_g + self.grav) * dt
        self.rot = r_prev @ rot_d

        f = np.eye(18)
        f[0:3, 3:6] = dt * np.eye(3)
        f[3:6, 6:9] = -dt * r_prev @ self._hat(acc_body)
        f[3:6, 12:15] = -dt * r_prev
        f[6:9, 6:9] = rot_d.T
        f[6:9, 9:12] = -dt * np.eye(3)
        w = np.zeros((18, 18))
        w[3:6, 3:6] = (dt * self.cfg.acc_bias_std) ** 2 * np.eye(3)
        w[6:9, 6:9] = (dt * self.cfg.gyr_bias_std) ** 2 * np.eye(3)
        w[12:15, 12:15] = dt * self.cfg.acc_vrw**2 * np.eye(3)
        w[9:12, 9:12] = dt * self.cfg.gyr_arw**2 * np.eye(3)
        self.cov = f @ self.cov @ f.T + w

    def pose_update(self, pose):
        resid = np.zeros(6)
        resid[:3] = pose[:3, 3] - self.pos
        resid[3:] = R.from_matrix(self.rot.T @ pose[:3, :3]).as_rotvec()
        jp = np.zeros((6, 18))
        jp[0:3, 0:3] = np.eye(3)
        jp[3:6, 6:9] = np.eye(3)
        mc = np.diag([self.cfg.meas_pos_std**2] * 3
                     + [self.cfg.meas_att_std**2] * 3)
        s = jp @ self.cov @ jp.T + mc
        k = self.cov @ jp.T @ np.linalg.inv(s)
        dx = k @ resid
        self.cov = (np.eye(18) - k @ jp) @ self.cov
        self.pos += dx[0:3]
        self.vel += dx[3:6]
        self.rot = self.rot @ R.from_rotvec(dx[6:9]).as_matrix()
        self.bg += dx[9:12]
        self.ba += dx[12:15]
        self.grav += dx[15:18]
        g = np.eye(3) - self._hat(0.5 * dx[6:9])
        self.cov[6:9, 6:9] = g @ self.cov[6:9, 6:9] @ g.T

    def pose_mat(self):
        p = np.eye(4)
        p[:3, :3] = self.rot
        p[:3, 3] = self.pos
        return p


def run_both(n_imu=200, corr_every=20, cfg=CFG_REF, seed=1):
    ideal, noisy = sim.sim_imu_arrays(seed, n_imu)
    oracle = NumpyEkf(cfg)
    s = esekf.init_state(cfg)
    lacc = np.asarray(noisy.lacc, np.float64)
    avel = np.asarray(noisy.avel, np.float64)
    ts = np.asarray(noisy.ts, np.float64)
    # a fixed pose measurement stream (doesn't need to be consistent motion
    # for equivalence testing)
    rng = np.random.default_rng(9)
    for i in range(n_imu):
        oracle.imu(lacc[i], avel[i], ts[i])
        s = esekf.process_imu(
            s, Imu(noisy.lacc[i], noisy.avel[i], noisy.ts[i]), cfg=cfg)
        if i and i % corr_every == 0:
            pose = np.eye(4)
            pose[:3, 3] = rng.normal(size=3)
            pose[:3, :3] = R.from_rotvec(rng.normal(scale=0.1, size=3)).as_matrix()
            oracle.pose_update(pose)
            s = esekf.process_pose(
                s, jnp.asarray(pose, jnp.float32), cfg=cfg)
    return oracle, s


class TestAgainstOracle:
    def test_predict_only_matches_f64_oracle(self):
        ideal, noisy = sim.sim_imu_arrays(3, 100)
        oracle = NumpyEkf(CFG_REF)
        s = esekf.init_state(CFG_REF)
        for i in range(100):
            oracle.imu(np.asarray(noisy.lacc[i], np.float64),
                       np.asarray(noisy.avel[i], np.float64),
                       float(noisy.ts[i]))
            s = esekf.process_imu(
                s, Imu(noisy.lacc[i], noisy.avel[i], noisy.ts[i]), cfg=CFG_REF)
        assert np.allclose(s.pos, oracle.pos, atol=2e-2)
        assert np.allclose(s.vel, oracle.vel, atol=1e-2)
        assert np.allclose(
            np.asarray(esekf.pose_mat(s))[:3, :3], oracle.rot, atol=1e-3)
        assert np.allclose(s.cov, oracle.cov, rtol=2e-3, atol=2e-2)

    def test_full_filter_matches_f64_oracle(self):
        # random (motion-inconsistent) pose measurements make the filter a
        # chaotic feedback loop that amplifies f32-vs-f64 rounding, so
        # tolerances here are looser than the predict-only check above
        oracle, s = run_both()
        assert np.allclose(s.pos, oracle.pos, atol=5e-2)
        assert np.allclose(
            np.asarray(esekf.pose_mat(s))[:3, :3], oracle.rot, atol=5e-3)
        assert np.allclose(s.bias_acc, oracle.ba, atol=8e-2)
        assert np.allclose(s.bias_gyr, oracle.bg, atol=8e-2)
        assert np.allclose(s.cov, oracle.cov, rtol=2e-2, atol=5e-2)


class TestSimOracle:
    """Reference's ekf-bench sim: ideal-IMU filter is ground truth; the noisy
    filter with pose corrections must converge to it
    (src/ptudes/cli/ekf_bench.py:107-167)."""

    def _run(self, cfg, n=2000, corr_every=10, freq=100.0):
        ideal, noisy = sim.sim_imu_arrays(42, n, freq=freq)
        s_gt = esekf.init_state(cfg)
        s = esekf.init_state(cfg)

        def step(carry, inp):
            s_gt, s = carry
            imu_i, imu_n, do_corr = inp
            s_gt = esekf.process_imu(s_gt, imu_i, cfg=cfg)
            s = esekf.process_imu(s, imu_n, cfg=cfg)
            corrected = esekf.process_pose(s, esekf.pose_mat(s_gt), cfg=cfg)
            s = esekf.masked_update(s, corrected, do_corr)
            return (s_gt, s), (esekf.pose_mat(s_gt), esekf.pose_mat(s))

        do_corr = (jnp.arange(n) % corr_every == 0) & (jnp.arange(n) > 0)
        (s_gt, s), (gt_poses, poses) = jax.lax.scan(
            step, (s_gt, s), (ideal, noisy, do_corr))
        return np.asarray(gt_poses), np.asarray(poses)

    def test_converges_to_sim_ground_truth(self):
        gt, est = self._run(CFG)
        # skip burn-in, compare last half
        half = len(gt) // 2
        terr = np.linalg.norm(gt[half:, :3, 3] - est[half:, :3, 3], axis=-1)
        assert terr.mean() < 0.05, f"mean trans err {terr.mean():.4f} m"
        rerr = [
            np.linalg.norm(R.from_matrix(
                est[i, :3, :3].T @ gt[i, :3, :3]).as_rotvec())
            for i in range(half, len(gt), 50)
        ]
        assert np.mean(rerr) < 0.02, f"mean rot err {np.mean(rerr):.4f} rad"

    def test_joseph_form_not_worse(self):
        gt_j, est_j = self._run(EkfConfig(joseph_form=True))
        gt_r, est_r = self._run(EkfConfig(joseph_form=False))
        half = len(gt_j) // 2
        e_j = np.linalg.norm(gt_j[half:, :3, 3] - est_j[half:, :3, 3], axis=-1).mean()
        e_r = np.linalg.norm(gt_r[half:, :3, 3] - est_r[half:, :3, 3], axis=-1).mean()
        assert e_j < e_r * 1.5


class TestBatched:
    def test_imu_batch_equals_sequential(self):
        """The unrolled chain bit-matches K sequential process_imu calls."""
        import dataclasses
        _, noisy = sim.sim_imu_arrays(5, 16)
        cfg = dataclasses.replace(CFG, predict_batch="unroll")
        s0 = esekf.init_state(cfg)
        s_seq = s0
        for i in range(10):
            s_seq = esekf.process_imu(
                s_seq, Imu(noisy.lacc[i], noisy.avel[i], noisy.ts[i]), cfg=cfg)
        valid = jnp.arange(16) < 10
        s_bat = esekf.process_imu_batch(s0, noisy, valid, cfg=cfg)
        assert np.allclose(s_bat.pos, s_seq.pos, atol=1e-6)
        assert np.allclose(s_bat.cov, s_seq.cov, atol=1e-5)
        assert np.allclose(s_bat.imu_ts, s_seq.imu_ts)

    def test_assoc_matches_unroll(self):
        """The associative-scan predict (default) matches the unrolled
        chain to f32 reassociation tolerance — nav state near-exactly,
        covariance to ~1e-3 absolute at entry magnitudes ~100."""
        import dataclasses
        _, noisy = sim.sim_imu_arrays(7, 16)
        cfg_u = dataclasses.replace(CFG, predict_batch="unroll")
        cfg_a = dataclasses.replace(CFG, predict_batch="assoc")
        s0 = esekf.init_state(CFG)
        valid = jnp.arange(16) < 13   # padded tail must be a no-op
        s_u = esekf.process_imu_batch(s0, noisy, valid, cfg=cfg_u)
        s_a = esekf.process_imu_batch(s0, noisy, valid, cfg=cfg_a)
        assert np.allclose(s_a.pos, s_u.pos, atol=1e-5)
        assert np.allclose(s_a.vel, s_u.vel, atol=1e-5)
        assert np.allclose(s_a.quat, s_u.quat, atol=1e-6)
        assert np.allclose(s_a.imu_ts, s_u.imu_ts)
        assert bool(s_a.initialized) == bool(s_u.initialized)
        assert np.allclose(s_a.cov, s_u.cov, rtol=1e-3, atol=2e-3), \
            np.abs(np.asarray(s_a.cov) - np.asarray(s_u.cov)).max()

    def test_pallas_kernel_matches_unroll(self, interpret_kernels):
        """The one-launch predict kernel (predict_batch='triton',
        interpret mode here) matches the unrolled chain near-exactly —
        the in-kernel math IS the sequential chain (matrix-form attitude
        + per-step symmetrized covariance), so tolerances are f32
        roundoff, tighter than the assoc form's reassociation."""
        import dataclasses
        _, noisy = sim.sim_imu_arrays(7, 16)
        cfg_u = dataclasses.replace(CFG, predict_batch="unroll")
        cfg_p = dataclasses.replace(CFG, predict_batch="triton")
        s0 = esekf.init_state(CFG)
        valid = jnp.arange(16) < 13
        s_u = esekf.process_imu_batch(s0, noisy, valid, cfg=cfg_u)
        s_p = esekf.process_imu_batch(s0, noisy, valid, cfg=cfg_p)
        assert np.allclose(s_p.pos, s_u.pos, atol=1e-6)
        assert np.allclose(s_p.vel, s_u.vel, atol=1e-6)
        assert np.allclose(s_p.quat, s_u.quat, atol=1e-6)
        assert np.allclose(s_p.imu_ts, s_u.imu_ts)
        assert bool(s_p.initialized) == bool(s_u.initialized)
        assert np.allclose(s_p.cov, s_u.cov, rtol=1e-5, atol=1e-5), \
            np.abs(np.asarray(s_p.cov) - np.asarray(s_u.cov)).max()
        # logging-invariance holds for the kernel form too: the carried
        # state of log=True is the kernel-form state
        s_pl, _ = esekf.process_imu_batch(s0, noisy, valid, cfg=cfg_p,
                                          log=True)
        for f in esekf.EkfState._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(s_p, f)), np.asarray(getattr(s_pl, f)))

    def test_pallas_kernel_uninitialized_latch(self, interpret_kernels):
        """First valid sample of an uninitialized filter only latches the
        timestamp (same contract as process_imu / the assoc form)."""
        import dataclasses
        _, noisy = sim.sim_imu_arrays(3, 8)
        cfg_u = dataclasses.replace(CFG, predict_batch="unroll")
        cfg_p = dataclasses.replace(CFG, predict_batch="triton")
        s0 = esekf.init_state(CFG)
        valid = jnp.arange(8) < 5
        s_u = esekf.process_imu_batch(s0, noisy, valid, cfg=cfg_u)
        s_p = esekf.process_imu_batch(s0, noisy, valid, cfg=cfg_p)
        assert np.allclose(s_p.pos, s_u.pos, atol=1e-6)
        assert np.allclose(s_p.imu_ts, s_u.imu_ts)

    def test_assoc_uninitialized_first_sample_latches(self):
        """First valid sample of a fresh filter only latches the clock —
        both modes."""
        import dataclasses
        _, noisy = sim.sim_imu_arrays(3, 4)
        one = jnp.asarray([True, False, False, False])
        for mode in ("unroll", "assoc"):
            cfg = dataclasses.replace(CFG, predict_batch=mode)
            s0 = esekf.init_state(cfg)
            s1 = esekf.process_imu_batch(s0, noisy, one, cfg=cfg)
            assert np.allclose(s1.pos, s0.pos)
            assert np.allclose(s1.cov, s0.cov, atol=1e-6)
            assert float(s1.imu_ts) == float(noisy.ts[0])
            assert bool(s1.initialized)

    def test_vmap_over_filters(self):
        cfg = CFG
        _, n1 = sim.sim_imu_arrays(1, 32)
        _, n2 = sim.sim_imu_arrays(2, 32)
        imus = jax.tree.map(lambda a, b: jnp.stack([a, b]), n1, n2)
        s0 = jax.tree.map(
            lambda x: jnp.stack([x, x]),
            esekf.init_state(cfg))
        valid = jnp.ones((2, 32), bool)
        out = jax.vmap(
            lambda s, i, v: esekf.process_imu_batch(s, i, v, cfg=cfg)
        )(s0, imus, valid)
        assert out.pos.shape == (2, 3)
        assert not np.allclose(out.pos[0], out.pos[1])


def test_stale_imu_sample_is_noop():
    """Samples at or before the carried timestamp must not mechanize the
    state backwards (negative dt) — the resume-seam failure mode."""
    cfg = EkfConfig()
    s = esekf.init_state(cfg)
    for t in (0.0, 0.01, 0.02):
        s = esekf.process_imu(
            s, Imu(lacc=jnp.asarray([0.1, 0.0, GRAV]),
                   avel=jnp.asarray([0.0, 0.0, 0.1]),
                   ts=jnp.asarray(t, jnp.float32)), cfg=cfg)
    stale = esekf.process_imu(
        s, Imu(lacc=jnp.asarray([5.0, 5.0, 5.0]),
               avel=jnp.asarray([1.0, 1.0, 1.0]),
               ts=jnp.asarray(0.005, jnp.float32)), cfg=cfg)
    np.testing.assert_allclose(np.asarray(stale.pos), np.asarray(s.pos))
    np.testing.assert_allclose(np.asarray(stale.vel), np.asarray(s.vel))
    np.testing.assert_allclose(np.asarray(stale.quat), np.asarray(s.quat))
    np.testing.assert_allclose(np.asarray(stale.cov), np.asarray(s.cov))
    assert float(stale.imu_ts) == float(s.imu_ts)  # ts stays monotonic


def test_predict_twist_forms_agree(interpret_kernels):
    """want_twist must return log(T_in^-1 @ T_out) on every predict
    form (the kernel computes it in its epilogue; the others in XLA) —
    the LIO deskew consumes it."""
    from ptudes_tpu.geom import se3

    rng = np.random.default_rng(9)
    k = 12
    imus = Imu(
        lacc=jnp.asarray(rng.normal(0, 1, (k, 3)) + [0, 0, 9.78],
                         jnp.float32),
        avel=jnp.asarray(rng.normal(0, 0.3, (k, 3)), jnp.float32),
        ts=jnp.asarray(np.arange(1, k + 1) * 0.01, jnp.float32))
    valid = jnp.asarray(np.arange(k) < 10)
    twists = {}
    for form in ("assoc", "unroll", "triton"):
        cfg = EkfConfig(predict_batch=form)
        s = esekf.init_state(cfg)
        st, tw = esekf.process_imu_batch(s, imus, valid, cfg=cfg,
                                         want_twist=True)
        ref = se3.log_pose(
            se3.inv(esekf.pose_mat(s)) @ esekf.pose_mat(st))
        np.testing.assert_allclose(np.asarray(tw), np.asarray(ref),
                                   atol=2e-5)
        twists[form] = np.asarray(tw)
    np.testing.assert_allclose(twists["assoc"], twists["triton"],
                               atol=2e-5)
