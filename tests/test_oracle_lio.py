"""Guards for the CPU baseline (tools/oracle_kiss.py) that bench.py's
relative quality gate depends on.

The baseline must keep implementing the SAME policy as the device pipeline
(VERDICT r4 #4 made it policy-identical); these tests pin:
  * the tool's f64 ES-EKF against the test-suite oracle the JAX filter
    is itself verified against (they implement the same reference math,
    src/ptudes/ins/es_ekf.py:191-327);
  * OracleLio end-to-end convergence on a tiny synthetic scene, so a
    regression that quietly degrades the baseline (and thereby loosens
    bench gate_rel) fails CI instead.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

from oracle_kiss import NumpyEsEkf, OracleLio  # noqa: E402

from test_esekf import CFG_REF, NumpyEkf  # noqa: E402


def test_tool_ekf_matches_test_oracle():
    rng = np.random.default_rng(3)
    a = NumpyEsEkf()
    b = NumpyEkf(CFG_REF)
    ts = 0.0
    for i in range(120):
        ts += 0.01
        lacc = np.array([0.1, -0.2, 9.78]) + rng.normal(0, 0.05, 3)
        avel = np.array([0.01, 0.02, -0.01]) + rng.normal(0, 0.01, 3)
        a.imu(lacc, avel, ts)
        b.imu(lacc, avel, ts)
        if i % 30 == 29:
            pose = np.eye(4)
            pose[:3, 3] = rng.normal(0, 0.1, 3)
            a.pose_update(pose)
            b.pose_update(pose)
    np.testing.assert_allclose(a.pos, b.pos, atol=1e-12)
    np.testing.assert_allclose(a.vel, b.vel, atol=1e-12)
    np.testing.assert_allclose(a.rot, b.rot, atol=1e-12)
    np.testing.assert_allclose(a.cov, b.cov, atol=1e-10)


def test_oracle_lio_tracks_small_scene():
    """OracleLio (plane loss + motion prior, the bench baseline policy)
    must track a simple synthetic box scene — the floor under bench.py's
    gate_rel."""
    import jax.numpy as jnp

    from ptudes_tpu.models import sim
    from ptudes_tpu.ops import projection

    n = 8
    ts = np.arange(n + 1) * 0.1
    sweep = sim.circle_poses_at(ts, radius=8.0, speed=2.0, ramp=1.0)
    world = sim.make_sim_world(seed=0, extent=25.0, n_boxes=20,
                               keepout_points=sweep[:, :3, 3])
    sensor = sim.make_sim_sensor(h=32, w=256, fov_deg=45.0)
    imu_ts = np.arange(1, n * 10 + 2) * 0.01
    imu = sim.imu_for_circle(imu_ts, radius=8.0, speed=2.0, ramp=1.0)
    lacc, avel = np.asarray(imu.lacc), np.asarray(imu.avel)
    scan_ts = ts[:n] + 0.1
    gt_mid = sim.circle_poses_at(ts[:n] + 0.05, radius=8.0, speed=2.0,
                                 ramp=1.0)

    ok = OracleLio(voxel_size=0.3, max_range=60.0, min_range=1.0,
                   max_iters=20, loss="plane", plane_min_quality=0.2,
                   plane_radius=0.6, prior_rot_weight=0.01,
                   prior_trans_weight=0.01)
    prev = -np.inf
    for i in range(n):
        img = sim.render_range_image(world, sweep[i], sensor,
                                     max_range=60.0, noise_std=0.01,
                                     seed=i, end_pose=sweep[i + 1])
        pts, mask, t01 = projection.scan_to_points(sensor.lut,
                                                   jnp.asarray(img))
        m = np.asarray(mask)
        sel = np.where((imu_ts > prev) & (imu_ts <= scan_ts[i]))[0]
        prev = scan_ts[i]
        ok.process(np.asarray(pts, np.float64)[m],
                   np.asarray(t01, np.float64)[m],
                   lacc[sel], avel[sel], imu_ts[sel])
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt_mid[0]), gt_mid)
    err = np.linalg.norm(
        np.asarray(ok.poses)[:, :3, 3] - rel[:, :3, 3], axis=1)
    # smoke floor, not a quality claim: the 32x256 / 45-deg scene is far
    # sparser than the bench scene (where this policy measures 0.025 m);
    # divergence shows up as meters
    assert np.sqrt(np.mean(err**2)) < 0.35, f"oracle RMSE {err}"
