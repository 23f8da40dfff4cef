"""Endurance benchmark: 1000-scan LIO run with map growth -> saturation ->
eviction churn (BASELINE config 4 equivalent; VERDICT r1 next-round #3).

A 30 m-radius loop (one full lap + re-entry into the mapped start region)
with a 25 m clip range: the local map can only ever hold a moving window
of the world, so voxels continuously evict behind the platform while new
ones insert ahead — the long-sequence mechanism SURVEY.md section 5 calls
out. The run executes in chunks of the SAME compiled program with the
carried state (exactly how a recording larger than device memory would
be driven), so chunk wall-times also measure throughput stability over
the map's life cycle.

Asserts (printed + one JSON line at the end):
  * every pose finite over all 1000 scans;
  * map occupancy bounded AND churning (shrink events after saturation);
  * steady chunk throughput (last chunk within 25% of the second);
  * ATE RMSE against exact mid-sweep ground truth under 0.25 m;
  * end-of-lap position error (re-entering mapped territory) under 1 m.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_SCANS = 1000
H, W = 64, 512
SCAN_DT = 0.1
RADIUS, SPEED, RAMP = 30.0, 2.0, 1.0
MAX_RANGE = 25.0
CHUNK = 250
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache", f"long_{N_SCANS}_{H}x{W}_v1.npz")


def make_data():
    from ptudes_tpu.models import sim

    if os.path.exists(CACHE):
        z = np.load(CACHE)
        return z["scans"], z["scan_ts"], z["gt_mid"], z["imu_ts"]

    ts = np.arange(N_SCANS + 1) * SCAN_DT
    sweep = sim.circle_poses_at(ts, radius=RADIUS, speed=SPEED, ramp=RAMP)
    world = sim.make_sim_world(seed=0, extent=70.0, n_boxes=300,
                               keepout_points=sweep[:, :3, 3])
    sensor = sim.make_sim_sensor(h=H, w=W, fov_deg=45.0)
    scans = np.zeros((N_SCANS, H, W), np.float32)
    t0 = time.monotonic()
    for i in range(N_SCANS):
        scans[i] = sim.render_range_image(
            world, sweep[i], sensor, max_range=60.0, noise_std=0.01,
            seed=i, end_pose=sweep[i + 1])
        if i % 100 == 99:
            print(f"  rendered {i + 1}/{N_SCANS} "
                  f"({(time.monotonic() - t0):.0f} s)", flush=True)
    scan_ts = ts[:N_SCANS] + SCAN_DT
    gt_mid = sim.circle_poses_at(ts[:N_SCANS] + SCAN_DT / 2,
                                 radius=RADIUS, speed=SPEED, ramp=RAMP)
    imu_ts = np.arange(1, N_SCANS * 10 + 2) * 0.01
    os.makedirs(os.path.dirname(CACHE), exist_ok=True)
    np.savez_compressed(CACHE, scans=scans, scan_ts=scan_ts, gt_mid=gt_mid,
                        imu_ts=imu_ts)
    return scans, scan_ts, gt_mid, imu_ts


def main():
    import jax
    from ptudes_tpu.config import Capacity, KissConfig, PipelineConfig
    from ptudes_tpu.models import lio, sim
    from ptudes_tpu.utils.device import card_name_and_power, require_gpu
    from ptudes_tpu.utils.metrics import calc_ate_rmse

    device = require_gpu()
    device["card"] = card_name_and_power()
    print(f"device: {device}", flush=True)

    scans, scan_ts, gt_mid, imu_ts = make_data()
    sensor = sim.make_sim_sensor(h=H, w=W, fov_deg=45.0)
    imu = sim.imu_for_circle(imu_ts, radius=RADIUS, speed=SPEED, ramp=RAMP)
    cfg = PipelineConfig(
        kiss=KissConfig(max_range=MAX_RANGE, min_range=1.0,
                        max_points_per_voxel=8, max_iterations=20,
                        deskew=True, loss="plane", voxel_size=0.3,
                        plane_fit_radius=0.6, nn_mode="cached",
                        nn_voxels=4, nn_neighborhood=7,
                        nn_refresh_drift=0.0),
        # capacities right-sized at the churn operating point: the
        # even-decimated insert budget retries overflow next scan (ATE
        # 0.095 at max_source 2048 / max_new 1024 vs 0.117 at 8192/8192);
        # max_frame 8192 starves the map (ATE 0.151)
        cap=Capacity(max_points=H * W, max_frame=16384, max_source=2048,
                     map_capacity=1 << 19, dedup_table=1 << 17,
                     max_new_per_scan=1024, max_probes=1),
        max_imu_per_scan=16,
        guess="ekf",
        bootstrap_scans=3,
        steady_insert_mode=False,
        scan_unroll=4,
    )
    ppv = cfg.kiss.max_points_per_voxel

    state = lio.init_state(cfg)
    chunk_times = []
    outs = []
    n_chunks = N_SCANS // CHUNK
    # Preload EVERY chunk's batches to device memory before timing
    # (SURVEY.md section 7 "host->device feed rate ... preloading
    # sequences"): this cell measures the device program; the upload a
    # live deployment pays is not in it (ROADMAP 1.6).
    all_batches = []
    for c in range(n_chunks):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        all_batches.append(lio.build_batches(
            cfg, scans[sl], scan_ts[sl], np.asarray(imu.lacc),
            np.asarray(imu.avel), imu_ts,
            prev_scan_ts=(scan_ts[sl.start - 1] if c else None)))
    jax.block_until_ready(all_batches)
    for c in range(n_chunks):
        t0 = time.monotonic()
        state, out = lio.run_sequence(state, all_batches[c], sensor.lut,
                                      cfg=cfg)
        jax.block_until_ready(out.kiss_pose)
        dt = time.monotonic() - t0
        chunk_times.append(dt)
        outs.append(jax.tree.map(np.asarray, out))
        mp = int(outs[-1].aux.map_points[-1])
        print(f"chunk {c}: {CHUNK / dt:7.1f} scans/s  "
              f"map_points={mp} ({mp / (cfg.cap.map_capacity * ppv):.1%} "
              "of capacity)", flush=True)

    out = jax.tree.map(lambda *x: np.concatenate(x), *outs)
    kp = np.asarray(out.kiss_pose, np.float64)
    mp = np.asarray(out.aux.map_points, np.int64)

    finite = bool(np.isfinite(kp).all()
                  and np.isfinite(np.asarray(out.ekf_cov_diag)).all())
    occupancy_frac = float(mp.max() / (cfg.cap.map_capacity * ppv))
    churn_events = int(np.sum(np.diff(mp) < 0))
    # steady throughput: compare post-warmup chunks (chunk 0 pays compile)
    steady = [CHUNK / t for t in chunk_times[1:]]
    stable = bool(max(steady) / max(min(steady), 1e-9) < 1.25)
    rel = np.einsum("ij,njk->nik", np.linalg.inv(gt_mid[0]), gt_mid)
    _, ate_rmse = calc_ate_rmse(kp, gt_mid)
    end_err = float(np.linalg.norm(kp[-1, :3, 3] - rel[-1, :3, 3]))

    checks = {
        "finite": finite,
        "occupancy_bounded": occupancy_frac < 0.95,
        "eviction_churn": churn_events > 10,
        "throughput_stable": stable,
        "ate_ok": float(ate_rmse) < 0.25,
        "loop_end_ok": end_err < 1.0,
    }
    result = {
        "metric": "lio_long_run",
        "scans": N_SCANS,
        "scans_per_sec_steady": round(float(np.mean(steady)), 1),
        "chunk_scans_per_sec": [round(CHUNK / t, 1) for t in chunk_times],
        "ate_rmse_m": round(float(ate_rmse), 4),
        "end_pos_err_m": round(end_err, 4),
        "map_points_max": int(mp.max()),
        "map_occupancy_frac": round(occupancy_frac, 4),
        "eviction_churn_events": churn_events,
        "checks": checks,
        "ok": all(checks.values()),
        "device": device,
    }
    print(json.dumps(result))
    if not result["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
