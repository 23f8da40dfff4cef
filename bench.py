"""Benchmark: fused LIO (ICP + EKF) scan throughput on one GPU.

BASELINE config 1 equivalent: OS-0-128-scale scans (128 x 1024), 50 scans,
default KISS-style odometry + ES-EKF fusion — the reference's
``ptudes ekf-bench ouster --use-imu-prediction`` hot loop
(``src/ptudes/cli/ekf_bench.py:493-563``). Real sensor recordings are not
available in this environment, so scans come from the analytic raycast
simulator at the same scale (exact ranges + 1 cm noise, true rotosweep,
platform starting at rest with a 1 s speed ramp — the physical profile of
a real recording). Scan timestamps follow the reference's
last_valid_column_ts convention (end of sweep); the quality gate is ATE
RMSE against the simulator's exact mid-sweep poses (the deskew anchor).

``vs_baseline``: ratio against the POLICY-IDENTICAL f64 numpy LIO oracle
(tools/oracle_kiss.py OracleLio: same EKF-twist deskew, EKF guesses and
EKF fusion as the device pipeline; per-registration KD-tree exact NN)
measured on the host's CPU — the stand-in for a kiss-icp-C++-based LIO
stack, which is not installed. A JSON line with the full context,
including the device (platform, device_kind, count, card name and power
limit), is printed at the end. It refuses to run without a GPU.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_SCANS = 50
H, W = 128, 1024
SCAN_DT = 0.1
RADIUS, SPEED, RAMP = 8.0, 2.0, 1.0
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache")


def make_data(n_scans=N_SCANS):
    """The bench scene, rendered from seed 0 (cached under
    ``.bench_cache/``): scans [n, H, W], end-of-sweep scan timestamps,
    exact mid-sweep poses, 100 Hz IMU timestamps."""
    from ptudes_tpu.models import sim

    cache = os.path.join(CACHE_DIR, f"scene_{n_scans}_{H}x{W}_v4.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return z["scans"], z["scan_ts"], z["gt_mid"], z["imu_ts"]

    ts = np.arange(n_scans + 1) * SCAN_DT
    sweep = sim.circle_poses_at(ts, radius=RADIUS, speed=SPEED, ramp=RAMP)
    world = sim.make_sim_world(seed=0, extent=30.0, n_boxes=40,
                               keepout_points=sweep[:, :3, 3])
    sensor = sim.make_sim_sensor(h=H, w=W, fov_deg=90.0)
    scans = np.stack([
        sim.render_range_image(
            world, sweep[i], sensor, max_range=70.0, noise_std=0.01,
            seed=i, end_pose=sweep[i + 1])
        for i in range(n_scans)
    ])
    scan_ts = ts[:n_scans] + SCAN_DT          # end-of-sweep timestamps
    gt_mid = sim.circle_poses_at(ts[:n_scans] + SCAN_DT / 2,
                                 radius=RADIUS, speed=SPEED, ramp=RAMP)
    imu_ts = np.arange(1, n_scans * 10 + 2) * 0.01
    os.makedirs(CACHE_DIR, exist_ok=True)
    np.savez_compressed(cache, scans=scans, scan_ts=scan_ts, gt_mid=gt_mid,
                        imu_ts=imu_ts)
    return scans, scan_ts, gt_mid, imu_ts


def bench_config():
    """The bench deployment: an OS-0-128 at 128x1024, 10 Hz, 100 Hz IMU,
    a 2^19-slot voxel map. The EKF and GN-loop forms are left to
    ``ops.backend`` (the platform's winners)."""
    from ptudes_tpu.config import (Capacity, KissConfig, PipelineConfig)
    return PipelineConfig(
        # ppv=8: the octant-deduped insert stores at most 8 points/voxel,
        # so 16 would waste half of every candidate gather row and double
        # the per-iteration GN candidate width
        kiss=KissConfig(max_range=70.0, min_range=1.0,
                        max_points_per_voxel=8, max_iterations=20,
                        deskew=True, loss="plane",
                        voxel_size=0.3, plane_fit_radius=0.6,
                        nn_mode="cached", nn_voxels=4,
                        nn_neighborhood=7, nn_refresh_drift=0.0),
        # max_probes=1: every hash-gather site (ICP candidates, insert
        # occupancy check) probes ONE slot — at the ~6% operating load
        # factor the home-slot misses only re-route points through the
        # insert retry path (ATE unchanged).
        # dedup_table 2^18: first-in-voxel scatter tables sized to ~2x the
        # raw point count; collisions just strengthen the downsample.
        # max_source=2048: the deduped source decimates evenly
        # (scan-order-unbiased); ATE 0.0134 at 4096 vs 0.0137 at 2048.
        # max_new_per_scan=2048: 1024 starves the map (ATE 0.0169).
        cap=Capacity(max_points=H * W, max_frame=32768, max_source=2048,
                     map_capacity=1 << 19, dedup_table=1 << 18,
                     max_new_per_scan=2048, max_probes=1),
        # K=12: the sim emits exactly 10 IMU samples per scan interval,
        # so 12 leaves headroom with zero drops
        max_imu_per_scan=12,
        guess="ekf",
        # bootstrap 3 + decimated steady insert: scans 0-2 run the
        # full-overflow body (the map is essentially complete by then on
        # this 30 m scene) and the loop-free budget-decimated insert
        # after; ATE 0.0131 vs 0.0142 with the exact "cond" steady
        # insert. config.py keeps "cond" as the library default (exact
        # map semantics on arbitrary scenes); this is the bench shape.
        bootstrap_scans=3,
        steady_insert_mode=False,
        # pays the lax.scan boundary's carry copies once per 4 scans
        # (results are identical for any factor)
        scan_unroll=4,
    )


def bench_device(scans, scan_ts, gt_mid, imu_ts):
    import jax
    from ptudes_tpu.models import lio, sim
    from ptudes_tpu.utils.metrics import calc_ate_rmse

    sensor = sim.make_sim_sensor(h=H, w=W, fov_deg=90.0)
    imu = sim.imu_for_circle(imu_ts, radius=RADIUS, speed=SPEED, ramp=RAMP)
    cfg = bench_config()
    batches = lio.build_batches(
        cfg, scans, scan_ts, np.asarray(imu.lacc), np.asarray(imu.avel),
        imu_ts)
    state = lio.init_state(cfg)

    t0 = time.monotonic()
    fin, out = lio.run_sequence(state, batches, sensor.lut, cfg=cfg)
    jax.block_until_ready(out.kiss_pose)
    compile_and_run = time.monotonic() - t0

    # steady-state timing (cached executable)
    t0 = time.monotonic()
    fin, out = lio.run_sequence(state, batches, sensor.lut, cfg=cfg)
    jax.block_until_ready(out.kiss_pose)
    dt = time.monotonic() - t0

    # quality gate: first-pose-aligned ATE RMSE vs exact mid-sweep poses
    kp = np.asarray(out.kiss_pose, np.float64)
    _, ate_rmse = calc_ate_rmse(kp, gt_mid)

    return {
        "scans_per_sec": N_SCANS / dt,
        "sec_per_scan": dt / N_SCANS,
        "compile_s": compile_and_run - dt,
        "ate_rmse_m": float(ate_rmse),
    }


def bench_cpu_oracle(scans, scan_ts, gt_mid, imu_ts):
    """POLICY-IDENTICAL f64 numpy LIO oracle on host CPU: the same
    loosely-coupled pipeline the device runs (per-scan ES-EKF predict over
    the scan's IMU block, EKF-twist deskew, EKF pose as the ICP initial
    guess, EKF fusion of the ICP pose; exact NN via a per-registration
    KD-tree). Runs the FULL bench sequence and returns (scans/s, ATE
    RMSE m), so the relative quality gate compares the same algorithm —
    the earlier const-velocity oracle measured a different policy during
    the speed ramp and its 0.15 m ATE made the gate vacuous."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    from oracle_kiss import OracleLio
    from ptudes_tpu.models import sim
    from ptudes_tpu.ops import projection
    from ptudes_tpu.utils.metrics import calc_ate_rmse
    import jax.numpy as jnp

    n = len(scans)
    sensor = sim.make_sim_sensor(h=H, w=W, fov_deg=90.0)
    imu = sim.imu_for_circle(imu_ts, radius=RADIUS, speed=SPEED, ramp=RAMP)
    lacc, avel = np.asarray(imu.lacc), np.asarray(imu.avel)
    ok = OracleLio(voxel_size=0.3, max_range=70.0, min_range=1.0,
                   max_iters=30,
                   # the device registration objective (bench_config):
                   # patch-plane loss + guess-anchored motion prior
                   loss="plane", plane_min_quality=0.2, plane_radius=0.6,
                   prior_rot_weight=0.01, prior_trans_weight=0.01)
    pts_list = []
    prev = -np.inf
    for i in range(n):
        pts, mask, ts01 = projection.scan_to_points(
            sensor.lut, jnp.asarray(scans[i]))
        m = np.asarray(mask)
        sel = np.where((imu_ts > prev) & (imu_ts <= scan_ts[i]))[0]
        prev = scan_ts[i]
        pts_list.append((np.asarray(pts, np.float64)[m],
                         np.asarray(ts01, np.float64)[m],
                         lacc[sel], avel[sel], imu_ts[sel]))
    t0 = time.monotonic()
    for p, t01, la, av, it in pts_list:
        ok.process(p, t01, la, av, it)
    dt = time.monotonic() - t0
    _, ate_rmse = calc_ate_rmse(np.asarray(ok.poses), gt_mid)
    return n / dt, float(ate_rmse)


def bench_replicas(scans, scan_ts, imu_ts, counts=(2, 4)):
    """Single-device aggregate throughput with N replicas through the
    REPLICA-FUSED batched driver (parallel/batched.py): all replica maps
    live in ONE flat hash table (disjoint slot ranges, replica id folded
    into the slot base), so the insert runs as plain unbatched scatters
    over the union of the replicas' new points. Across devices,
    sequences scale via the 'bag' mesh axis (parallel/replay.py)."""
    import jax
    from ptudes_tpu.models import lio, sim
    from ptudes_tpu.parallel import batched, replay

    sensor = sim.make_sim_sensor(h=H, w=W, fov_deg=90.0)
    imu = sim.imu_for_circle(imu_ts, radius=RADIUS, speed=SPEED, ramp=RAMP)
    cfg = bench_config()
    base = lio.build_batches(
        cfg, scans, scan_ts, np.asarray(imu.lacc), np.asarray(imu.avel),
        imu_ts)
    out_rows = {}
    for r in counts:
        states = replay.stack_bags([lio.init_state(cfg) for _ in range(r)])
        batches = replay.stack_bags([base] * r)
        fin, out = batched.run_sequence_batched(
            states, batches, sensor.lut, cfg=cfg)
        jax.block_until_ready(out.kiss_pose)
        t0 = time.monotonic()
        fin, out = batched.run_sequence_batched(
            states, batches, sensor.lut, cfg=cfg)
        jax.block_until_ready(out.kiss_pose)
        dt = time.monotonic() - t0
        out_rows[f"x{r}"] = round(r * N_SCANS / dt, 1)
    return out_rows


def main():
    from ptudes_tpu.utils.device import card_name_and_power, require_gpu

    verbose = os.environ.get("PTUDES_BENCH_VERBOSE")
    t00 = time.monotonic()
    device = require_gpu()
    device["card"] = card_name_and_power()

    def note(msg):
        if verbose:
            print(f"[bench +{time.monotonic() - t00:.0f}s] {msg}",
                  flush=True)

    scans, scan_ts, gt_mid, imu_ts = make_data()
    note("data ready")
    dev = bench_device(scans, scan_ts, gt_mid, imu_ts)
    note(f"device done: {dev['scans_per_sec']:.1f} scans/s")
    cpu_scans_per_sec, cpu_ate = bench_cpu_oracle(
        scans, scan_ts, gt_mid, imu_ts)
    note(f"oracle done: {cpu_scans_per_sec:.2f} scans/s ate {cpu_ate:.4f}")
    replicas = bench_replicas(scans, scan_ts, imu_ts)
    note("replicas done")
    result = {
        "metric": "lio_scans_per_sec_per_device",
        "value": round(dev["scans_per_sec"], 3),
        "unit": "scans/s (128x1024, ICP+EKF fused step)",
        "vs_baseline": round(dev["scans_per_sec"] / cpu_scans_per_sec, 3),
        "baseline": {
            "what": "policy-identical f64 numpy LIO oracle on host CPU "
                    "(ES-EKF predict per IMU block, EKF-twist deskew, EKF "
                    "guess, EKF fusion of the ICP pose; per-registration "
                    "KD-tree exact NN), full 50-scan sequence (kiss-icp "
                    "C++ not available)",
            "cpu_scans_per_sec": round(cpu_scans_per_sec, 3),
            "cpu_ate_rmse_m": round(cpu_ate, 4),
        },
        # two quality gates, recorded separately: the oracle's ATE makes
        # the relative gate loose, so an ABSOLUTE ceiling is the binding
        # one
        "quality": {
            "ate_rmse_m": round(dev["ate_rmse_m"], 4),
            "vs_oracle_ate": round(dev["ate_rmse_m"] / max(cpu_ate, 1e-9),
                                   3),
            "gate_rel": "device ATE <= 1.05x oracle ATE",
            "gate_rel_pass": bool(dev["ate_rmse_m"] <= 1.05 * cpu_ate),
            "gate_abs": "device ATE RMSE <= 0.02 m",
            "gate_abs_pass": bool(dev["ate_rmse_m"] <= 0.02),
            "gate_pass": bool(dev["ate_rmse_m"] <= 1.05 * cpu_ate
                              and dev["ate_rmse_m"] <= 0.02),
        },
        "replica_aggregate_scans_per_sec": replicas,
        "compile_s": round(dev["compile_s"], 1),
        "device": device,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
