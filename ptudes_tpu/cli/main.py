"""ptudes-tpu CLI — mirrors the reference's command surface
(``ptudes flyby|viz|stat|ekf-bench {sim,nc,ouster,sweep,cmp}``,
``src/ptudes/cli/run.py:17-22`` and ``src/ptudes/cli/ekf_bench.py:763-766``)
on the fused on-device pipeline. Built on the standard library's
``argparse``; :func:`main` takes an argv list so the commands can run
in-process.

3D OpenGL viewing is out of scope (SURVEY.md L6): ``flyby`` and ``viz``
produce PLY maps / camera programs / matplotlib figures instead.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .. import GRAV
from ..config import Capacity, EkfConfig, KissConfig, PipelineConfig

DOWN = np.array([0.0, 0.0, -1.0])
UP = np.array([0.0, 0.0, 1.0])


class CliError(Exception):
    """A user-facing error: printed as ``Error: ...``, exit code 1."""


# ---------------------------------------------------------------- sources

def _load_source(file, meta, keep_fields=False):
    from ..io.metadata import read_metadata_json, resolve_metadata
    from ..io.sources import read_packet_source

    meta_path = resolve_metadata(file, meta)
    if not meta_path:
        raise CliError(
            "Metadata not found; specify with -m/--meta")
    info = read_metadata_json(meta_path)
    scans, imu = read_packet_source(file, info, keep_fields=keep_fields)
    return info, scans, imu, meta_path


def _nav_frame_lut(info, cap_h=None):
    """LUT projecting into the IMU/nav frame (the reference's extrinsics
    trick, ``src/ptudes/cli/ekf_bench.py:440-447``)."""
    from ..ops.projection import make_xyz_lut

    imu_to_sensor = info.imu_to_sensor_transform.copy()
    imu_to_sensor[:3, 3] /= 1000.0
    sensor_to_imu = np.linalg.inv(imu_to_sensor)
    return make_xyz_lut(
        info.w, info.h,
        info.beam_altitude_angles, info.beam_azimuth_angles,
        info.lidar_origin_to_beam_origin_mm,
        info.lidar_to_sensor_transform,
        extrinsic=sensor_to_imu,
    )


# ------------------------------------------------------------------- stat

def cmd_stat(file, meta, duration, beams, kiss_run, start_scan, end_scan):
    """Stream statistics: range/IMU mean/std + gravity estimate
    (reference ``ptudes stat``, ``src/ptudes/cli/stat.py``)."""
    from ..utils.stats import sequence_stats

    info, scans, imu, _ = _load_source(file, meta)
    sel_s = np.ones(len(scans.ts), bool)
    sel_i = np.ones(len(imu.ts), bool)
    if (start_scan > 0 or end_scan is not None) and len(scans.ts):
        # scan-index windowing (reference withScanIdx start/end): IMU
        # samples restrict to the selected scans' time span — the samples
        # the reference's packet iterator would interleave with them
        idx = np.arange(len(scans.ts))
        last = len(scans.ts) - 1 if end_scan is None else end_scan
        sel_s &= (idx >= start_scan) & (idx <= last)
        if not sel_s.any():
            raise CliError(
                f"scan window [{start_scan}, {end_scan}] selects no "
                f"scans (recording has {len(scans.ts)})")
        lo = (scans.ts[start_scan - 1] if start_scan > 0 else -np.inf)
        hi = scans.ts[min(last, len(scans.ts) - 1)]
        sel_i &= (imu.ts > lo) & (imu.ts <= hi)
    if duration > 0 and len(scans.ts):
        t0 = min(scans.ts[0] if len(scans.ts) else np.inf,
                 imu.ts[0] if len(imu.ts) else np.inf)
        sel_s &= scans.ts <= t0 + duration
        sel_i &= imu.ts <= t0 + duration
    tracker = sequence_stats(
        scans.range_mm[sel_s], scans.ts[sel_s],
        imu.lacc[sel_i], imu.avel[sel_i], imu.ts[sel_i],
        use_beams_num=beams, range_unit_m=info.range_unit_m())
    print(tracker)
    print("Grav vector est: ", tracker.gravity_estimate)

    if kiss_run and len(scans):
        import jax
        from ..models import lio
        cfg = PipelineConfig(
            kiss=KissConfig(max_range=70.0, min_range=1.0, deskew=True),
            cap=Capacity(max_points=info.h * info.w),
            guess="kiss")
        lut = _nav_frame_lut(info)
        range_m = scans.range_mm[sel_s].astype(np.float32) \
            * info.range_unit_m()
        batches = lio.build_batches(
            cfg, range_m, scans.ts[sel_s], imu.lacc[sel_i],
            imu.avel[sel_i], imu.ts[sel_i])
        state = lio.init_state(cfg)

        t0 = time.monotonic()
        fin, out = lio.run_sequence(state, batches, lut, cfg=cfg)
        jax.block_until_ready(out)
        t_compile_run = time.monotonic() - t0
        t0 = time.monotonic()
        fin, out = lio.run_sequence(state, batches, lut, cfg=cfg)
        jax.block_until_ready(out)
        dt = time.monotonic() - t0
        n = int(np.sum(sel_s)) if not isinstance(sel_s, slice) \
            else len(scans)
        print(f"\nKISS run: {n} scans, {dt:.3f} s steady-state "
              f"({n / max(dt, 1e-9):.1f} scans/s; "
              f"compile {t_compile_run - dt:.1f} s)")


def _run_online(cfg, lut, state, range_m, scans, imu, origin, prev_scan_ts,
                rate):
    """Scan-by-scan streaming replay via LioOnline with per-scan latency
    percentiles (VERDICT r1: measured latency distribution instead of the
    uninstrumented '~5 ms' claim; rate pacing mirrors the reference's
    real-time bag replay, src/ptudes/bag.py:63-75)."""
    import jax
    import jax.numpy as jnp
    from ..models import lio
    from ..models.online import LioOnline

    odo = LioOnline(cfg, lut, state=state, time_origin=origin,
                    prev_scan_ts=prev_scan_ts)
    events = sorted(
        [(float(t), "imu", i) for i, t in enumerate(imu.ts)]
        + [(float(t), "scan", i) for i, t in enumerate(scans.ts)])
    lats = []
    outs = []
    wall0 = time.monotonic()
    ts0 = events[0][0] if events else 0.0
    for t, kind, i in events:
        if rate > 0:
            lag = (t - ts0) / rate - (time.monotonic() - wall0)
            if lag > 0:
                time.sleep(lag)
        if kind == "imu":
            odo.push_imu(imu.lacc[i], imu.avel[i], t)
        else:
            t0 = time.monotonic()
            out = odo.push_scan(range_m[i], t)
            jax.block_until_ready(out)  # true latency
            lats.append(time.monotonic() - t0)
            outs.append(out)
    lat = np.asarray(lats[1:]) * 1e3  # scan 0 pays compile; report apart
    print(f"\nOnline replay: {len(outs)} scans"
          + (f" paced at {rate:g}x sensor time" if rate > 0 else
             " (unpaced)"))
    if len(lat):
        print(f"  per-scan latency: p50 {np.percentile(lat, 50):.2f} ms, "
              f"p95 {np.percentile(lat, 95):.2f} ms, "
              f"p99 {np.percentile(lat, 99):.2f} ms, "
              f"max {lat.max():.2f} ms "
              f"(first scan incl. compile: {lats[0]:.2f} s)")
    print(f"  dropped IMU samples: {odo.n_dropped_imu}")
    out = jax.tree.map(lambda *x: jnp.stack(x), *outs)
    return odo.state, out


# --------------------------------------------------------------- ekf-bench

def cmd_ekf_sim(duration, freq, corr_t, acc_noise_std, gyr_noise_std, seed,
                plot):
    """EKF with simulated IMU: the noise-free twin's integration is ground
    truth for corrections (reference ``ekf-bench sim``,
    ``src/ptudes/cli/ekf_bench.py:107-179``)."""
    import jax.numpy as jnp
    from ..models import esekf, sim
    from ..utils.metrics import calc_ate, calc_ate_rmse

    n = int(duration * freq)
    ideal, noisy = sim.sim_imu_arrays(
        seed, n, freq=freq, acc_noise_std=acc_noise_std,
        gyr_noise_std=gyr_noise_std)
    cfg = EkfConfig()
    corr_every = max(int(round(corr_t * freq)), 1)
    corr = (jnp.arange(n) % corr_every == 0) & (jnp.arange(n) > 0)

    s_gt, log_gt = esekf.run_filter(
        esekf.init_state(cfg), ideal, jnp.zeros(n, bool),
        jnp.tile(jnp.eye(4), (n, 1, 1)), cfg=cfg)
    from ..geom import so3
    gt_poses = np.tile(np.eye(4), (n, 1, 1))
    gt_poses[:, :3, :3] = np.asarray(so3.quat_to_mat(log_gt.att_q))
    gt_poses[:, :3, 3] = np.asarray(log_gt.pos)

    s, log = esekf.run_filter(
        esekf.init_state(cfg), noisy, corr,
        jnp.asarray(gt_poses, jnp.float32), cfg=cfg)

    upd = np.asarray(log.updated)
    est_poses = np.tile(np.eye(4), (int(upd.sum()), 1, 1))
    est_poses[:, :3, :3] = np.asarray(so3.quat_to_mat(log.att_q))[upd]
    est_poses[:, :3, 3] = np.asarray(log.pos)[upd]
    ate_rot, ate_trans = calc_ate(est_poses, gt_poses[upd])
    rmse_rot, rmse_trans = calc_ate_rmse(est_poses, gt_poses[upd])
    print(f"processed duration: {duration:0.04} s")
    print(f"updates num: {int(upd.sum())}\n")
    print(f"ATE_rot:   {ate_rot:.04f} deg")
    print(f"ATE trans: {ate_trans:.04f} m")
    print(f"ATE RMSE:  {rmse_rot:.04f} deg / {rmse_trans:.04f} m")

    if plot == "graphs":
        from ..viz.graphs import ekf_error_graphs, ekf_graphs
        ekf_graphs(log, imu_lacc=np.asarray(noisy.lacc),
                   imu_avel=np.asarray(noisy.avel))
        ekf_error_graphs(log_gt, log)


def cmd_ekf_nc(file, gt_file, duration, start_ts, imu_topic, plot, xy_plot):
    """IMU-only EKF on Newer College bags, GT poses as corrections
    (reference ``ekf-bench nc``, ``src/ptudes/cli/ekf_bench.py:182-323``)."""
    import jax.numpy as jnp
    from ..geom import so3
    from ..io.poses import read_newer_college_gt
    from ..io.sources import read_imu_bag
    from ..models import esekf
    from ..models.esekf import Imu
    from ..utils.metrics import calc_ate

    init_grav = GRAV * UP
    if imu_topic in ["/os_cloud_node/imu", "/os_node/imu_packets"]:
        init_grav = GRAV * DOWN
    print("init_grav = ", init_grav)

    imu = read_imu_bag(file, imu_topic=imu_topic)
    gts = read_newer_college_gt(gt_file)

    t0 = imu.ts[0] + start_ts
    sel = imu.ts >= t0
    if duration > 0:
        sel &= imu.ts <= t0 + duration
    lacc, avel, ts = imu.lacc[sel], imu.avel[sel], imu.ts[sel]
    n = len(ts)

    # correction schedule: fire at first IMU tick past each GT knot
    gt_t = np.asarray([g[0] for g in gts])
    gt_p = np.asarray([g[1] for g in gts])
    start_knot = int(np.searchsorted(gt_t, ts[0]))
    gt_pose0 = np.linalg.inv(gt_p[min(start_knot, len(gt_p) - 1)])
    corr = np.zeros(n, bool)
    corr_poses = np.tile(np.eye(4), (n, 1, 1))
    ki = start_knot
    for i in range(n):
        if ki < len(gt_t) and ts[i] >= gt_t[ki]:
            corr[i] = True
            corr_poses[i] = gt_pose0 @ gt_p[ki]
            ki += 1

    cfg = EkfConfig()
    imus = Imu(lacc=jnp.asarray(lacc, jnp.float32),
               avel=jnp.asarray(avel, jnp.float32),
               ts=jnp.asarray(ts - ts[0], jnp.float32))
    s, log = esekf.run_filter(
        esekf.init_state(cfg, init_grav=jnp.asarray(init_grav, jnp.float32)),
        imus, jnp.asarray(corr), jnp.asarray(corr_poses, jnp.float32),
        cfg=cfg)

    upd = np.asarray(log.updated)
    print(f"scanned duration: {ts[-1] - ts[0]:0.04} s")
    print(f"updates num: {int(upd.sum())}\n")
    if upd.any():
        est = np.tile(np.eye(4), (int(upd.sum()), 1, 1))
        est[:, :3, :3] = np.asarray(so3.quat_to_mat(log.att_q))[upd]
        est[:, :3, 3] = np.asarray(log.pos)[upd]
        ate_rot, ate_trans = calc_ate(est, corr_poses[upd])
        print(f"ATE_rot:   {ate_rot:.04f} deg")
        print(f"ATE trans: {ate_trans:.04f} m")

    if plot == "graphs":
        from ..viz.graphs import ekf_graphs
        ekf_graphs(log, imu_lacc=lacc, imu_avel=avel, xy_plot=xy_plot,
                   gt=(ts[upd], corr_poses[upd]),
                   labels=["ES EKF IMU + GT pose correction", "GT poses"])


def cmd_ekf_ouster(file, meta, start_scan, end_scan, use_imu_prediction,
                   use_gt_guess, gt_file, kiss_min_range, kiss_max_range,
                   beams, loss, save_kitti_poses, save_nc_gt_poses,
                   save_map_ply, save_debug_scene, debug_scene_stride,
                   save_state, resume_state, frozen_map, online, rate,
                   voxel_size, map_capacity, max_source, max_frame, plot):
    """The flagship LIO loop on Ouster PCAP/BAG: KISS-style ICP odometry +
    ES-EKF smoothing (reference ``ekf-bench ouster``,
    ``src/ptudes/cli/ekf_bench.py:326-666``), fully on device."""
    import jax
    import jax.numpy as jnp
    from ..io.poses import (filter_nc_gt_by_close_ts, read_newer_college_gt,
                            save_poses_kitti_format, save_poses_nc_gt_format)
    from ..models import lio
    from ..ops.projection import reduce_active_beams_mask
    from ..utils.metrics import calc_ate, calc_ate_rmse
    from ..utils.trajectory import poses_for_scans

    if use_gt_guess and not gt_file:
        raise CliError("--use-gt-guess requires --gt-file")
    if frozen_map and not resume_state:
        raise CliError(
            "--frozen-map requires --resume-state (localization needs a "
            "prior map)")

    info, scans, imu, meta_path = _load_source(file, meta)
    scans = scans.window(start_scan, end_scan)
    print(f"data path: {file}")
    print(f"metadata path: {meta_path}\n")
    print(f"scans: {len(scans)}, imus: {len(imu)}")
    print(f"kiss min/max: {kiss_min_range} - {kiss_max_range}")
    print(f"use-imu-prediction: {use_imu_prediction}, "
          f"use-gt-guess: {use_gt_guess}")
    print(f"sensor: {info.prod_line}, {info.mode}, loss: {loss}")

    guess = ("ekf" if use_imu_prediction
             else "gt" if use_gt_guess else "kiss")
    cap_kw = {k: v for k, v in (("map_capacity", map_capacity),
                                ("max_source", max_source),
                                ("max_frame", max_frame)) if v}
    # the scratch dedup tables scale with the raw point count, not the
    # default 128-beam assumption — a custom map size implies the user is
    # right-sizing for a smaller sensor
    if map_capacity:
        cap_kw["dedup_table"] = max(1 << 14, 1 << (
            int(info.h * info.w - 1).bit_length() + 1))
    if max_frame and max_frame < Capacity.max_new_per_scan:
        cap_kw["max_new_per_scan"] = max_frame
    cfg = PipelineConfig(
        kiss=KissConfig(max_range=kiss_max_range, min_range=kiss_min_range,
                        deskew=True, loss=loss, voxel_size=voxel_size),
        cap=Capacity(max_points=info.h * info.w, **cap_kw),
        ekf=EkfConfig(),
        guess=guess,
        map_frozen=frozen_map,
    )
    lut = _nav_frame_lut(info)

    range_m = scans.range_mm.astype(np.float32) * info.range_unit_m()
    if beams:
        keep = reduce_active_beams_mask(info.h, beams)
        range_m = range_m * keep[None, :, None]

    guess_poses = None
    gts = read_newer_college_gt(gt_file) if gt_file else []
    if use_gt_guess:
        gp, gvalid = poses_for_scans(scans.ts, gts, time_bounds=1.0)
        gp0 = np.linalg.inv(gp[gvalid][0]) if gvalid.any() else np.eye(4)
        guess_poses = np.einsum("ij,njk->nik", gp0, gp)

    origin = lio.time_origin(scans.ts, imu.ts)
    state = lio.init_state(cfg)
    prev_scan_ts = None
    if resume_state:
        from ..utils.checkpoint import checkpoint_extra, load_state
        state = load_state(resume_state, state)
        # continue on the checkpoint's clock so the carried EKF timestamp
        # lines up with the new window's rebased times, and window IMU to
        # strictly after the checkpoint's last scan so already-integrated
        # samples are not re-fed (negative-dt backwards mechanization)
        extra = checkpoint_extra(resume_state)
        origin = extra.get("time_origin", origin)
        prev_scan_ts = extra.get("end_scan_ts")
        print(f"resumed pipeline state from {resume_state} "
              f"(time origin {origin:.3f})")
    batches = lio.build_batches(
        cfg, range_m, scans.ts, imu.lacc, imu.avel, imu.ts,
        guess_poses=guess_poses, time_origin=origin,
        prev_scan_ts=prev_scan_ts)

    want_log = plot == "graphs"
    n = len(scans)
    if online:
        fin, out = _run_online(cfg, lut, state, range_m, scans, imu,
                               origin, prev_scan_ts, rate)
    else:
        t0 = time.monotonic()
        fin, out = lio.run_sequence(state, batches, lut, cfg=cfg,
                                    log=want_log)
        jax.block_until_ready(out)
        t_first = time.monotonic() - t0
        t0 = time.monotonic()
        fin, out = lio.run_sequence(state, batches, lut, cfg=cfg,
                                    log=want_log)
        jax.block_until_ready(out)
        t_steady = time.monotonic() - t0
        # per-run timing report (reference prints per-stage means,
        # ekf_bench.py:590-595; in the fused on-device pipeline the stages
        # are one compiled program, so the split is compile vs steady-state)
        print(f"\nTimings: {t_first:.3f} s first run "
              f"(compile {t_first - t_steady:.1f} s), "
              f"{t_steady:.3f} s steady-state")
        print(f"  per scan: {t_steady / max(n, 1) * 1e3:.2f} ms "
              f"({n / max(t_steady, 1e-9):.1f} scans/s)", end="")
    iters = np.asarray(out.aux.iterations)
    print(f"; ICP iterations mean {iters.mean():.1f} max {iters.max()}")

    res_poses = np.asarray(out.ekf_pose, np.float64)
    kiss_poses = np.asarray(out.kiss_pose, np.float64)
    res_t = scans.ts

    header = (f"ptudes-tpu ekf-bench ouster {file}\n"
              f"scans: {n}, loss: {loss}, guess: {guess}")
    if save_kitti_poses:
        save_poses_kitti_format(save_kitti_poses, res_poses, header=header)
        print(f"Kitti poses saved to: {save_kitti_poses}")
    if save_nc_gt_poses:
        save_poses_nc_gt_format(save_nc_gt_poses, res_t, res_poses,
                                header=header)
        print(f"NC GT poses saved to: {save_nc_gt_poses}")
    if save_map_ply:
        from ..viz.cloud import map_to_points, save_ply
        save_ply(save_map_ply, map_to_points(
            fin.kiss.local_map, cfg.kiss.resolved_voxel_size))
        print(f"Local map saved to: {save_map_ply}")
    if save_state:
        from ..utils.checkpoint import save_state as _save_state
        _save_state(save_state, fin,
                    extra={"file": str(file), "scans": int(n),
                           "end_scan_ts": float(res_t[-1]),
                           "time_origin": float(origin)})
        print(f"Pipeline state checkpoint saved to: {save_state}")
    if save_debug_scene:
        from ..viz.debug_scene import export_debug_scenes
        idx = export_debug_scenes(save_debug_scene, cfg, lut, batches,
                                  stride=debug_scene_stride)
        print(f"Debug scenes ({len(idx['knots'])} knots) saved to: "
              f"{save_debug_scene}")

    if gts:
        gts_m, res_t_m = filter_nc_gt_by_close_ts(gts, list(res_t))
        if gts_m:
            idx = np.searchsorted(res_t, res_t_m)
            gt2 = np.asarray([g[1] for g in gts_m])
            for name, poses_arr in [("ES EKF smoothing", res_poses[idx]),
                                    ("no-EKF, only KissICP",
                                     kiss_poses[idx])]:
                ate_rot, ate_trans = calc_ate(poses_arr, gt2)
                rr, rt = calc_ate_rmse(poses_arr, gt2)
                print(f"\nGround truth comparison ({name}, "
                      f"{len(gt2)} poses):")
                print(f"ATE_rot:   {ate_rot:.04f} deg")
                print(f"ATE trans: {ate_trans:.04f} m")
                print(f"ATE RMSE:  {rr:.04f} deg / {rt:.04f} m")

    if plot == "graphs" and out.flog is not None:
        # full reference figure set for the flagship mode
        # (src/ptudes/cli/ekf_bench.py:640-659): IMU-rate EKF diagnostic
        # grid with kiss-only + GT trajectory overlays, then the
        # innovation/adaptive-sigma traces
        from ..viz.graphs import ekf_graphs, kiss_innovation_graph
        flog = lio.flatten_filter_log(out.flog, batches.imu_valid)
        iv = np.asarray(batches.imu_valid).reshape(-1)
        lacc = np.asarray(batches.imu.lacc).reshape(-1, 3)[iv]
        avel = np.asarray(batches.imu.avel).reshape(-1, 3)[iv]
        rel_scan_t = np.asarray(batches.scan_ts)
        gt2 = None
        if gts:
            gts_m, res_t_m = filter_nc_gt_by_close_ts(gts, list(res_t))
            if gts_m:
                gt2 = (np.asarray(res_t_m) - res_t[0] + rel_scan_t[0],
                       np.asarray([g[1] for g in gts_m]))
        ekf_graphs(flog, imu_lacc=lacc, imu_avel=avel,
                   gt=(rel_scan_t, kiss_poses), gt2=gt2, xy_plot=True,
                   labels=["ES EKF KissICP smoothed poses",
                           "KissICP only poses", "GT poses"])
        kiss_innovation_graph(res_t, np.asarray(out.aux.err_dt),
                              np.asarray(out.aux.err_drot),
                              np.asarray(out.aux.sigma))
    elif plot == "graphs":  # online mode has no IMU-rate log
        from ..viz.graphs import kiss_innovation_graph
        kiss_innovation_graph(res_t, np.asarray(out.aux.err_dt),
                              np.asarray(out.aux.err_drot),
                              np.asarray(out.aux.sigma))


def cmd_ekf_sweep(file, meta, start_scan, end_scan, gt_file, kiss_min_range,
                  kiss_max_range, loss, beams, bacc_z, replicas):
    """Batched multi-variant LIO replay: run B pipeline variants of one
    recording IN PARALLEL as a single vmapped program, sharded over the
    'bag' mesh axis when more than one device is available.

    The reference runs one configuration per process; here beam-count
    degradation studies (``--beams``) and EKF initial-bias hypothesis
    sweeps (``--bacc-z``) execute concurrently on the devices — the
    embarrassingly-parallel axis this design adds (SURVEY.md 2c).
    """
    import jax
    from ..io.poses import filter_nc_gt_by_close_ts, read_newer_college_gt
    from ..models import lio
    from ..ops.projection import reduce_active_beams_mask
    from ..parallel import mesh as mesh_lib
    from ..parallel import replay
    from ..utils.metrics import calc_ate_rmse

    chosen = [o for o in (beams, bacc_z, replicas) if o]
    if len(chosen) != 1:
        raise CliError(
            "pick exactly one of --beams / --bacc-z / --replicas")

    info, scans, imu, meta_path = _load_source(file, meta)
    scans = scans.window(start_scan, end_scan)
    cfg = PipelineConfig(
        kiss=KissConfig(max_range=kiss_max_range, min_range=kiss_min_range,
                        deskew=True, loss=loss),
        cap=Capacity(max_points=info.h * info.w),
        ekf=EkfConfig(),
        guess="ekf",
    )
    lut = _nav_frame_lut(info)
    range_m = scans.range_mm.astype(np.float32) * info.range_unit_m()

    variants, batch_list, state_list = [], [], []
    if beams:
        for b in [int(x) for x in beams.split(",")]:
            keep = reduce_active_beams_mask(info.h, b)
            batch_list.append(lio.build_batches(
                cfg, range_m * keep[None, :, None], scans.ts,
                imu.lacc, imu.avel, imu.ts))
            state_list.append(lio.init_state(cfg))
            variants.append(f"beams={b}")
    elif bacc_z:
        base = lio.build_batches(cfg, range_m, scans.ts, imu.lacc,
                                 imu.avel, imu.ts)
        for v in [float(x) for x in bacc_z.split(",")]:
            batch_list.append(base)
            state_list.append(lio.init_state(
                cfg, init_bacc=np.asarray([0.0, 0.0, v], np.float32)))
            variants.append(f"bacc_z={v:+.3f}")
    else:
        base = lio.build_batches(cfg, range_m, scans.ts, imu.lacc,
                                 imu.avel, imu.ts)
        for r in range(int(replicas)):
            batch_list.append(base)
            state_list.append(lio.init_state(cfg))
            variants.append(f"replica {r}")

    nb = len(variants)
    states = replay.stack_bags(state_list)
    batches = replay.stack_bags(batch_list)
    ndev = len(jax.devices())
    m = mesh_lib.make_mesh(n_bags=nb) if (ndev >= nb and nb > 1
                                          and ndev % nb == 0) else None
    print(f"variants: {nb}, devices: {ndev}, "
          f"mesh: {dict(m.shape) if m else 'single-device vmap'}")

    t0 = time.monotonic()
    fin, out = replay.replay_bags(states, batches, lut, cfg, mesh=m)
    jax.block_until_ready(out)
    t_first = time.monotonic() - t0
    t0 = time.monotonic()
    fin, out = replay.replay_bags(states, batches, lut, cfg, mesh=m)
    jax.block_until_ready(out)
    t_steady = time.monotonic() - t0
    n = len(scans)
    print(f"{nb} x {n} scans in {t_steady:.3f} s steady-state "
          f"({nb * n / max(t_steady, 1e-9):.1f} scans/s aggregate; "
          f"compile {t_first - t_steady:.1f} s)\n")

    gts = read_newer_college_gt(gt_file) if gt_file else []
    ekf_poses = np.asarray(out.ekf_pose, np.float64)
    kiss_poses = np.asarray(out.kiss_pose, np.float64)
    print(f"{'variant':>16s}  {'drift[m]':>9s}"
          + ("  ate_rmse[m]  kiss_rmse[m]" if gts else ""))
    gt2 = idx = None
    if gts:
        gts_m, res_t_m = filter_nc_gt_by_close_ts(gts, list(scans.ts))
        if gts_m:
            idx = np.searchsorted(scans.ts, res_t_m)
            gt2 = np.asarray([g[1] for g in gts_m])
    for b in range(nb):
        drift = float(np.linalg.norm(
            ekf_poses[b, -1, :3, 3] - ekf_poses[b, 0, :3, 3]))
        line = f"{variants[b]:>16s}  {drift:9.3f}"
        if gt2 is not None:
            _, rt = calc_ate_rmse(ekf_poses[b, idx], gt2)
            _, rtk = calc_ate_rmse(kiss_poses[b, idx], gt2)
            line += f"  {rt:11.4f}  {rtk:12.4f}"
        print(line)


def cmd_ekf_cmp(gt_file, gt_file_cmp, plot, use_gt_frame, xy_plot):
    """Compare trajectories in Newer College format (reference
    ``ekf-bench cmp``, ``src/ptudes/cli/ekf_bench.py:669-760``)."""
    import os
    from ..io.poses import filter_nc_gt_by_cmp, read_newer_college_gt
    from ..utils.metrics import calc_ate

    gts_all = read_newer_college_gt(gt_file)
    gts_cmp_all = [read_newer_college_gt(f) for f in gt_file_cmp]

    gts, gts_cmp = [], []
    for gc in gts_cmp_all:
        a, b = filter_nc_gt_by_cmp(gts_all, gc)
        gts.append(a)
        gts_cmp.append(b)

    fname = lambda f: os.path.splitext(os.path.basename(f))[0]  # noqa: E731
    for idx, cmp_file in enumerate(gt_file_cmp):
        a = np.asarray([p for _, p in gts[idx]])
        b = np.asarray([p for _, p in gts_cmp[idx]])
        ate_rot, ate_trans = calc_ate(a, b)
        print(f"\nTraj poses comparisons GT v. {fname(cmp_file)} "
              f"({len(a)} poses):")
        print(f"ATE_rot:   {ate_rot:.04f} deg")
        print(f"ATE trans: {ate_trans:.04f} m")

    if plot in ("graphs", "graphs_full"):
        from ..viz.graphs import gt_poses_graphs
        sets = [gts_all if plot == "graphs_full" else
                (gts[0] if gts else gts_all)]
        for idx in range(len(gts_cmp)):
            aligned = gts_cmp[idx]
            if use_gt_frame and gts[idx]:
                p0 = gts[idx][0][1] @ np.linalg.inv(gts_cmp[idx][0][1])
                aligned = [(t, p0 @ p) for t, p in gts_cmp[idx]]
            sets.append(aligned)
        gt_poses_graphs(
            sets, xy_plot=xy_plot,
            labels=[f"GT Poses: {fname(gt_file)}"]
            + [f"Cmp poses {i+1}: {fname(f)}"
               for i, f in enumerate(gt_file_cmp)])


# ------------------------------------------------------------------ flyby

def cmd_flyby(file, meta, kitti_poses, nc_gt_poses, start_scan, end_scan,
              out_ply, camera_json, map_points):
    """Build the registered map + cinematic camera program (reference
    ``ptudes flyby``, ``src/ptudes/cli/flyby.py``; rendering is delegated
    to external viewers via PLY + camera JSON)."""
    import jax.numpy as jnp
    from ..io.poses import load_poses_kitti_format, read_newer_college_gt
    from ..ops.projection import scan_to_points
    from ..utils.trajectory import poses_for_scans
    from ..viz.cloud import AccumCloud, save_ply
    from ..viz.fly import Flyby

    info, scans, imu, _ = _load_source(file, meta)
    scans = scans.window(start_scan, end_scan)
    lut = _nav_frame_lut(info)
    range_unit = info.range_unit_m()

    if kitti_poses:
        poses = load_poses_kitti_format(kitti_poses)[:len(scans)]
        valid = np.ones(len(poses), bool)
    elif nc_gt_poses:
        gts = read_newer_college_gt(nc_gt_poses)
        gp0 = np.linalg.inv(gts[0][1])
        gts = [(t, gp0 @ p) for t, p in gts]  # origin shift (flyby.py:96-100)
        poses, valid = poses_for_scans(scans.ts, gts, time_bounds=1.5)
    else:
        raise CliError(
            "Provide --kitti-poses or --nc-gt-poses (or run ekf-bench "
            "ouster --save-kitti-poses first)")

    cloud = AccumCloud(max_points=map_points)
    for i in range(len(scans)):
        if not valid[i]:
            continue
        pts, mask, _ = scan_to_points(
            lut, jnp.asarray(scans.range_mm[i].astype(np.float32)
                             * range_unit))
        p = np.asarray(pts)[np.asarray(mask)]
        pw = p @ poses[i][:3, :3].T + poses[i][:3, 3]
        cloud.add(pw[::4])
    save_ply(out_ply, cloud.points)
    print(f"map: {len(cloud)} points -> {out_ply}")

    traj = [(scans.ts[i], poses[i]) for i in range(len(scans)) if valid[i]]
    bbox = np.stack([cloud.points.min(0), cloud.points.max(0)], axis=1)
    fly = Flyby(traj=traj, bbox=bbox)
    print(f"flyby duration: {fly.total_duration:.1f} s")
    if camera_json:
        import json
        prog = []
        for t in np.arange(0, fly.total_duration, 1 / 30):
            cam = fly.camera_at(float(t))
            prog.append({"t": float(t), "target": cam.target.tolist(),
                         "pitch": cam.pitch, "yaw": cam.yaw,
                         "dolly": cam.dolly})
        with open(camera_json, "w") as f:
            json.dump(prog, f)
        print(f"camera program ({len(prog)} keyframes) -> {camera_json}")


# -------------------------------------------------------------------- viz

def cmd_viz(file, meta, scan_idx, out_png, out_dir, stride, field_name,
            serve, stream_dir, port, rate, max_scans):
    """Raw scan viewer: live WebGL playback (--serve / --stream-dir),
    or destaggered channel images as matplotlib figures — one scan
    (--out-png/interactive) or the whole stream (--out-dir)
    (reference ``ptudes viz`` plays live in the OpenGL SimpleViz,
    ``src/ptudes/cli/viz.py``)."""
    if serve or stream_dir:
        from ..viz.stream_player import export_stream, serve_dir

        info, scans, imu, _ = _load_source(file, meta, keep_fields=True)
        if not len(scans):
            raise CliError("no scans decoded")
        if max_scans is not None and len(scans) > max_scans:
            print(f"exporting first {max_scans} of {len(scans)} scans "
                  "(--max-scans)")
            scans = scans.window(0, max_scans - 1)  # end inclusive
        d = stream_dir or (os.path.splitext(str(file))[0] + "_stream")
        out = export_stream(d, info, scans, rate=rate)
        print(f"player -> {out}")
        if serve:
            serve_dir(d, port)
        return

    import jax.numpy as jnp
    import matplotlib
    if out_png or out_dir:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ..ops.projection import destagger

    info, scans, imu, _ = _load_source(file, meta,
                                       keep_fields=field_name != "range")
    print(f"scans: {len(scans)}, imus: {len(imu)}, "
          f"sensor: {info.prod_line} {info.mode}")
    if not len(scans):
        return
    if field_name == "range":
        channel, unit, cmap = scans.range_mm, "range (mm)", "viridis"
    else:
        if field_name not in (scans.fields or {}):
            raise CliError(
                f"field '{field_name}' not in this recording's profile "
                f"(has: range, {', '.join(sorted(scans.fields or {}))})")
        channel, unit, cmap = scans.fields[field_name], field_name, "gray"
        if field_name == "range2":
            unit, cmap = "range2 (mm)", "viridis"
    shifts = jnp.asarray(np.asarray(info.pixel_shift_by_row))

    def render(i, path=None):
        img = destagger(
            jnp.asarray(channel[i].astype(np.float32)), shifts)
        plt.figure(figsize=(16, 4))
        plt.imshow(np.asarray(img), cmap=cmap, aspect="auto")
        plt.colorbar(label=unit)
        plt.title(f"scan {i} [{field_name}]  t={scans.ts[i]:.3f}s")
        if path:
            plt.savefig(path, dpi=120, bbox_inches="tight")
            plt.close()
        else:
            plt.show()

    if out_dir:
        import os
        os.makedirs(out_dir, exist_ok=True)
        idxs = range(0, len(scans), max(stride, 1))
        for i in idxs:
            render(i, os.path.join(out_dir, f"scan_{i:05d}.png"))
        print(f"exported {len(list(idxs))} frames to {out_dir}")
    elif out_png:
        render(scan_idx, out_png)
        print(f"saved {out_png}")
    else:
        render(scan_idx)


# ----------------------------------------------------------------- parser

def _existing_path(p: str) -> str:
    if not os.path.exists(p):
        raise argparse.ArgumentTypeError(f"Path '{p}' does not exist.")
    return p


def _add(parser, *flags, **kw):
    """``add_argument`` with click's defaults: options default to None,
    ``exists=True`` checks the path, ``flag=True`` is a store_true."""
    if kw.pop("exists", False):
        kw["type"] = _existing_path
    if kw.pop("flag", False):
        kw["action"] = "store_true"
    parser.add_argument(*flags, **kw)


def _source_args(p, meta=True):
    _add(p, "file", exists=True)
    if meta:
        _add(p, "-m", "--meta", exists=True, default=None)


def build_parser() -> argparse.ArgumentParser:
    """The ``ptudes-tpu`` command tree; every leaf sets ``func``."""
    root = argparse.ArgumentParser(
        prog="ptudes-tpu",
        description="P(oint)(e)tudes: lidar odometry, SLAM and mapping "
                    "tools.")
    sub = root.add_subparsers(dest="command", metavar="COMMAND")

    p = sub.add_parser("stat", help=cmd_stat.__doc__.split("\n")[0],
                       description=cmd_stat.__doc__)
    p.set_defaults(func=cmd_stat)
    _source_args(p)
    _add(p, "-t", "--duration", type=float, default=0.0,
         help="Only stat the first DURATION seconds")
    _add(p, "--beams", type=int, default=32,
         help="Beam subsample for range stats (default 32)")
    _add(p, "--kiss-run", flag=True,
         help="Also run vanilla KISS odometry for time profiling "
              "(reference stat --kiss-run, src/ptudes/cli/stat.py:42-44)")
    _add(p, "--start-scan", type=int, default=0,
         help="Start scan index (reference stat --start-scan, "
              "src/ptudes/cli/stat.py:29)")
    _add(p, "--end-scan", type=int, default=None,
         help="End scan index, inclusive (reference stat --end-scan, "
              "src/ptudes/cli/stat.py:30)")

    eb = sub.add_parser("ekf-bench",
                        help="ES EKF benchmarks and experiments.")
    ebs = eb.add_subparsers(dest="ekf_command", metavar="COMMAND")

    p = ebs.add_parser("sim", description=cmd_ekf_sim.__doc__)
    p.set_defaults(func=cmd_ekf_sim)
    _add(p, "-t", "--duration", type=float, default=2.0)
    _add(p, "-f", "--freq", type=float, default=100.0)
    _add(p, "--corr-t", type=float, default=0.1,
         help="Pose correction interval (s)")
    _add(p, "--acc-noise-std", type=float, default=0.4)
    _add(p, "--gyr-noise-std", type=float, default=0.4)
    _add(p, "--seed", type=int, default=42)
    _add(p, "-p", "--plot", type=str, default=None, help="[graphs]")

    p = ebs.add_parser("nc", description=cmd_ekf_nc.__doc__)
    p.set_defaults(func=cmd_ekf_nc)
    _source_args(p, meta=False)
    _add(p, "-g", "--gt-file", required=True, exists=True)
    _add(p, "-t", "--duration", type=float, default=0.0)
    _add(p, "--start-ts", type=float, default=0.0)
    _add(p, "-i", "--imu-topic", default="/os_node/imu_packets")
    _add(p, "-p", "--plot", type=str, default=None)
    _add(p, "--xy-plot", flag=True)

    p = ebs.add_parser("ouster", description=cmd_ekf_ouster.__doc__)
    p.set_defaults(func=cmd_ekf_ouster)
    _source_args(p)
    _add(p, "--start-scan", type=int, default=0)
    _add(p, "--end-scan", type=int, default=None)
    _add(p, "--use-imu-prediction", flag=True,
         help="EKF pose prediction as the ICP guess (loosely coupled LIO)")
    _add(p, "--use-gt-guess", flag=True,
         help="GT pose as ICP guess (sanity testing)")
    _add(p, "-g", "--gt-file", exists=True, default=None)
    _add(p, "--kiss-min-range", type=float, default=1.0)
    _add(p, "--kiss-max-range", type=float, default=70.0)
    _add(p, "--beams", type=int, default=0)
    _add(p, "--loss", choices=["plane", "point"], default="plane")
    _add(p, "--save-kitti-poses", default=None)
    _add(p, "--save-nc-gt-poses", default=None)
    _add(p, "--save-map-ply", default=None,
         help="Export the final local map as PLY")
    _add(p, "--save-debug-scene", default=None,
         help="Export per-update EKF debug scenes (PLY+JSON) to DIR "
              "(replaces the reference's 3D ekf_viz debug viewer)")
    _add(p, "--debug-scene-stride", type=int, default=5)
    _add(p, "--save-state", default=None,
         help="Checkpoint the final pipeline state (voxel map + EKF + "
              "covariance) to FILE.npz; resume with --resume-state")
    _add(p, "--resume-state", exists=True, default=None,
         help="Start from a state checkpoint instead of a fresh state "
              "(continue a windowed run bit-exact)")
    _add(p, "--frozen-map", flag=True,
         help="Localization-only mode (beyond the reference): register "
              "against the resumed checkpoint's map WITHOUT modifying it "
              "— no inserts, no eviction. Requires --resume-state (a "
              "fresh empty map cannot localize)")
    _add(p, "--online", flag=True,
         help="Drive the streaming LioOnline scan-by-scan (live-"
              "deployment rehearsal): one compiled step per scan, "
              "per-scan latency p50/p95/p99 printed")
    _add(p, "--rate", type=float, default=0.0,
         help="With --online: replay pacing, 1.0 = sensor real time "
              "(reference OusterRawBagSource rate replay, "
              "src/ptudes/bag.py:63-75); 0 = as fast as possible")
    _add(p, "--voxel-size", type=float, default=None,
         help="Map voxel size in meters (default max_range/100, kiss "
              "parity)")
    _add(p, "--map-capacity", type=int, default=None,
         help="Voxel hash slots (power of two; default 2^19). Size to "
              "the sensor/scene — smaller tables compile and run faster "
              "at low beam counts")
    _add(p, "--max-source", type=int, default=None,
         help="ICP source point capacity (default 8192)")
    _add(p, "--max-frame", type=int, default=None,
         help="Downsampled frame (map insert) capacity (default 32768)")
    _add(p, "-p", "--plot", type=str, default=None)

    p = ebs.add_parser("sweep", description=cmd_ekf_sweep.__doc__)
    p.set_defaults(func=cmd_ekf_sweep)
    _source_args(p)
    _add(p, "--start-scan", type=int, default=0)
    _add(p, "--end-scan", type=int, default=None)
    _add(p, "-g", "--gt-file", exists=True, default=None)
    _add(p, "--kiss-min-range", type=float, default=1.0)
    _add(p, "--kiss-max-range", type=float, default=70.0)
    _add(p, "--loss", choices=["plane", "point"], default="plane")
    _add(p, "--beams", default=None,
         help="Comma list of active-beam counts, one LIO variant per "
              "entry (low-res sensor simulation), e.g. 128,64,32,16")
    _add(p, "--bacc-z", default=None,
         help="Comma list of initial accel-bias-z hypotheses (m/s^2), "
              "one EKF variant per entry, e.g. -0.2,-0.1,0,0.1,0.2")
    _add(p, "--replicas", type=int, default=None,
         help="No parameter sweep: run N identical replicas "
              "(data-parallel throughput check)")

    p = ebs.add_parser("cmp", description=cmd_ekf_cmp.__doc__)
    p.set_defaults(func=cmd_ekf_cmp)
    _add(p, "gt_file", exists=True)
    _add(p, "gt_file_cmp", nargs="*", type=_existing_path)
    _add(p, "-p", "--plot", type=str, default=None)
    _add(p, "--use-gt-frame", flag=True)
    _add(p, "--xy-plot", flag=True)

    p = sub.add_parser("flyby", help=cmd_flyby.__doc__.split("\n")[0],
                       description=cmd_flyby.__doc__)
    p.set_defaults(func=cmd_flyby)
    _source_args(p)
    _add(p, "--kitti-poses", exists=True, default=None)
    _add(p, "--nc-gt-poses", exists=True, default=None)
    _add(p, "--start-scan", type=int, default=0)
    _add(p, "--end-scan", type=int, default=None)
    _add(p, "-o", "--out-ply", default="flyby_map.ply")
    _add(p, "--camera-json", default=None,
         help="Export the flyby camera program as JSON")
    _add(p, "--map-points", type=int, default=1_500_000)

    p = sub.add_parser("viz", help=cmd_viz.__doc__.split("\n")[0],
                       description=cmd_viz.__doc__)
    p.set_defaults(func=cmd_viz)
    _source_args(p)
    _add(p, "--scan", dest="scan_idx", type=int, default=0)
    _add(p, "-o", "--out-png", default=None)
    _add(p, "--out-dir", default=None,
         help="Export the WHOLE stream as PNG frames (playback export; "
              "the reference plays it live in SimpleViz, "
              "src/ptudes/cli/viz.py:49-62)")
    _add(p, "--stride", type=int, default=1,
         help="Export every Nth scan with --out-dir")
    _add(p, "--field", dest="field_name", default="range",
         choices=["range", "reflectivity", "signal", "nearir", "range2",
                  "reflectivity2", "signal2"],
         help="Channel to render (reference SimpleViz cycles LidarScan "
              "fields; dual-return *2 channels need a DUAL/FUSA profile "
              "recording)")
    _add(p, "--serve", flag=True,
         help="LIVE playback: export the stream and serve the inline-"
              "WebGL player (channel strip + 3D cloud at sensor rate, "
              "pause/rate/scrub keys — the reference's SimpleViz "
              "experience, src/ptudes/cli/viz.py:49-62)")
    _add(p, "--stream-dir", default=None,
         help="Export the WebGL player + stream blobs here without "
              "serving")
    _add(p, "--port", type=int, default=8126, help="--serve port")
    _add(p, "-r", "--rate", type=float, default=1.0,
         help="Initial playback rate for --serve/--stream-dir; 0 starts "
              "paused (reference ptudes viz -r, src/ptudes/cli/viz.py:"
              "24-29)")
    _add(p, "--max-scans", type=int, default=None,
         help="--serve/--stream-dir: export at most N scans. The player "
              "streams pre-exported blobs (~1 MB/scan at 128x1024), so "
              "bound the export for multi-GB recordings instead of "
              "paying full-stream export time/disk up front")
    return root


def main(argv: list[str] | None = None) -> int:
    """Run one ``ptudes-tpu`` command; returns the exit code (0 ok, 1 a
    user-facing error). Bad arguments exit through argparse (code 2)."""
    parser = build_parser()
    args = vars(parser.parse_args(argv))
    func = args.pop("func", None)
    if func is None:
        parser.print_help()
        return 2
    args.pop("command", None)
    args.pop("ekf_command", None)
    try:
        func(**args)
    except CliError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
