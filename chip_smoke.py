"""Bring-up check: the fused LIO path on one GPU, end to end.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the mesh phase only

Everything runs in this one process (a second JAX process would find
most of the card's memory taken). Phases, each of which must pass:

1. device   — JAX reports a GPU; prints its kind, the device count, the
   JAX version and the card's name and power limit (nvidia-smi);
2. kernels  — every hand-written kernel, compiled for the card at the
   bench widths (2048 source points x 4 voxels x 8 points; K=12 IMU
   steps, 18x18 covariance), against the plain XLA form and, where the
   repo has one, an f64 numpy reference; plus the memory analysis of the
   compiled fused scan step;
3. main     — the bench scene (128x1024, 50 scans, rendered from seed 0)
   through ``lio.run_sequence`` under ``bench.bench_config()``, twice:
   ATE RMSE <= 0.02 m, all poses finite, bit-identity of the two runs;
4. live     — the first 10 scans through ``LioOnline`` against the
   batch run (atol 5e-3, as tests/test_online.py);
5. cli      — a real-format LEGACY pcap (128x1024, 30 scans,
   tools/make_fixture.py) through ``ekf-bench ouster
   --use-imu-prediction -g gt.csv``: ATE trans (mean-sq) < 0.05 m and
   ATE RMSE < 0.3 m;
6. card tests — ``pytest -m gpu tests/test_gpu.py``.

``--four`` runs the bag mesh (4x1, ``replay.replay_bags``) and the point
mesh (1x4, ``sharded.sharded_run_sequence``) on four cards against a
one-card run (parity 0.02 m) and checks that the outputs span all four
devices.

Times printed here are bring-up figures, not benchmarks. The last line
is one JSON object: ``{"ok": true, "device": {...}}``; without a GPU
the script exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".bench_cache")
ATE_GATE_M = 0.02          # bench.py's absolute quality gate
MESH_PARITY_M = 0.02       # __graft_entry__.dryrun_multichip's bar
ONLINE_ATOL = 5e-3         # tests/test_online.py
FOUR_SCANS = 8             # bench-scene scans for the mesh phase


class PhaseError(AssertionError):
    """A phase's check failed."""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def _timed(fn, *args, reps: int = 20):
    """(result, mean seconds per call) after one warm-up call."""
    import jax
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return out, (time.perf_counter() - t0) / reps


def _err(a, b) -> tuple[float, float]:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ab = float(np.abs(a - b).max())
    return ab, ab / max(float(np.abs(b).max()), 1e-30)


# ------------------------------------------------------------ kernels

def _icp_scene(n=2048, seed=5):
    """Planes world in a voxel map + a source drawn from it (true pose:
    identity), the guess 5 mm / 0.4 deg off."""
    import jax.numpy as jnp
    from ptudes_tpu.geom import se3
    from ptudes_tpu.ops import hashmap, voxel

    rng = np.random.default_rng(seed)
    half = 20000
    floor = np.stack([rng.uniform(-15, 15, half), rng.uniform(-15, 15, half),
                      rng.uniform(-0.02, 0.02, half)], -1)
    wall = np.stack([rng.uniform(-15, 15, half),
                     np.full(half, 8.0) + rng.uniform(-0.02, 0.02, half),
                     rng.uniform(0, 4, half)], -1)
    pts = np.vstack([floor, wall]).astype(np.float32)
    keep = voxel.first_in_voxel_mask(
        jnp.asarray(pts), jnp.ones(len(pts), bool), 0.15, 1 << 17)
    m = hashmap.insert_deduped(hashmap.create(1 << 19, 8), jnp.asarray(pts),
                               keep, voxel_size=0.3, max_probes=1,
                               new_capacity=8192)
    idx = rng.choice(len(pts), n, replace=False)
    src = pts[idx] + rng.normal(0, 0.01, (n, 3)).astype(np.float32)
    mask = jnp.asarray(rng.uniform(size=n) < 0.95)
    tw = np.array([0.004, -0.003, 0.006, 0.05, -0.04, 0.03], np.float32)
    guess = se3.exp_twist(jnp.asarray(tw))
    return m, jnp.asarray(src), mask, guess


def phase_kernels(card: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from bench import H, W, bench_config
    from ptudes_tpu.config import EkfConfig
    from ptudes_tpu.geom import se3
    from ptudes_tpu.models import esekf, lio, sim
    from ptudes_tpu.ops import backend, icp, pallas_ekf, pallas_icp
    from test_esekf import NumpyEkf

    prec = "f32, products IEEE f32 (allow_tf32=False)"
    log(f"[kernels] forms on this platform: gn_loop="
        f"{backend.choose('gn_loop')} ekf_predict="
        f"{backend.choose('ekf_predict')}")

    # --- GN loop: 2048 points x 4 voxels x 8 points per voxel
    m, src, mask, guess = _icp_scene()
    kern, max_d = jnp.float32(0.1667), jnp.float32(0.5)
    kw = dict(plane_min_quality=0.2, max_iterations=20,
              prior_rot_weight=0.01, prior_trans_weight=0.01)
    gather = jax.jit(lambda g: icp.gather_candidates(
        m, se3.transform(g, src), voxel_size=0.3, max_probes=1,
        neighborhood=7, n_voxels=4, fit_planes=True, plane_radius=0.6))
    cand = gather(guess)
    assert cand.valid.shape == (2048, 32)
    k_fn = jax.jit(lambda c, g: pallas_icp.icp_loop(
        src, mask, c, g, kern, max_d * max_d, 1e-4, **kw))

    def x_loop(unroll):
        return jax.jit(lambda g: icp.register_frame_cached(
            src, mask, m, g, max_d, kern, voxel_size=0.3, max_probes=1,
            convergence=1e-4, neighborhood=7, n_voxels=4, plane_radius=0.6,
            gn_backend="xla", refresh_drift=0.0, gn_unroll=unroll, **kw))

    (kp, kn, ki, _, _), t_k = _timed(k_fn, cand, guess)
    xr, t_x = _timed(x_loop(1), guess)
    _, t_xf = _timed(x_loop(20), guess)
    d = float(np.linalg.norm(np.asarray(se3.log_pose(se3.inv(xr.pose) @ kp))))
    ab, rel = _err(kp, xr.pose)
    truth = float(np.linalg.norm(np.asarray(se3.log_pose(kp))))
    log(f"[kernels] icp_gn_loop vs XLA while_loop: pose max abs {ab:.3e} "
        f"rel {rel:.3e}, |log(dT)| {d:.3e} (tol 5e-4), iters {int(ki)} vs "
        f"{int(xr.iterations)}, corr {int(kn)} vs {int(xr.num_corr)}; "
        f"|log T| from the true pose {truth:.3e} (the motion prior holds "
        f"it near the guess; not gated); {prec}")
    check(d < 5e-4 and abs(int(ki) - int(xr.iterations)) <= 2,
          "icp_gn_loop parity")
    log(f"[kernels] icp_gn_loop {t_k * 1e6:.1f} us/registration vs XLA "
        f"while {t_x * 1e6:.1f}, XLA fixed-count(20) {t_xf * 1e6:.1f} "
        f"(gather excluded; standalone, not a benchmark; {card})")

    # --- EKF predict: K=12, 18x18 covariance
    cfg = EkfConfig()
    rng = np.random.default_rng(9)
    k = 12
    lacc = rng.normal(0, 1, (k + 1, 3)) + [0, 0, 9.78]
    avel = rng.normal(0, 0.3, (k + 1, 3))
    ts = np.arange(k + 1) * 0.01
    s0 = esekf.process_imu(esekf.init_state(cfg), esekf.Imu(
        jnp.asarray(lacc[0], jnp.float32), jnp.asarray(avel[0], jnp.float32),
        jnp.float32(ts[0])), cfg=cfg)               # latches the clock
    imus = esekf.Imu(jnp.asarray(lacc[1:], jnp.float32),
                     jnp.asarray(avel[1:], jnp.float32),
                     jnp.asarray(ts[1:], jnp.float32))
    valid = jnp.ones(k, bool)
    p_fn = jax.jit(lambda s: pallas_ekf.predict_block(s, imus, valid,
                                                      cfg=cfg))
    cfg_u = dataclasses.replace(cfg, predict_batch="unroll")
    cfg_a = dataclasses.replace(cfg, predict_batch="assoc")
    u_fn = jax.jit(lambda s: esekf.process_imu_batch(s, imus, valid,
                                                     cfg=cfg_u))
    a_fn = jax.jit(lambda s: esekf.process_imu_batch(s, imus, valid,
                                                     cfg=cfg_a))
    sp, t_p = _timed(p_fn, s0)
    su, t_u = _timed(u_fn, s0)
    _, t_a = _timed(a_fn, s0)
    ref = NumpyEkf(cfg)
    for i in range(k + 1):
        ref.imu(lacc[i], avel[i], ts[i])
    cab, crel = _err(sp.cov, su.cov)
    fab, frel = _err(sp.cov, ref.cov)
    pab, _ = _err(sp.pos, ref.pos)
    log(f"[kernels] ekf_predict vs XLA unroll: cov max abs {cab:.3e} rel "
        f"{crel:.3e} (tol rel 1e-5); vs f64 oracle: cov max abs {fab:.3e} "
        f"rel {frel:.3e} (tol rel 1e-4), pos max abs {pab:.3e} (tol 1e-4); "
        f"{prec}")
    check(crel < 1e-5 and frel < 1e-4 and pab < 1e-4, "ekf_predict parity")
    log(f"[kernels] ekf_predict {t_p * 1e6:.1f} us/block vs XLA assoc "
        f"{t_a * 1e6:.1f}, unroll {t_u * 1e6:.1f} (standalone, not a "
        f"benchmark; {card})")

    # --- memory analysis of the compiled fused scan step (bench shapes)
    bcfg = bench_config()
    sensor = sim.make_sim_sensor(h=H, w=W, fov_deg=90.0)
    kk = bcfg.max_imu_per_scan
    batch = lio.ScanBatch(
        range_m=jnp.zeros((H, W), jnp.float32), scan_ts=jnp.float32(0.1),
        imu=esekf.Imu(jnp.zeros((kk, 3)), jnp.zeros((kk, 3)),
                      jnp.zeros((kk,))),
        imu_valid=jnp.zeros((kk,), bool), guess_pose=jnp.eye(4))
    step = lio.make_scan_step(sensor.lut, bcfg,
                              insert_overflow=bcfg.steady_insert_mode)
    t0 = time.monotonic()
    compiled = jax.jit(step).lower(lio.init_state(bcfg), batch).compile()
    log(f"[kernels] fused scan_step compiled in {time.monotonic() - t0:.1f}"
        f" s; memory_analysis: {compiled.memory_analysis()}")


# --------------------------------------------------------------- main

def _bench_inputs(n_scans=None):
    import bench
    from ptudes_tpu.models import lio, sim

    scans, scan_ts, gt_mid, imu_ts = (bench.make_data() if n_scans is None
                                      else bench.make_data(n_scans))
    sensor = sim.make_sim_sensor(h=bench.H, w=bench.W, fov_deg=90.0)
    imu = sim.imu_for_circle(imu_ts, radius=bench.RADIUS, speed=bench.SPEED,
                             ramp=bench.RAMP)
    cfg = bench.bench_config()
    batches = lio.build_batches(cfg, scans, scan_ts, np.asarray(imu.lacc),
                                np.asarray(imu.avel), imu_ts)
    return cfg, sensor, batches, gt_mid, (scans, scan_ts, imu, imu_ts)


def phase_main(card: str):
    import jax
    from ptudes_tpu.models import lio
    from ptudes_tpu.utils.metrics import calc_ate_rmse

    t0 = time.monotonic()
    cfg, sensor, batches, gt_mid, raw = _bench_inputs()
    n = batches.range_m.shape[0]
    log(f"[main] bench scene {batches.range_m.shape} ready in "
        f"{time.monotonic() - t0:.1f} s")
    state = lio.init_state(cfg)
    t0 = time.monotonic()
    _, out1 = lio.run_sequence(state, batches, sensor.lut, cfg=cfg)
    jax.block_until_ready(out1)
    cold = time.monotonic() - t0
    t0 = time.monotonic()
    _, out2 = lio.run_sequence(state, batches, sensor.lut, cfg=cfg)
    jax.block_until_ready(out2)
    warm = time.monotonic() - t0
    kp1 = np.asarray(out1.kiss_pose, np.float64)
    kp2 = np.asarray(out2.kiss_pose, np.float64)
    finite = bool(np.isfinite(kp1).all()
                  and np.isfinite(np.asarray(out1.ekf_pose)).all())
    _, ate = calc_ate_rmse(kp1, gt_mid)
    same = bool(np.array_equal(kp1, kp2)
                and np.array_equal(np.asarray(out1.ekf_pose),
                                   np.asarray(out2.ekf_pose)))
    diff = float(np.abs(kp1 - kp2).max())
    log(f"[main] ATE RMSE {ate:.4f} m (gate <= {ATE_GATE_M}), finite "
        f"{finite}, ICP iterations mean "
        f"{np.asarray(out1.aux.iterations).mean():.2f}")
    log(f"[main] run 1 vs run 2 poses bit-identical: {same}"
        + ("" if same else f" (max |delta| {diff:.3e})"))
    log(f"[main] {n / warm:.1f} scans/s steady, cold compile+run "
        f"{cold:.1f} s, compile ~{cold - warm:.1f} s (not a benchmark; "
        f"{card})")
    check(finite and ate <= ATE_GATE_M, f"main path ATE {ate:.4f} m")
    return cfg, sensor, kp1, raw


def phase_live(cfg, sensor, kp_batch, raw) -> None:
    import jax
    from ptudes_tpu.models.online import LioOnline

    scans, scan_ts, imu, imu_ts = raw
    lacc, avel = np.asarray(imu.lacc), np.asarray(imu.avel)
    odo = LioOnline(cfg, sensor.lut)
    outs, j = [], 0
    t0 = time.monotonic()
    for i in range(10):
        while j < len(imu_ts) and imu_ts[j] <= scan_ts[i]:
            odo.push_imu(lacc[j], avel[j], imu_ts[j])
            j += 1
        outs.append(odo.push_scan(scans[i], scan_ts[i]))
    jax.block_until_ready(outs)
    kp = np.stack([np.asarray(o.kiss_pose, np.float64) for o in outs])
    err = float(np.abs(kp - kp_batch[:10]).max())
    log(f"[live] LioOnline 10 scans vs run_sequence: max |pose delta| "
        f"{err:.3e} (atol {ONLINE_ATOL}); {time.monotonic() - t0:.1f} s "
        "incl. compile")
    check(err <= ONLINE_ATOL, "LioOnline parity")


def phase_cli() -> None:
    from make_fixture import generate
    from ptudes_tpu.cli.main import main as cli_main

    d = os.path.join(WORK, "cli_fixture_128x1024_30")
    t0 = time.monotonic()
    pcap, meta, gt = (os.path.join(d, f) for f in
                      ("fixture.pcap", "fixture.json", "gt.csv"))
    if not all(os.path.exists(p) for p in (pcap, meta, gt)):
        with contextlib.redirect_stdout(io.StringIO()):
            pcap, meta, gt = generate(d, n_scans=30, h=128, w=1024)
    log(f"[cli] fixture ready in {time.monotonic() - t0:.1f} s")
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["ekf-bench", "ouster", pcap, "-m", meta,
                       "--use-imu-prediction", "-g", gt,
                       "--kiss-max-range", "60"])
    out = buf.getvalue()
    check(rc == 0, f"ekf-bench ouster exit code {rc}:\n{out[-2000:]}")
    # the first GT block is the EKF-smoothed trajectory
    trans = re.findall(r"ATE trans: ([0-9.eE+-]+) m", out)
    rmse = re.findall(r"ATE RMSE:\s+[0-9.eE+-]+ deg / ([0-9.eE+-]+) m", out)
    check(bool(trans and rmse), f"no ATE in CLI output:\n{out[-2000:]}")
    t_ms, rm = float(trans[0]), float(rmse[0])
    timing = [ln.strip() for ln in out.splitlines() if "Timings" in ln]
    log(f"[cli] ekf-bench ouster: ATE trans (mean-sq) {t_ms:.4f} m (< 0.05)"
        f", ATE RMSE {rm:.4f} m (< 0.3); {time.monotonic() - t0:.1f} s; "
        f"{timing[0] if timing else ''}")
    check(t_ms < 0.05 and rm < 0.3, "CLI fixture ATE")


def phase_card_tests() -> None:
    import pytest
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    check(rc == 0, f"card tests failed (pytest exit {rc})")
    log("[card-tests] pytest -m gpu tests/test_gpu.py passed")


# --------------------------------------------------------------- four

def phase_four(cfg, lut, batches, devices) -> None:
    """Bag mesh 4x1 and point mesh 1x4 against a one-device run. The
    three programs trace, compile and run concurrently (threads), so the
    phase pays about one compile of wall time."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    from ptudes_tpu.models import lio
    from ptudes_tpu.parallel import mesh as mesh_lib
    from ptudes_tpu.parallel import replay, sharded

    n_dev = len(devices)
    bag_mesh = mesh_lib.make_mesh(n_bags=n_dev, n_pt=1, devices=devices)
    pt_mesh = mesh_lib.make_mesh(n_bags=1, n_pt=n_dev, devices=devices)

    def one_device():
        with jax.default_device(devices[0]):
            _, out = lio.run_sequence(lio.init_state(cfg), batches, lut,
                                      cfg=cfg)
            return jax.block_until_ready(out)

    def bags():
        states = replay.stack_bags([lio.init_state(cfg)] * n_dev)
        stacked = jax.tree.map(lambda x: jnp.stack([x] * n_dev), batches)
        _, out = replay.replay_bags(states, stacked, lut, cfg, mesh=bag_mesh)
        return jax.block_until_ready(out)

    def points():
        _, out = sharded.sharded_run_sequence(lio.init_state(cfg), batches,
                                              lut, cfg, pt_mesh)
        return jax.block_until_ready(out)

    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=3) as ex:
        futs = [ex.submit(f) for f in (one_device, bags, points)]
        ref, out_b, out_p = (f.result() for f in futs)
    log(f"[four] one-device run, bag mesh {dict(bag_mesh.shape)} and point "
        f"mesh {dict(pt_mesh.shape)} compiled and ran concurrently in "
        f"{time.monotonic() - t0:.1f} s")
    ref_kp = np.asarray(ref.kiss_pose)
    check(bool(np.isfinite(ref_kp).all()), "one-device poses not finite")

    for what, out, bag_axis in (("bag mesh", out_b, True),
                                ("point mesh", out_p, False)):
        n = len(out.kiss_pose.sharding.device_set)
        kp = np.asarray(out.kiss_pose)
        kps = list(kp) if bag_axis else [kp]
        err = max(float(np.abs(k - ref_kp).max()) for k in kps)
        log(f"[four] {what}: max |pose delta| vs one device {err:.3e} m "
            f"(bar {MESH_PARITY_M}); output spans {n} devices")
        check(n == n_dev, f"{what} output spans {n} devices, not {n_dev}")
        check(err <= MESH_PARITY_M, f"{what} parity")


# ---------------------------------------------------------------- main

PHASES = ["kernels", "main", "live", "cli", "card-tests"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--phase", action="append", choices=PHASES,
                    help="run only these one-card phases (repeatable; "
                         "default: all)")
    args = ap.parse_args(argv)
    phases = args.phase or PHASES

    # JAX picks the card; pinning it also tells tests/conftest.py (card
    # tests phase) not to pin the CPU. A CPU-pinned environment keeps its
    # pin and fails the device phase below.
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    for p in (REPO, os.path.join(REPO, "tools"), os.path.join(REPO, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import jax
    from ptudes_tpu.utils.device import (NoGpuError, card_name_and_power,
                                         require_gpu)

    try:
        dev = require_gpu()
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    card = card_name_and_power()
    log(f"[device] platform {dev['platform']}, device_kind {dev['kind']}, "
        f"count {dev['count']}, jax {jax.__version__}")
    log(card)
    t_all = time.monotonic()
    if args.four:
        check(dev["count"] >= 4, f"--four needs 4 devices, have "
              f"{dev['count']}")
        cfg, sensor, batches, _, _ = _bench_inputs(FOUR_SCANS)
        phase_four(cfg, sensor.lut, batches, jax.devices()[:4])
    else:
        if "kernels" in phases:
            t0 = time.monotonic()
            phase_kernels(card)
            log(f"[kernels] phase {time.monotonic() - t0:.1f} s")
        if "main" in phases or "live" in phases:
            cfg, sensor, kp, raw = phase_main(card)
            if "live" in phases:
                phase_live(cfg, sensor, kp, raw)
        if "cli" in phases:
            phase_cli()
        if "card-tests" in phases:
            phase_card_tests()
    log(f"all phases passed in {time.monotonic() - t_all:.1f} s ({card})")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
