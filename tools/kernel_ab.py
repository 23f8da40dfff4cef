"""A/B of the hand-written kernels against their XLA forms, end to end.

    python tools/kernel_ab.py [--rounds 5] [--trace DIR]

Runs the bench scene (bench.py: 128x1024, 50 scans) through
``lio.run_sequence`` under ``bench.bench_config()`` once per variant —
every kernel on, every XLA form, and each stage toggled alone — and
times the compiled runs in interleaved rounds (the order of the variants
alternates between rounds), on one GPU. Prints one line per variant:
median scans/s, the spread, ATE RMSE and compile seconds, with the card
named (compile seconds are wall time of concurrent compiles).
``--trace DIR`` also records a profiler trace of one run of the
all-kernels and the all-XLA variants and prints a reduction of each:
device busy share over the run, the top device kernels, and the count of
device-to-host copies.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name -> (kiss overrides, ekf overrides)
VARIANTS = {
    "kernels": ({}, {}),
    "xla": ({"gn_backend": "xla"}, {"predict_batch": "assoc"}),
    "gn=xla-while": ({"gn_backend": "xla"}, {}),
    "gn=xla-fixed": ({"gn_backend": "xla", "gn_unroll": 20}, {}),
    "predict=assoc": ({}, {"predict_batch": "assoc"}),
    "predict=unroll": ({}, {"predict_batch": "unroll"}),
}


def variant_cfg(base, name):
    kiss_kw, ekf_kw = VARIANTS[name]
    return dataclasses.replace(
        base, kiss=dataclasses.replace(base.kiss, **kiss_kw),
        ekf=dataclasses.replace(base.ekf, **ekf_kw))


def reduce_trace(path: str) -> dict:
    """Device busy share, top kernels and device-to-host copies of the
    newest ``.xplane.pb`` under ``path``."""
    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(path, "plugins", "profile", "*",
                                          "*.xplane.pb")))
    pd = ProfileData.from_file(files[-1])
    kernels: dict[str, list] = {}
    intervals = []
    d2h = 0
    lines_seen = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines_seen.append(f"{plane.name}|{line.name}|{len(evs)}")
            if "stream" not in line.name.lower():
                continue
            for e in evs:
                name = e.name
                if "memcpy" in name.lower() and (
                        "dtoh" in name.lower() or "d2h" in name.lower()):
                    d2h += 1
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
                k = kernels.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += e.duration_ns
    busy = 0.0
    span = 0.0
    if intervals:
        intervals.sort()
        lo, hi = intervals[0]
        start = lo
        for a, b in intervals[1:]:
            if a > hi:
                busy += hi - lo
                lo, hi = a, b
            else:
                hi = max(hi, b)
        busy += hi - lo
        span = hi - start
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:25]
    return {
        "device_lines": lines_seen,
        "busy_share": busy / span if span else None,
        "window_ms": span * 1e-6,
        "busy_ms": busy * 1e-6,
        "n_device_events": len(intervals),
        "d2h_copies": d2h,
        "top_kernels_ms": [(n, c, round(t * 1e-6, 4)) for n, (c, t) in top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    import jax
    import bench
    from ptudes_tpu.models import lio, sim
    from ptudes_tpu.utils.device import card_name_and_power, require_gpu
    from ptudes_tpu.utils.metrics import calc_ate_rmse

    dev = require_gpu()
    card = card_name_and_power()
    print(f"device {dev}; {card}", flush=True)
    scans, scan_ts, gt_mid, imu_ts = bench.make_data()
    sensor = sim.make_sim_sensor(h=bench.H, w=bench.W, fov_deg=90.0)
    imu = sim.imu_for_circle(imu_ts, radius=bench.RADIUS, speed=bench.SPEED,
                             ramp=bench.RAMP)
    base = bench.bench_config()
    batches = lio.build_batches(base, scans, scan_ts, np.asarray(imu.lacc),
                                np.asarray(imu.avel), imu_ts)
    n = batches.range_m.shape[0]
    names = args.variants.split(",")

    def build(name):
        cfg = variant_cfg(base, name)
        state = lio.init_state(cfg)
        t0 = time.monotonic()
        fn = jax.jit(lambda s, b, cfg=cfg: lio.run_sequence(
            s, b, sensor.lut, cfg=cfg)).lower(state, batches).compile()
        return fn, state, time.monotonic() - t0

    # the variants compile concurrently (XLA compiles outside the GIL);
    # each compile time is wall time under that contention
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        built = dict(zip(names, ex.map(build, names)))
    runs, info = {}, {}
    for name in names:
        fn, state, comp = built[name]
        _, out = fn(state, batches)
        _, ate = calc_ate_rmse(np.asarray(out.kiss_pose, np.float64), gt_mid)
        runs[name] = (fn, state)
        info[name] = {"compile_s": comp, "ate_rmse_m": float(ate),
                      "times": []}
        print(f"compiled {name}: {comp:.1f} s (concurrent), ATE "
              f"{ate:.4f} m", flush=True)

    for r in range(args.rounds):
        order = names if r % 2 == 0 else names[::-1]
        for name in order:
            fn, state = runs[name]
            t0 = time.perf_counter()
            jax.block_until_ready(fn(state, batches))
            info[name]["times"].append(time.perf_counter() - t0)

    print(f"--- end-to-end, {n} scans per run, {args.rounds} interleaved "
          f"rounds; {card}")
    for name in names:
        t = np.asarray(info[name]["times"])
        rate = n / t
        q1, q3 = np.percentile(rate, [25, 75])
        info[name].update(median_scans_s=float(np.median(rate)),
                          iqr_scans_s=float(q3 - q1))
        print(f"{name:>15s}: {np.median(rate):8.1f} scans/s median "
              f"(IQR {q3 - q1:.1f}; runs {', '.join(f'{x:.1f}' for x in rate)})"
              f", ATE {info[name]['ate_rmse_m']:.4f} m, compile "
              f"{info[name]['compile_s']:.1f} s", flush=True)

    if args.trace:
        for name in ("kernels", "xla"):
            if name not in runs:
                continue
            fn, state = runs[name]
            d = os.path.join(args.trace, name)
            with jax.profiler.trace(d):
                jax.block_until_ready(fn(state, batches))
            red = reduce_trace(d)
            info[name]["trace"] = red
            print(f"--- trace {name}: busy {red['busy_share']}, window "
                  f"{red['window_ms']:.3f} ms, busy {red['busy_ms']:.3f} ms, "
                  f"{red['n_device_events']} device events, D2H copies "
                  f"{red['d2h_copies']}")
            for k in red["top_kernels_ms"][:15]:
                print(f"    {k[2]:9.3f} ms  x{k[1]:<5d} {k[0][:100]}")
        with open(os.path.join(args.trace, "kernel_ab.json"), "w") as f:
            json.dump({"device": dev, "card": card, "variants": info}, f,
                      indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
