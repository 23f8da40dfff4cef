"""Streaming (scan-by-scan) LIO driver.

The batch pipeline (``lio.run_sequence``) assumes the whole recording is
on device; live deployments receive packets as they arrive. ``LioOnline``
wraps the SAME fused ``scan_step`` — one compiled program per scan, state
held on device between calls — with host-side IMU windowing identical to
``lio.build_batches``:

    odo = LioOnline(cfg, lut)
    for msg in sensor_stream:
        if msg.is_imu:
            odo.push_imu(msg.lacc, msg.avel, msg.ts)
        else:
            out = odo.push_scan(msg.range_m, msg.ts)
            publish(out.ekf_pose)

Timestamps may be epoch-scale: the first pushed sample fixes the f64
origin (or pass ``time_origin``, e.g. from a state checkpoint, to
continue a previous session's clock). State is checkpointable at any
scan boundary via ``utils.checkpoint``.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..ops.projection import XyzLut
from . import lio
from .esekf import Imu


class LioOnline:
    """Stateful per-scan driver around the fused scan_step."""

    def __init__(
        self,
        cfg: PipelineConfig,
        lut: XyzLut,
        state: lio.LioState | None = None,
        time_origin: float | None = None,
        prev_scan_ts: float | None = None,
    ):
        """``prev_scan_ts`` (absolute clock, like ``time_origin``): when
        resuming from a checkpoint, the checkpoint's last scan timestamp —
        IMU samples at or before it are ignored instead of re-integrated
        (same seam rule as ``lio.build_batches(prev_scan_ts=...)``)."""
        self.cfg = cfg
        self.lut = lut
        self.state = lio.init_state(cfg) if state is None else state
        self._origin = time_origin
        self._imu_buf: list[tuple] = []
        self._prev_scan_ts = -np.inf
        if prev_scan_ts is not None:
            if time_origin is None:
                raise ValueError("prev_scan_ts requires time_origin")
            self._prev_scan_ts = float(prev_scan_ts) - float(time_origin)
        self._n_dropped_imu = 0
        # boot/steady split, mirroring lio.run_sequence: the first
        # cfg.bootstrap_scans scans absorb the whole frame at once (one
        # wide insert chunk); the steady step inserts an evenly-decimated
        # cap.max_new_per_scan budget per scan — bursts (doorways) spread
        # over the next couple of scans via the retry rule, and the
        # per-scan latency stays free of the overflow loop's carry
        # boundary. bootstrap_scans < 0 keeps overflow on for every scan.
        self._n_scans = 0
        self._boot_scans = cfg.bootstrap_scans
        self._step_steady = jax.jit(
            lio.make_scan_step(lut, cfg,
                               insert_overflow=cfg.steady_insert_mode))
        # map_frozen (localization-only) skips inserts in every step, so
        # boot and steady would be the same program — compile one
        self._step_boot = self._step_steady if cfg.map_frozen else jax.jit(
            lio.make_scan_step(lut, cfg, insert_overflow=True))

    @property
    def n_dropped_imu(self) -> int:
        """IMU samples discarded because a scan interval held more than
        ``cfg.max_imu_per_scan`` (mirrors build_batches accounting)."""
        return self._n_dropped_imu

    def _rebase(self, ts: float) -> float:
        if self._origin is None:
            self._origin = float(ts)
        return float(ts) - self._origin

    def push_imu(self, lacc, avel, ts: float) -> None:
        """Buffer one IMU sample (SI units, seconds; epoch-scale ok)."""
        self._imu_buf.append(
            (np.asarray(lacc, np.float32), np.asarray(avel, np.float32),
             self._rebase(ts)))

    def push_scan(self, range_m: np.ndarray, ts: float) -> lio.LioOut:
        """Register one range image [H, W] (meters, 0 = no return).

        Consumes the buffered IMU samples in (prev_scan_ts, ts] — exactly
        the reference's interleaving (``src/ptudes/data.py:49-77``) and
        ``lio.build_batches``' windowing — and advances the on-device
        state. Returns the scan's ``LioOut`` (poses still on device;
        ``np.asarray`` them only when needed to keep the loop async).
        """
        t1 = self._rebase(ts)
        k = self.cfg.max_imu_per_scan
        sel = [s for s in self._imu_buf
               if self._prev_scan_ts < s[2] <= t1]
        self._imu_buf = [s for s in self._imu_buf if s[2] > t1]
        if len(sel) > k:
            self._n_dropped_imu += len(sel) - k
            sel = sel[-k:]
        m = len(sel)
        lacc = np.zeros((k, 3), np.float32)
        avel = np.zeros((k, 3), np.float32)
        its = np.zeros((k,), np.float32)
        valid = np.zeros((k,), bool)
        if m:
            lacc[:m] = [s[0] for s in sel]
            avel[:m] = [s[1] for s in sel]
            its[:m] = [s[2] for s in sel]
            valid[:m] = True
        self._prev_scan_ts = t1

        batch = lio.ScanBatch(
            range_m=jnp.asarray(range_m, jnp.float32),
            scan_ts=jnp.asarray(t1, jnp.float32),
            imu=Imu(lacc=jnp.asarray(lacc), avel=jnp.asarray(avel),
                    ts=jnp.asarray(its)),
            imu_valid=jnp.asarray(valid),
            guess_pose=jnp.eye(4, dtype=jnp.float32),
        )
        boot = self._boot_scans < 0 or self._n_scans < self._boot_scans
        self.state, out = (self._step_boot if boot
                           else self._step_steady)(self.state, batch)
        self._n_scans += 1
        return out

    @property
    def time_origin(self) -> float | None:
        """The f64 clock origin (for checkpoint metadata)."""
        return self._origin
