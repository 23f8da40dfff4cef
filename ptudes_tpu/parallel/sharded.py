"""Point-sharded LIO over a device mesh (shard_map + psum).

The BASELINE north-star mapping: within one sequence, the ICP source
points are sharded across the ``pt`` mesh axis. Each device searches its
replicated local-map copy for its shard's NN candidates and accumulates
partial Gauss-Newton normal equations; one ``psum`` of (JTJ [6,6],
JTr [6], counts) per iteration rides the device links — bytes per
collective ~200, so scaling is compute-bound.

The step itself IS the single-device ``lio.make_scan_step`` built with an
``axis_name``: projection (incl. column decimation), deskew, the
voxelize/dedup cascade, adaptive threshold, map insert and EKF all run
replicated with bitwise-identical inputs on every 'pt' device, and only
the ICP source is sliced per device (``models/kiss.py register_scan``).
The sharded pipeline therefore honors every config knob — candidate
refresh, converged-early exit, IMU-rate logging — and
differs from the single-device path ONLY in f32 summation order of the
psum-joined normal equations (VERDICT r1: no silent algorithm fork).

Combined with the ``bag`` axis (pure DP over sequences), this is the
framework's tp x dp analog: ``mesh = (bag, pt)``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import PipelineConfig
from ..models import lio
from ..ops.projection import XyzLut


def sharded_run_sequence(
    state: lio.LioState,
    batches: lio.ScanBatch,
    lut: XyzLut,
    cfg: PipelineConfig,
    mesh: Mesh,
    log: bool = False,
) -> tuple[lio.LioState, lio.LioOut]:
    """lax.scan of the point-sharded step, wrapped in shard_map.

    State and batches are replicated over both mesh axes (single-bag
    form); the point sharding happens inside the step via axis_index
    slicing, and outputs are identical on all devices. Requires
    ``cfg.cap.max_source`` divisible by the 'pt' axis size and
    ``cfg.kiss.nn_mode == 'cached'``.
    """
    n_pt = mesh.shape["pt"]
    assert cfg.cap.max_source % n_pt == 0, (
        f"max_source={cfg.cap.max_source} not divisible by pt={n_pt}")
    # same boot/steady insert split as lio.run_sequence (replicated map
    # updates -> identical map content per device either way); packed
    # per-scan outputs too (ONE flat f32 row per scan instead of ~15
    # stacked LioOut leaves, as the single-device driver)
    pk = not log
    boot = lio.make_scan_step(lut, cfg, insert_overflow=True, log=log,
                              axis_name="pt", pack_out=pk)
    steady = lio.make_scan_step(lut, cfg,
                                insert_overflow=cfg.steady_insert_mode,
                                log=log, axis_name="pt", pack_out=pk)

    def run(state, batches):
        n = batches.range_m.shape[0]
        k = n if cfg.bootstrap_scans < 0 else min(cfg.bootstrap_scans, n)
        if k >= n:
            return jax.lax.scan(boot, state, batches)
        if k == 0:
            return jax.lax.scan(steady, state, batches)
        head = jax.tree.map(lambda x: x[:k], batches)
        state2, out_h = jax.lax.scan(boot, state, head)
        rest = jax.tree.map(lambda x: x[k:], batches)
        state2, out_t = jax.lax.scan(steady, state2, rest)
        out = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), out_h, out_t)
        return state2, out

    fn = shard_map(
        run, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    state2, out = jax.jit(fn)(state, batches)
    return state2, (lio.unpack_out(out) if pk else out)
