"""Multi-bag replay and parameter sweeps (data parallelism over sequences).

BASELINE config 5: "Batched 8-way multi-bag replay (vmap over sequences)
for ICP/EKF hyperparameter sweep". Sequences are
embarrassingly parallel — each device (or mesh row) runs an independent
lax.scan; stacking along the leading axis + a 'bag' sharding gives linear
scaling with zero collectives (SURVEY.md section 2c consequence (1)).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import PipelineConfig
from ..models import lio
from ..ops.projection import XyzLut


def stack_bags(items: list):
    """Stack a list of pytrees (states or batches) along a new leading axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *items)


def replay_bags(
    states: lio.LioState,      # stacked [B, ...]
    batches: lio.ScanBatch,    # stacked [B, N, ...]
    lut: XyzLut,
    cfg: PipelineConfig,
    mesh: Mesh | None = None,
):
    """vmapped run_sequence over the bag axis, sharded over mesh axis 'bag'
    when a mesh is given (otherwise single-device vmap).

    With a mesh, each device runs its own bags under ``shard_map``: the
    step's hand-written kernels are custom calls the SPMD partitioner
    cannot split, so partitioning a plain jit would run every bag on
    every device."""
    run = jax.vmap(lambda s, b: lio.run_sequence(s, b, lut, cfg=cfg))
    if mesh is None:
        return jax.jit(run)(states, batches)
    bag = NamedSharding(mesh, P("bag"))
    states = jax.device_put(states, bag)
    batches = jax.device_put(batches, bag)
    fn = shard_map(run, mesh=mesh, in_specs=(P("bag"), P("bag")),
                   out_specs=(P("bag"), P("bag")), check_vma=False)
    return jax.jit(fn)(states, batches)
