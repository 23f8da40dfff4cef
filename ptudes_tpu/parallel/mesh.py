"""Device mesh helpers for the LIO workload.

The reference has no parallelism at all (single-threaded CPU python,
SURVEY.md section 2c); the natural axes are:

* ``bag``   — data parallelism over independent sequences (multi-bag
  replay, hyperparameter sweeps). Embarrassingly parallel: no collectives.
* ``pt``    — intra-scan point sharding: the ICP source is split across
  devices, each computes partial GN normal equations against a replicated
  map, and a psum reduces the 6x6+6 system (the one genuinely
  communicating dimension of this workload).

Meshes are standard ``jax.sharding.Mesh`` objects so everything composes
with jit/shard_map and scale from the 8-device CPU-emulated test mesh to
real devices unchanged.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_bags: int = 1, n_pt: int | None = None,
              devices=None) -> Mesh:
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if n_pt is None:
        n_pt = n // n_bags
    assert n_bags * n_pt == n, (
        f"bag x pt mesh {n_bags}x{n_pt} != {n} devices")
    return Mesh(np.asarray(devices).reshape(n_bags, n_pt), ("bag", "pt"))


def bag_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over bags (for stacked states/batches)."""
    return NamedSharding(mesh, P("bag"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
