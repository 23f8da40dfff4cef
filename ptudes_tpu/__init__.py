"""ptudes-tpu: point etudes lab in JAX.

A JAX/XLA/Pallas framework with the capabilities of bexcite/ptudes-lab
(lidar-inertial odometry, SLAM, evaluation and visualization around
Ouster lidar data), re-designed for an accelerator:

* the per-scan pipeline (deskew -> voxelize -> NN-ICP -> map update -> EKF)
  is one jit-compiled ``scan_step`` under ``lax.scan``;
* the local map is a fixed-capacity, static-shape voxel hash table in
  device memory;
* parallelism comes from ``vmap`` over sequences and ``shard_map`` over a
  device mesh (the reference is single-threaded CPU python — SURVEY.md
  section 2c).
"""

import os as _os

import jax as _jax

# Geometry / state estimation is precision-critical: JAX's default matmul
# precision may lower f32 matmuls to reduced-precision passes (bf16 or
# TF32, ~8-10 mantissa bits), which at lidar ranges (100 m) means
# tens-of-cm coordinate error inside pose chains, ICP Jacobian products
# and EKF covariance updates. All matmuls in this framework are small
# (3x3 pose chains, Nx6 GN reductions, 18x18 EKF), so full f32 precision
# costs nothing while being required for correctness. (It does not
# reach inside Pallas kernels: ops.pallas_* ask for IEEE f32 themselves.)
_jax.config.update("jax_default_matmul_precision", "highest")


def compile_cache_dir() -> str | None:
    """Where this package puts JAX's persistent compilation cache.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left alone (None). Otherwise the cache lives at one fixed path inside
    the checkout (``.jax_cache``, git-ignored): the path is part of the
    cache key, so it must not move between runs. None as well when the
    process is pinned to the CPU: XLA:CPU persists AOT machine code whose
    feature-set check is unreliable (the loader reports compile-machine
    features as missing even on the same host and warns of possible
    SIGILL), and CPU compiles are cheap."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if "cpu" in _os.environ.get("JAX_PLATFORMS", "").lower():
        return None
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


_cache = compile_cache_dir()
if _cache is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

__version__ = "0.1.0"

GRAV = 9.782940329221166
"""Gravity constant, numerically identical to the reference
(``src/ptudes/ins/data.py:10``)."""
