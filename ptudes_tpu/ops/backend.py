"""Implementation choice by platform.

The one place that decides, for each stage with a hand-written kernel,
whether the kernel or the plain XLA form runs. A kernel is chosen only
on a platform where it is compiled for the device and won its
end-to-end A/B there (PERF.md); everywhere else the plain XLA form
runs. Kernels are never run in interpret mode outside the tests.

Stages and their forms (the config fields that name them take "auto"
to mean "whatever this module picks"):

* ``gn_loop``     — frozen-candidate GN ICP loop: ``"triton"``
  (``ops.pallas_icp``) or ``"xla"`` (``ops.icp`` while_loop);
* ``ekf_predict`` — per-scan IMU predict block: ``"triton"``
  (``ops.pallas_ekf.predict_block``) or ``"assoc"``
  (``models.esekf``'s associative-scan form).
"""
from __future__ import annotations

import jax

_PLAIN = {"gn_loop": "xla", "ekf_predict": "assoc"}

# the A/B winners per platform (PERF.md, PR 1)
_KERNELS = {
    "gpu": {"gn_loop": "triton", "ekf_predict": "triton"},
}


def choose(stage: str, platform: str | None = None) -> str:
    """The form of ``stage`` to run on ``platform`` (default: JAX's
    default backend)."""
    if stage not in _PLAIN:
        raise ValueError(f"unknown stage {stage!r}")
    p = jax.default_backend() if platform is None else platform
    return _KERNELS.get(p, _PLAIN)[stage]


def resolve(stage: str, requested: str, platform: str | None = None) -> str:
    """``requested`` unless it is ``"auto"``, then :func:`choose`."""
    return choose(stage, platform) if requested == "auto" else requested
