"""The device a measurement runs on, named the same way everywhere.

Every number a benchmark or the chip check prints names its device:
JAX's platform, ``device_kind`` and device count, and the card's name
and power limit as ``nvidia-smi`` reports them (a card set below its
maximum power runs slower under load). A measurement path that finds no
GPU fails instead of falling back to the CPU.
"""
from __future__ import annotations

import subprocess

import jax


class NoGpuError(RuntimeError):
    """JAX found no GPU: a device measurement cannot run."""


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's devices; raises
    :class:`NoGpuError` unless they are GPUs."""
    try:
        devs = jax.devices()
    except RuntimeError as e:  # e.g. JAX_PLATFORMS names a missing backend
        raise NoGpuError(f"no accelerator: {e}") from e
    d = devs[0]
    if d.platform != "gpu":
        raise NoGpuError(
            f"JAX's devices are {d.platform!r} ({d.device_kind}), not a "
            "GPU; device measurements run only on the card")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def card_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one line per card joined by ``; ``."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in r.stdout.splitlines()
                     if ln.strip())
