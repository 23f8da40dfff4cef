"""Tiny fixed-size linear algebra, unrolled.

``jnp.linalg.solve`` / ``inv`` on a single small matrix lower to LU
custom calls with real per-call latency — inside the ICP Gauss-Newton
loop (one 6x6 solve per iteration) and the EKF update (6x6 innovation
inverse) that latency is a measurable slice of the scan budget. An
unrolled Cholesky is ~100 scalar ops that XLA fuses into the surrounding
program.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def solve_spd6(a: jax.Array, b: jax.Array, eps: float = 1e-12) -> jax.Array:
    """Solve ``a x = b`` for symmetric positive-definite 6x6 ``a``.

    ``b`` may be [6] or [6, K]. Fully unrolled Cholesky + two triangular
    substitutions (no custom calls). The sqrt argument is floored at
    ``eps`` so a semidefinite system (zero correspondences + Tikhonov
    floor) stays finite.
    """
    n = 6
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = jnp.sqrt(jnp.maximum(s, eps))
            else:
                l[i][j] = s / l[j][j]

    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    # forward: L y = b
    y = [None] * n
    for i in range(n):
        s = bb[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    # backward: L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    out = jnp.stack(x, axis=0)
    return out[:, 0] if vec else out
