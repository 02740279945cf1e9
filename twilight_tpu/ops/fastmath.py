"""Bit-exact float32 primitives for the JAX kernels.

Some accelerator backends lower f32 division to a reciprocal-multiply
approximation (~1e-6 relative error), which breaks the byte-identical-output
contract — a ~30-ulp similarity error is enough to flip an alignment tie.
`exact_div32` implements correctly-rounded f32 division via a Markstein
refinement with a Dekker two-product standing in for a hardware FMA, so the
result does not depend on how the backend divides (tests/test_fastmath.py).
"""
from __future__ import annotations

import jax.numpy as jnp

_SPLIT = 4097.0  # 2**12 + 1: Veltkamp split constant for f32 (p=24)


def _two_prod(a, b):
    """Dekker: a*b = p + err exactly (no overflow for |a*b| < ~1e31)."""
    p = a * b
    s = jnp.float32(_SPLIT)
    a1 = a * s
    ah = a1 - (a1 - a)
    al = a - ah
    b1 = b * s
    bh = b1 - (b1 - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def exact_div32(x, y):
    """Correctly-rounded f32 x / y (Markstein sequence)."""
    r = jnp.float32(1.0) / y
    q0 = x * r
    p, e1 = _two_prod(q0, y)
    resid = (x - p) - e1
    return q0 + resid * r
