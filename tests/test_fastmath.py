"""exact_div32: correctly-rounded f32 division (ops/fastmath.py).

A backend that lowers f32 division to a reciprocal-multiply approximation
(~1e-6 rel error) can flip alignment ties. The Markstein/Dekker sequence
must be bit-equal to IEEE division, and so must its hoisted form (the
divisor-dependent terms — reciprocal and Veltkamp split of y — computed
once per divisor); both are checked here on the CPU backend."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from twilight_tpu.ops.fastmath import exact_div32


def _hoisted_div(x, y):
    """exact_div32 with the divisor terms precomputed once."""
    s = jnp.float32(4097.0)
    r = jnp.float32(1.0) / y
    b1 = y * s
    bh = b1 - (b1 - y)
    bl = y - bh
    q0 = x * r
    p = q0 * y
    a1 = q0 * s
    ah = a1 - (a1 - q0)
    al = q0 - ah
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    resid = (x - p) - err
    return q0 + resid * r


@pytest.mark.parametrize("div", [exact_div32, _hoisted_div],
                         ids=["exact_div32", "hoisted"])
def test_exact_div32_bit_equal(rng, div):
    f = jax.jit(div)
    for _ in range(10):
        x = (rng.uniform(-1e6, 1e6, 4096)
             * 10.0 ** rng.uniform(-4, 1, 4096)).astype(np.float32)
        y = np.floor(rng.uniform(1, 10.0 ** rng.uniform(0, 8, 4096))
                     ).astype(np.float32)
        out = np.asarray(f(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_array_equal(out, (x / y).astype(np.float32))


def test_exact_div32_exact_cases():
    f = jax.jit(exact_div32)
    x = jnp.asarray([126.0, 1.0, 0.0, -126.0], jnp.float32)
    y = jnp.asarray([7.0, 3.0, 5.0, 7.0], jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(f(x, y)),
        np.asarray([18.0, np.float32(1.0 / 3.0), 0.0, -18.0], np.float32))


def test_hoisted_div_bit_equals_exact_div32_and_ieee(rng):
    with jax.default_device(jax.devices("cpu")[0]):
        for mag in (1.0, 1e-6, 1e6):
            x = (rng.standard_normal(4096) * mag).astype(np.float32)
            y = (rng.uniform(0.5, 50.0, 4096) * mag).astype(np.float32)
            a = np.asarray(exact_div32(jnp.asarray(x), jnp.asarray(y)))
            b = np.asarray(_hoisted_div(jnp.asarray(x), jnp.asarray(y)))
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, x / y)
