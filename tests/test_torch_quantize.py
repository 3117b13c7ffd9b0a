"""Port parity: the int8 codec (``kernels/quantize.py``) and the
compression module above it, against the JAX package's Pallas kernels (in
interpret mode, as the JAX package's own tests run them on the CPU), its
``kernels/ref.py`` oracles and ``core/compression.py``.

Tolerance: none.  Codes and scales are bitwise those of the reference as
XLA compiles it (under ``jit`` the division by 127 becomes a
multiplication by fl(1/127)); the reference called op by op divides, and
its scale may then differ by one rounding, which is checked as such.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import compression as tcomp
from repro_torch.kernels import quantize as tq


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(1e-3, 1e3, size=shape[:-1] + (1,)).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32) * scale


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


@pytest.mark.parametrize("R,C", [(1, 256), (16, 1000), (64, 33), (3, 4099)])
@pytest.mark.parametrize("noisy", [False, True])
def test_quantize_bitwise_pallas_and_jit_ref(R, C, noisy):
    x = _x((R, C), R * C)
    noise = np.random.default_rng(7).uniform(size=(R, C)).astype(np.float32) if noisy else None
    jn = None if noise is None else jnp.asarray(noise)
    codes, scale = tq.quantize(torch.tensor(x), None if noise is None else torch.tensor(noise))
    assert codes.dtype == torch.int8 and scale.shape == (R, 1) and scale.dtype == torch.float32
    for jc, js in (jops.quantize(jnp.asarray(x), jn), jax.jit(jref.quantize_ref)(jnp.asarray(x), jn)):
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    # the reference op by op: the scale within one rounding, codes from it
    ec, es = jref.quantize_ref(jnp.asarray(x), jn)
    assert _ulps(scale.numpy(), es).max() <= 1
    same = (scale.numpy() == np.asarray(es))[:, 0]
    np.testing.assert_array_equal(codes.numpy()[same], np.asarray(ec)[same])


def test_round_half_to_even_and_clip():
    # scale = 127 * fl(1/127) = 1.0 here: x / scale hits the .5 ties exactly
    x = np.array([[127.0, 2.5, -2.5, 3.5, -0.5, 0.5, 1.5, -127.0]], np.float32)
    codes, scale = tq.quantize(torch.tensor(x))
    assert float(scale) == 1.0
    assert codes.tolist() == [[127, 2, -2, 4, 0, 0, 2, -127]]
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jops.quantize(jnp.asarray(x))[0]))
    zero_codes, zero_scale = tq.quantize(torch.zeros((2, 5)))
    assert float(zero_scale.max()) == np.float32(1e-12) and not zero_codes.any()


@pytest.mark.parametrize("R,C", [(4, 100), (8, 57959 // 64)])
def test_dequantize_bitwise(R, C):
    rng = np.random.default_rng(R + C)
    codes = rng.integers(-127, 128, size=(R, C)).astype(np.int8)
    scale = rng.uniform(1e-6, 10.0, size=(R, 1)).astype(np.float32)
    got = tq.dequantize(torch.tensor(codes), torch.tensor(scale))
    assert got.dtype == torch.float32
    for want in (jops.dequantize(jnp.asarray(codes), jnp.asarray(scale)),
                 jref.dequantize_ref(jnp.asarray(codes), jnp.asarray(scale))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(8, 513), (2, 3, 100), (7,)])
def test_compression_int8_bitwise_jax(shape):
    x = _x(shape, sum(shape))
    codes, scale = tcomp.quantize_int8(torch.tensor(x))
    jc, js = jax.jit(jcomp.quantize_int8)(jnp.asarray(x))
    assert codes.shape == shape and scale.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcomp.dequantize_int8(codes, scale).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jc, js)))


@pytest.mark.parametrize("noisy", [False, True])
def test_nan_row_propagates_like_jax(noisy):
    """A row holding a NaN gets a NaN scale and codes 0 in both packages,
    so it comes back all NaN; the other rows are untouched by it."""
    x = _x((4, 300), 5)
    x[1, 7] = np.nan
    noise = np.random.default_rng(8).uniform(size=x.shape).astype(np.float32) if noisy else None
    jn = None if noise is None else jnp.asarray(noise)
    codes, scale = tq.quantize(torch.tensor(x), None if noise is None else torch.tensor(noise))
    for jc, js in (jops.quantize(jnp.asarray(x), jn), jax.jit(jref.quantize_ref)(jnp.asarray(x), jn)):
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    assert np.isnan(scale[1, 0].item()) and not codes[1].any()
    assert np.isfinite(scale.numpy()[[0, 2, 3]]).all()
    x_hat = tq.dequantize(codes, scale).numpy()
    assert np.isnan(x_hat[1]).all() and np.isfinite(x_hat[[0, 2, 3]]).all()


def test_stochastic_rounding_needs_the_prng():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tcomp.quantize_int8(torch.ones((2, 4)), key=0)


def test_cpu_tensor_takes_the_twin_and_leaves_the_counters():
    before = (tq.quantize.launches, tq.dequantize.launches)
    codes, scale = tq.quantize(torch.randn(3, 40))
    tq.dequantize(codes, scale)
    assert (tq.quantize.launches, tq.dequantize.launches) == before


def test_wrong_device_type_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        tq.quantize(torch.ones((2, 4), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tq.dequantize(torch.ones((2, 4), dtype=torch.int8, device="meta"),
                      torch.ones((2, 1), device="meta"))
