"""Port parity: the int8 codec (``kernels/quantize.py``) and the
compression module above it, against the JAX package's Pallas kernels (in
interpret mode, as the JAX package's own tests run them on the CPU), its
``kernels/ref.py`` oracles and ``core/compression.py``.

Tolerance: none.  Codes and scales are bitwise those of the reference as
XLA compiles it (under ``jit`` the division by 127 becomes a
multiplication by fl(1/127)); the reference called op by op divides, and
its scale may then differ by one rounding, which is checked as such.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import prng
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


@pytest.mark.parametrize("C", [2, 16, 32, 256])
def test_dequantize_leaf_widths_bitwise_jax(C):
    """The cohort path's int8 cold-row leaves (widths 2, 16, 32 and 256), a
    few hundred rows each with a row at the 1e-12 scale floor and a NaN
    row: the twin, which a CPU tensor takes, bitwise the Pallas kernel in
    interpret mode and the jitted reference."""
    R = 256 + C
    rng = np.random.default_rng(1000 + C)
    codes = rng.integers(-127, 128, size=(R, C)).astype(np.int8)
    scale = rng.uniform(1e-6, 10.0, size=(R, 1)).astype(np.float32)
    scale[3], scale[R - 2] = np.float32(1e-12), np.nan
    got = tq.dequantize(torch.tensor(codes), torch.tensor(scale))
    np.testing.assert_array_equal(got.numpy(), tq.dequantize_ref(torch.tensor(codes),
                                                                 torch.tensor(scale)).numpy())
    jc, js = jnp.asarray(codes), jnp.asarray(scale)
    for want in (jops.dequantize(jc, js), jax.jit(jref.dequantize_ref)(jc, js)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isnan(got.numpy()[R - 2]).all() and np.isfinite(got.numpy()[:R - 2]).all()


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
    """Stochastic rounding draws its noise through ``prng.uniform``: codes
    and scales bitwise the jitted reference's, for one key over the whole
    array and for per-row keys (the reference's ``vmap``)."""
    x = np.random.default_rng(4).normal(size=(3, 1001)).astype(np.float32)
    jk = jax.random.fold_in(jax.random.key(9), 2)
    tk = prng.fold_in(prng.key(9), 2)
    jc, js = jax.jit(jcomp.quantize_int8)(jnp.asarray(x), jk)
    tc, ts = tcomp.quantize_int8(torch.tensor(x), tk)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.arange(3))
    jc, js = jax.jit(jax.vmap(lambda r, kk: jcomp.quantize_int8(r, kk)))(jnp.asarray(x), jkeys)
    tc, ts = tcomp.quantize_int8(torch.tensor(x), prng.fold_in(tk, torch.arange(3)[:, None]))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tc.numpy() != tcomp.quantize_int8(torch.tensor(x))[0].numpy()).any()
    with pytest.raises(ValueError, match="do not lead"):
        tcomp.quantize_int8(torch.tensor(x), prng.fold_in(tk, torch.arange(4)[:, None]))


def test_cpu_tensor_takes_the_twin_and_leaves_the_counters():
    before = (tq.quantize.launches, tq.dequantize.launches)
    codes, scale = tq.quantize(torch.randn(3, 40))
    tq.dequantize(codes, scale)
    assert (tq.quantize.launches, tq.dequantize.launches) == before


def test_wrong_device_type_raises():
    """A device that is neither the CPU, the card nor ``meta`` raises;
    ``meta`` (the dry run's shape-only route) gets empty results."""
    from types import SimpleNamespace

    other = SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        tq.quantize(other)
    with pytest.raises(ValueError, match="unsupported device"):
        tq.dequantize(other, other)
    codes, scale = tq.quantize(torch.ones((2, 4), device="meta"))
    assert (codes.device.type, codes.dtype, tuple(codes.shape)) == ("meta", torch.int8, (2, 4))
    assert (scale.dtype, tuple(scale.shape)) == (torch.float32, (2, 1))
    out = tq.dequantize(codes, scale)
    assert (out.device.type, out.dtype, tuple(out.shape)) == ("meta", torch.float32, (2, 4))


# --- the CUDA kernel's column partition (csrc/quantize.cu), modelled in
# plain Python: the kernel itself runs only on the card
# (tests/test_torch_kernels_gpu.py)

def _cu_const(name):
    src = (Path(tq.__file__).parent / "csrc" / "quantize.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _cluster_size(c):
    """cluster_size of csrc/quantize.cu: the least power of two up
    to kMaxCluster whose threads hold c columns in registers."""
    g = 1
    while g < _cu_const("kMaxCluster") and g * _cu_const("kQThreads") * _cu_const("kQVecs") * 4 < c:
        g *= 2
    return g


def _row_columns(c, g, h, w):
    """(columns in registers, columns read again, single columns) of one
    row on a cluster of g blocks: after a peel of h columns, group v of w
    columns goes to thread v mod S (S = g kQThreads), the first
    kQVecs * 4 / w of a thread's groups into its registers; the peel and
    the tail (under 2w columns) one to each of the first threads."""
    threads, slots = g * _cu_const("kQThreads"), _cu_const("kQVecs") * 4 // w
    n_groups = (c - h) // w
    tail = h + n_groups * w
    held, again = [], []
    for t in range(threads):
        vs = np.arange(t, n_groups, threads)
        for v in vs[:slots]:
            held.extend(range(h + v * w, h + v * w + w))
        for v in vs[slots:]:
            again.extend(range(h + v * w, h + v * w + w))
    singles = [t if t < h else tail + (t - h) for t in range(threads) if t < h + (c - tail)]
    return held, again, singles


@pytest.mark.parametrize("c", [0, 1, 3, 4, 5, 7, 1001, 8192, 8193, 57_959, 65_536, 65_537,
                               200_003])
def test_kernel_cluster_partition_covers_each_column_once(c):
    """Every column of [0, c) is coded exactly once, for the cluster size
    the kernel picks and for every other one, on both the 16-byte path
    (any peel) and the single-column path; a row reads columns again only
    beyond what kMaxCluster blocks hold."""
    cap = _cu_const("kMaxCluster") * _cu_const("kQThreads") * _cu_const("kQVecs") * 4
    g0 = _cluster_size(c)
    for g in sorted({1, 2, 4, 8, g0}):
        for w, peels in ((4, range(4)), (1, (0,))):
            for h in peels:
                held, again, singles = _row_columns(c, g, min(h, c), w)
                cols = np.sort(np.concatenate([held, again, singles]).astype(np.int64))
                np.testing.assert_array_equal(cols, np.arange(c))
                if g == g0:  # read again only past kMaxCluster blocks' registers
                    grouped = (c - min(h, c)) // w * w
                    assert (len(again) > 0) == (grouped > cap), (c, g, h, w)
    assert g0 == 8 or (g0 * cap // 8 >= c and (g0 == 1 or g0 * cap // 16 < c))


def test_kernel_cluster_size_at_the_paths_row():
    """The path's payload row (k = 57,959) takes a cluster of 8 blocks of
    kQThreads, about 29 values a thread, with nothing read again."""
    c = 57_959
    assert _cluster_size(c) == 8
    per_thread = c / (8 * _cu_const("kQThreads"))
    assert 28 < per_thread <= _cu_const("kQVecs") * 4


# --- the flat dequantize (csrc/quantize.cu dequantize_flat_kernel), modelled
# in plain Python: its row arithmetic and its cover of the R * C elements

def _row_div(c):
    """row_div of csrc/quantize.cu: the invariant-integer multiplier and
    shifts for 32-bit indices (the round-up method)."""
    ceil_log2 = 0
    while (1 << ceil_log2) < c:
        ceil_log2 += 1
    m = ((1 << 32) * ((1 << ceil_log2) - c)) // c + 1
    return m, min(ceil_log2, 1), max(ceil_log2 - 1, 0)


def _row_of(i, c):
    """row_of of csrc/quantize.cu: the row of a 32-bit index i by the
    multiplier and two shifts."""
    m, s1, s2 = _row_div(c)
    t = (m * i) >> 32
    return (t + ((i - t) >> s1)) >> s2


@pytest.mark.parametrize("c", [1, 2, 3, 7, 16, 256, 57_959, 579_594, 2**31 - 1, 2**31 + 1,
                                2**32 - 1])
def test_flat_dequantize_row_division_is_exact(c):
    """The multiplier fits 32 bits and divides every index below 2^32 (the
    flat pass's whole range: larger R * C take the per-row kernel)
    exactly, at row boundaries and with the top bit set."""
    assert _row_div(c)[0] < 1 << 32
    rng = np.random.default_rng(c % 1000)
    idx = np.concatenate([rng.integers(0, 2**32, 6000), [0, c - 1, c, 2**31, 2**32 - 1],
                          np.arange(1, 100) * c - 1, np.arange(1, 100) * c])
    for i in idx.tolist():
        if i < 1 << 32:
            assert _row_of(i, c) == i // c


def _flat_dequantize_rows(r, c, ca, oa, cap_blocks=3):
    """Row each element's scale is read from, as dequantize_flat_kernel
    finds them: the host's vec test for code and out addresses ca and oa;
    warp steps of kDqWarpStep elements over a grid of cap_blocks blocks,
    lane l taking the 4-element chunks at l * 4 + j * 128, each from one
    row_of, then rows r and r + 1 split at column c for c >= 4, else
    r + (col + k) // c by three compares; the tail one element to a
    thread.  Also asserts every 4-byte code load and 16-byte store is
    aligned."""
    step, threads = _cu_const("kDqWarpStep"), _cu_const("kDqThreads")
    n = r * c
    vec = ca % 4 == 0 and oa % 16 == 0
    steps = n // step
    blocks = min(max(1, -(-steps // (threads // 32))), cap_blocks)
    warps = blocks * threads // 32
    rows = np.full(n, -1)
    for i in range(steps * step, n):
        assert rows[i] == -1
        rows[i] = _row_of(i, c)
    for warp in range(warps):
        for w in range(warp, steps, warps):
            for lane in range(32):
                for j in range(step // 128):
                    i = w * step + lane * 4 + j * 128
                    if vec:
                        assert (ca + i) % 4 == 0 and (oa + 4 * i) % 16 == 0
                    row = _row_of(i, c)
                    col = i - row * c
                    for k in range(4):
                        if c >= 4:
                            rk = row if col + k < c else row + (col + 3 >= c)
                        else:
                            rk = row + (col + k >= c) + (col + k >= 2 * c) + (col + k >= 3 * c)
                        assert rows[i + k] == -1
                        rows[i + k] = rk
    return rows, vec


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 15, 16, 17, 32, 256, 1001])
@pytest.mark.parametrize("ca,oa,vec", [(0, 0, True), (4, 16, True), (12, 48, True),
                                       (1, 0, False), (2, 16, False), (0, 4, False)])
def test_flat_dequantize_covers_each_element_once_with_its_row(c, ca, oa, vec):
    """Every element is written once, with its own row's scale, at widths
    from 1 (every element a new row) to past a warp step, on the vector
    path and on the single-element path, across a grid-stride."""
    for r in (1, 3, 41, 900 // c + 1):
        rows, v = _flat_dequantize_rows(r, c, ca, oa)
        assert v == vec
        np.testing.assert_array_equal(rows, np.arange(r * c) // c)
