"""Port parity: the Threefry keys and counter bits of ``repro_torch.prng``
against ``jax.random`` (jax 0.9's default Threefry implementation) and
the JAX package's ``kernels/ref.py`` — all bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import secure as jsecure
from repro.kernels import ref as jref
from repro_torch import prng
from repro_torch.core import secure as tsecure

EDGES = [0, 1, 2, 7, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]


def _jwords(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", [0, 1, 17, (1 << 31) - 1, -1, -(1 << 31), (1 << 32) - 1])
def test_key_bitwise(seed):
    np.testing.assert_array_equal(prng.key_data(prng.key(seed)), _jwords(jax.random.key(seed)))


@settings(max_examples=8, deadline=None)
@given(st.integers(-(1 << 31), (1 << 32) - 1))
def test_key_and_fold_in_bitwise_over_seeds(seed):
    k = prng.key(seed)
    np.testing.assert_array_equal(prng.key_data(k), _jwords(jax.random.key(seed)))
    for d in EDGES + [seed & 0xFFFFFFFF]:
        np.testing.assert_array_equal(prng.key_data(prng.fold_in(k, d)),
                                      _jwords(jax.random.fold_in(jax.random.key(seed), d)))


def test_fold_in_on_tensors_equals_the_scalar_form():
    """One call folds a table of ids; each entry is the scalar fold."""
    k = prng.fold_in(prng.key(3), 9)
    data = torch.tensor(EDGES, dtype=torch.int64).reshape(-1, 1)
    got = prng.key_data(prng.fold_in(k, data))
    assert got.shape == (len(EDGES), 1, 2)
    for i, d in enumerate(EDGES):
        np.testing.assert_array_equal(got[i, 0].numpy(), prng.key_data(prng.fold_in(k, d)))


@settings(max_examples=6, deadline=None)
@given(st.integers(0, (1 << 32) - 1))
def test_pair_key_chain_bitwise(rnd):
    """The engine's chain fold_in(fold_in(key(seed + 17), rnd), rnd), then
    the sorted pair and the receiver, as JAX's _pair_key_from builds it;
    rounds and ids across the word range."""
    seed = rnd % 1000
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed + 17), rnd), rnd)
    tk = prng.fold_in(prng.fold_in(prng.key(seed + 17), rnd), rnd)
    ids = np.array([[0, 1, 5], [3, (1 << 32) - 1, 2], [(1 << 31), 4, (1 << 32) - 1]], np.int64)
    got = prng.key_data(tsecure.pair_keys(tk, torch.tensor(ids[:, 0]), torch.tensor(ids[:, 1]),
                                          torch.tensor(ids[:, 2])))
    for row, (a, b, r) in enumerate(ids):
        want = _jwords(jsecure._pair_key_from(jk, jnp.uint32(a), jnp.uint32(b), jnp.uint32(r)))
        np.testing.assert_array_equal(got[row].numpy(), want)


@pytest.mark.parametrize("M", [1, 2, 9, 100, 257, 4096, 70_001])
def test_counter_bits_bitwise(M):
    """The counter layout of the reference's kernel, M odd and even."""
    kd = _jwords(jax.random.fold_in(jax.random.key(3), 7))
    want = np.asarray(jref.counter_bits_ref(kd[0], kd[1], jnp.arange(M), M))
    got = prng.counter_bits(int(kd[0]), int(kd[1]), M)
    assert got.dtype == torch.int64 and got.shape == (M,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_counter_bits_of_a_key_table():
    """(B, 1) key words give a (B, M) draw, row b the scalar draw of key b."""
    keys = np.random.default_rng(0).integers(0, 1 << 32, (5, 2), dtype=np.uint64).astype(np.int64)
    got = prng.counter_bits(torch.tensor(keys[:, :1]), torch.tensor(keys[:, 1:]), 1001)
    assert got.shape == (5, 1001)
    for b in range(5):
        want = jref.counter_bits_ref(np.uint32(keys[b, 0]), np.uint32(keys[b, 1]),
                                     jnp.arange(1001), 1001)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want).astype(np.int64))


def test_threefry_cipher_bitwise():
    rng = np.random.default_rng(1)
    w = rng.integers(0, 1 << 32, (4, 64), dtype=np.uint64).astype(np.uint32)
    want = jref.threefry2x32_ref(*(jnp.asarray(a) for a in w))
    got = prng.threefry2x32(*(torch.tensor(a.astype(np.int64)) for a in w))
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j).astype(np.int64))
    ints = prng.threefry2x32(*(int(a[0]) for a in w))
    assert ints == (int(got[0][0]), int(got[1][0]))


KEYS = [(5, 3), (0, 0), (17, (1 << 32) - 1)]


@pytest.mark.parametrize("shape,kd", [
    *((shape, kd) for shape in [(), (1,), (9,), (4, 7), (2, 3, 5)] for kd in KEYS),
    ((1 << 16, 3), KEYS[0]), ((70_001,), KEYS[2]),
], ids=str)
def test_bits_and_uniform_bitwise(shape, kd):
    """``bits``/``uniform`` in the partitionable layout of jax 0.9's
    default: shapes over 2^16 elements, odd lengths, several axes."""
    jk = jax.random.fold_in(jax.random.key(kd[0]), kd[1])
    tk = prng.fold_in(prng.key(kd[0]), kd[1])
    jb = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    tb = prng.bits(tk, shape)
    assert tb.dtype == torch.int64 and tuple(tb.shape) == shape
    np.testing.assert_array_equal(tb.numpy(), jb)
    ju = np.asarray(jax.random.uniform(jk, shape))
    tu = prng.uniform(tk, shape)
    assert tu.dtype == torch.float32 and tuple(tu.shape) == shape
    np.testing.assert_array_equal(tu.numpy().view(np.int32), ju.view(np.int32))


@pytest.mark.parametrize("n,shape", [(6, (1001,)), (3, (70_001,)), (5, ()), (4, (3, 33))])
def test_uniform_of_a_key_table(n, shape):
    """(N, 1) key words, as the sharing strategies fold each node's id,
    draw an (N, *shape) table; row i is the draw of key i alone."""
    tk = prng.fold_in(prng.key(11), 4)
    got = prng.uniform(prng.fold_in(tk, torch.arange(n)[:, None]), shape)
    gotb = prng.bits(prng.fold_in(tk, torch.arange(n)[:, None]), shape)
    assert tuple(got.shape) == (n,) + shape
    jk = jax.random.fold_in(jax.random.key(11), 4)
    for i in range(n):
        ki = jax.random.fold_in(jk, i)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(jax.random.uniform(ki, shape)))
        np.testing.assert_array_equal(gotb[i].numpy(),
                                      np.asarray(jax.random.bits(ki, shape)).astype(np.int64))


def test_uniform_lane_groups_do_not_change_the_draw(monkeypatch):
    """The lane loop's group size moves no bit (the card's groups are
    larger than the CPU's)."""
    tk = prng.fold_in(prng.key(2), 1)
    keys = prng.fold_in(tk, torch.arange(3)[:, None])
    want = prng.uniform(keys, (5003,))
    monkeypatch.setattr(prng, "_CPU_LANES", 1000)
    np.testing.assert_array_equal(prng.uniform(keys, (5003,)).numpy(), want.numpy())
    np.testing.assert_array_equal(prng.uniform(tk, (5003,)).numpy(),
                                  np.asarray(jax.random.uniform(
                                      jax.random.fold_in(jax.random.key(2), 1), (5003,))))
