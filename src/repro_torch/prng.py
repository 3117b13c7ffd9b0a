"""Threefry-2x32 keys and counter bits, bitwise those of the JAX package.

The reference draws the secure-aggregation masks from ``jax.random`` keys
(the default Threefry-2x32 implementation) and expands each pair key into
mask bits with the positional counter layout of its kernel
(``kernels/ref.py counter_bits_ref``).  This module computes the same
words without JAX:

* :func:`key` — ``jax.random.key(seed)``: the words ``(0, seed mod 2^32)``;
* :func:`fold_in` — ``jax.random.fold_in(k, d)``: one cipher call on the
  counter words ``(0, d)``;
* :func:`key_data` — ``jax.random.key_data(k)``: the two words stacked;
* :func:`counter_bits` — the (..., total) uint32 draw of a key in the
  kernel's layout: the counter ``0 .. total-1`` padded with one zero to an
  even length and cut into halves, lane q ciphering the words
  ``(q, q + h)``, its two outputs landing at positions q and q + h
  (h = ceil(total / 2)).  ``jax.random.bits`` no longer uses this layout
  under jax 0.9's partitionable Threefry; the reference's secure
  aggregation does;
* :func:`bits` and :func:`uniform` — ``jax.random.bits(k, shape)`` and
  ``jax.random.uniform(k, shape)`` (float32 in [0, 1)) in jax 0.9's
  default partitionable layout: element i of the flattened shape ciphers
  the counter words ``(i >> 32, i & 0xFFFFFFFF)`` and its 32 bits are the
  xor of the two outputs; a uniform keeps the top 23 of them as the
  mantissa of a float in [1, 2) and subtracts 1.

A key is a pair of words ``(k1, k2)``, each a Python int or an int64
tensor of values in [0, 2^32): every word is kept in a wider integer and
masked to 32 bits after each addition or shift (torch has no uint32
arithmetic on the CPU).  Words of a batch of keys broadcast against each
other and against the data, so one call folds a whole table of ids.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CPU_LANES, _CUDA_LANES = 1 << 18, 1 << 26  # cipher lanes per step of counter_bits

Key = Tuple[object, object]


def threefry2x32(k1, k2, x0, x1):
    """Elementwise Threefry-2x32 block cipher (20 rounds), the JAX PRNG
    core: key words ``k1, k2`` and counter words ``x0, x1`` (Python ints or
    int64 tensors holding uint32 values, broadcastable) -> ``(y0, y1)``."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    if isinstance(x0, torch.Tensor) and isinstance(x1, torch.Tensor) and x0.shape == x1.shape:
        return _threefry_rounds_(ks, x0, x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) & MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _threefry_rounds_(ks, x0, x1):
    """The 20 rounds of :func:`threefry2x32` on two fresh tensors of one
    shape, in place (the same operations, without a temporary per step)."""
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            torch.bitwise_left_shift(x1, r, out=t).bitwise_and_(MASK32)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK32)
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)``'s words for a seed in the int32 range."""
    return 0, int(seed) & MASK32


def fold_in(k: Key, data) -> Key:
    """``jax.random.fold_in(k, data)``: data is an int or an int64 tensor
    (taken modulo 2^32, as ``jnp.uint32(data)`` does)."""
    return threefry2x32(k[0], k[1], 0, data & MASK32)


def key_data(k: Key):
    """The key's two words stacked on a last axis of 2: a (2,) uint32 numpy
    array for Python-int words, else an int64 tensor (..., 2)."""
    if isinstance(k[0], torch.Tensor) or isinstance(k[1], torch.Tensor):
        k1, k2 = torch.broadcast_tensors(torch.as_tensor(k[0]), torch.as_tensor(k[1]))
        return torch.stack([k1, k2], -1)
    return np.array(k, dtype=np.uint32)


def _lead_and_step(k1, k2, device, elems: int):
    """The batch shape of a key's words (their shape without the last
    axis of 1), their device, and how many elements of each key one step
    of the lane loop covers."""
    dev = k1.device if isinstance(k1, torch.Tensor) else (
        k2.device if isinstance(k2, torch.Tensor) else device)
    lead = torch.broadcast_shapes(torch.as_tensor(k1).shape, torch.as_tensor(k2).shape, (1,))[:-1]
    # lanes in groups: cache-sized operands on the CPU; on the card, groups
    # large enough that the launches of the ~170 integer ops do not dominate
    group = _CPU_LANES if torch.device(dev or "cpu").type == "cpu" else _CUDA_LANES
    return lead, dev, max(1, min(elems, group // max(1, math.prod(lead))))


def _partitionable_words(k, shape, device, out_dtype, finish) -> torch.Tensor:
    """(lead..., *shape) draw of the partitionable layout: element i of
    the flattened shape ciphers ``(i >> 32, i & 0xFFFFFFFF)``, and
    ``finish`` maps the xor of the two outputs to the stored values."""
    k1, k2 = k
    shape = tuple(int(s) for s in shape)
    total = math.prod(shape)
    lead, dev, step = _lead_and_step(k1, k2, device, total)
    out = torch.empty(lead + (total,), dtype=out_dtype, device=dev)
    for c in range(0, total, step):
        i = torch.arange(c, min(c + step, total), dtype=torch.int64, device=dev)
        y0, y1 = threefry2x32(k1, k2, (i >> 32).expand(lead + i.shape),
                              (i & MASK32).expand(lead + i.shape))
        out[..., c:c + i.numel()] = finish(y0.bitwise_xor_(y1))
    return out.reshape(lead + shape)


def bits(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32 values in an int64 tensor).
    The key's words may be ints or int64 tensors of shape (..., 1): a batch
    of keys draws a (..., *shape) table, each key's draw its own."""
    return _partitionable_words(k, shape, device, torch.int64, lambda b: b)


def uniform(k: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape)``: float32 in [0, 1) from the top 23
    of :func:`bits`'s 32 bits (batched keys as there)."""
    def to_float(b):
        words = b.bitwise_right_shift_(9).bitwise_or_(0x3F800000).to(torch.int32)
        return words.view(torch.float32) - 1.0

    return _partitionable_words(k, shape, device, torch.float32, to_float)


def counter_bits(k1, k2, total: int, device=None) -> torch.Tensor:
    """(..., total) int64 tensor of the key's uint32 bits in the counter
    layout (module docstring): one cipher call per lane, both outputs used.
    ``k1``/``k2`` are ints or int64 tensors of shape (..., 1)."""
    total = int(total)
    h = (total + 1) // 2
    lead, dev, step = _lead_and_step(k1, k2, device, max(h, 1))
    out = torch.empty(lead + (total,), dtype=torch.int64, device=dev)
    for c in range(0, h, step):
        lane = torch.arange(c, min(c + step, h), dtype=torch.int64, device=dev)
        hi = lane + h
        y0, y1 = threefry2x32(k1, k2, lane.expand(lead + lane.shape),
                              torch.where(hi < total, hi, 0).expand(lead + lane.shape))
        out[..., c:c + lane.numel()] = y0
        n1 = max(0, min(lane.numel(), total - h - c))
        out[..., h + c:h + c + n1] = y1[..., :n1]
    return out
