"""Threefry-2x32 keys and uniforms, frozen: the draws that the emulator's
random-k sharing keys from its seed (JAX's default PRNG: ``key(s)`` is the
words (0, s mod 2^32), ``fold_in(k, d)`` one cipher call on (0, d), and a
uniform of element i ciphers (i >> 32, i mod 2^32), xors the two outputs
and keeps the top 23 bits as the mantissa of a float in [1, 2), less 1).
Words are uint32 values held in int64 tensors."""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def cipher(k1, k2, x0, x1):
    """Threefry-2x32, 20 rounds: key words (k1, k2), counter words
    (x0, x1), ints or int64 tensors that broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) & MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int):
    return 0, int(seed) & MASK32


def fold_in(k, data):
    return cipher(k[0], k[1], 0, data & MASK32)


def uniform(k, n: int, device) -> torch.Tensor:
    """(rows, n) float32 uniforms of a batch of keys whose words are
    (rows, 1) int64 tensors, some 2^25 words at a time."""
    k1, k2 = k
    rows = torch.broadcast_shapes(k1.shape, k2.shape)[0]
    block = max(1, (1 << 25) // rows)
    out = torch.empty((rows, n), dtype=torch.float32, device=device)
    for c in range(0, n, block):
        i = torch.arange(c, min(c + block, n), dtype=torch.int64, device=device)[None, :]
        y0, y1 = cipher(k1, k2, (i >> 32).expand(rows, -1), (i & MASK32).expand(rows, -1))
        words = ((y0 ^ y1) >> 9) | 0x3F800000
        out[:, c:c + i.shape[1]] = words.to(torch.int32).view(torch.float32) - 1.0
    return out
