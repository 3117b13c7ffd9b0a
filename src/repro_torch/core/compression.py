"""Compression module (paper §2.2): the per-row int8 codec carried in
gossip messages, through the hand-written codec kernels
(``kernels/quantize.py``).  Codes and scales are bitwise the JAX package's
``core/compression.py`` under ``jit``.

Stochastic rounding (``key`` given) needs the reference's Threefry draws
and is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import dequantize, quantize


def quantize_int8(x, key=None):
    """Per-row symmetric int8 quantization.

    x: (..., P) float -> (codes int8 (..., P), scale (..., 1) float32).
    """
    if key is not None:
        raise NotImplementedError(
            "stochastic rounding (quantize_int8 with a key) is not ported yet"
        )
    rows = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    codes, scale = quantize(rows)
    return codes.reshape(x.shape), scale.reshape(*x.shape[:-1], 1)


def dequantize_int8(codes, scale):
    """codes (..., P) int8, scale (..., 1) fp32 -> (..., P) fp32."""
    flat = dequantize(codes.reshape(-1, codes.shape[-1]).contiguous(),
                      scale.reshape(-1, 1).contiguous())
    return flat.reshape(codes.shape)
