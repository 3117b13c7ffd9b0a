"""Compression module (paper §2.2): the per-row int8 codec carried in
gossip messages, through the hand-written codec kernels
(``kernels/quantize.py``).  Codes and scales are bitwise the JAX package's
``core/compression.py`` under ``jit``.

Stochastic rounding (``key`` given) takes its noise from
``repro_torch.prng.uniform``, bitwise ``jax.random.uniform``, into the
quantize kernel's noise form.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels.quantize import dequantize, quantize


def quantize_int8(x, key=None):
    """Per-row symmetric int8 quantization, optionally with stochastic
    rounding: floor(x / scale + u), u uniform in [0, 1).

    x: (..., P) float -> (codes int8 (..., P), scale (..., 1) float32).
    key: None (round to nearest), one ``prng`` key (u drawn over x's whole
    shape, as ``jax.random.uniform(key, x.shape)``), or a batch of keys
    whose words have shape (L..., 1) for x's leading axes L (key l draws
    the rest of x's shape: ``vmap`` of the single-key form over L).
    """
    rows = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    noise = None
    if key is not None:
        lead = torch.broadcast_shapes(torch.as_tensor(key[0]).shape,
                                      torch.as_tensor(key[1]).shape, (1,))[:-1]
        if tuple(x.shape[:len(lead)]) != tuple(lead):
            raise ValueError(f"quantize_int8: keys of batch shape {tuple(lead)} do not lead "
                             f"x's shape {tuple(x.shape)}")
        noise = prng.uniform(key, x.shape[len(lead):], device=x.device).reshape(rows.shape)
    codes, scale = quantize(rows, noise)
    return codes.reshape(x.shape), scale.reshape(*x.shape[:-1], 1)


def dequantize_int8(codes, scale):
    """codes (..., P) int8, scale (..., 1) fp32 -> (..., P) fp32."""
    flat = dequantize(codes.reshape(-1, codes.shape[-1]).contiguous(),
                      scale.reshape(-1, 1).contiguous())
    return flat.reshape(codes.shape)
