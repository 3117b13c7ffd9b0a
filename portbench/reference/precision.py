"""The references' precision: float32 products, as the configurations
state, or for the control TF32, the step below, emulated alike on every
device.  At TF32 each product's operands are rounded to TF32's 10-bit
mantissa (round to nearest, ties to even) in the forward pass, and the
gradient reaching its output in the backward pass, so the forward product
and both backward products read TF32 operands and accumulate in float32,
as the tensor cores do.  Either way the card's own TF32 paths are off
(cuDNN's convolutions take them by default), so that a product rounds
only where this module rounds it."""
from __future__ import annotations

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    i = t.contiguous().view(torch.int32)
    r = (i + (0x0FFF + ((i >> 13) & 1))) & ~0x1FFF
    return r.view(torch.float32).view(t.shape)


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):  # noqa: D102
        return round_tf32(t)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class Products:
    """``op(x)`` and ``out(y)`` around every product: identities at
    float32, the rounding above at TF32."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def op(self, t):
        return _Operand.apply(t) if self.tf32 else t

    def out(self, t):
        return _Output.apply(t) if self.tf32 else t
