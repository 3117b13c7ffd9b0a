"""Per-row symmetric int8 codec: the Hopper port of the JAX package's
``kernels/quantize.py`` Pallas kernels (``quantize`` and ``dequantize``).

    scale[r] = max(max_c |x[r, c]| * fl(1/127), 1e-12)
    codes    = clip(round(x / scale), ±127)          or, given noise,
    codes    = clip(floor(x / scale + noise), ±127)  (stochastic rounding)
    x_hat    = codes * scale

One CUDA source (``csrc/quantize.cu``) holds both kernels.  Codes and
scales are bitwise those of the reference as XLA compiles it: under ``jit``
XLA turns the division by the constant 127 into a multiplication by its
fp32 reciprocal ``fl(1/127)`` (the Pallas kernel, and the JAX engine's
codec, compute that product; only the reference called op by op divides,
and its scale then differs by at most one rounding).  ``x / scale`` is an
IEEE division, rounding is half to even, and nothing is fused.  A NaN
propagates as in the reference: a row holding one gets a NaN scale and
codes 0, so it comes back all NaN.

A tensor on the CPU goes to the plain twins :func:`quantize_ref` and
:func:`dequantize_ref`.  A CUDA tensor launches the kernel or raises: there
is no fallback.  The kernels are compiled on their first CUDA call, never
at import.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import cost
from repro_torch.kernels.build import load_library

INV_127 = float(np.float32(1.0) / np.float32(127.0))  # fl(1/127), exact as a double

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _entry(name):
    lib = load_library("quantize")
    fn = getattr(lib, name)
    fn.argtypes = {
        "quantize_rows_f32": [_P, _LL, _P, _LL, ctypes.c_int, _LL, _P, _LL, _P, _P],
        "dequantize_rows_f32": [_P, _LL, _P, ctypes.c_int, _LL, _P, _LL, _P],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def quantize_ref(x, noise=None):
    """Plain twin of the quantize kernel (``kernels/ref.py quantize_ref``
    under ``jit``): x (R, C) -> (codes (R, C) int8, scale (R, 1) fp32)."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) * INV_127, 1e-12)
    y = xf / scale
    y = torch.round(y) if noise is None else torch.floor(y + noise.to(torch.float32))
    # a NaN (from a row holding one, whose scale is NaN) becomes code 0, as in XLA
    return torch.nan_to_num(torch.clamp(y, -127, 127), nan=0.0).to(torch.int8), scale


def dequantize_ref(codes, scale):
    """Plain twin of the dequantize kernel: codes * scale in fp32."""
    return codes.to(torch.float32) * scale


def _check_rows(name, t, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
    if t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name}: want a 2-D tensor with unit column stride, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")


def codec_cost(r: int, c: int, noisy: bool, encode: bool = True):
    """(flops, bytes) of one codec call over (R, C): quantize reads x (and
    the noise) and writes the codes and the scale, with abs, max, divide,
    round and clamp per element; dequantize reads the codes and the scale
    and writes fp32, one multiply per element."""
    if encode:
        return 6 * r * c, r * c * (4 + 1 + (4 if noisy else 0)) + r * 4
    return r * c, r * c * (1 + 4) + r * 4


def quantize(x, noise=None):
    """x (R, C) fp32 [, noise (R, C) fp32 uniforms in [0, 1)] ->
    (codes (R, C) int8, scale (R, 1) fp32).  A ``meta`` tensor gets empty
    results (the dry run's shape-only route); while a dry-run tally is
    open the call charges :func:`codec_cost` on every device."""
    if x.device.type == "cpu" and not cost.counting():
        return quantize_ref(x, noise)
    if x.device.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"quantize: unsupported device {x.device}")
    _check_rows("quantize x", x, torch.float32)
    r, c = x.shape
    if noise is not None:
        _check_rows("quantize noise", noise, torch.float32)
        if tuple(noise.shape) != (r, c) or noise.device != x.device:
            raise ValueError("quantize: noise must match x's shape and device")
    cost.charge("quantize", *codec_cost(r, c, noise is not None))
    if x.device.type == "cpu":  # a dry-run tally is open: the twin's ops are not counted
        with cost.uncounted():
            return quantize_ref(x, noise)
    codes = torch.empty((r, c), dtype=torch.int8, device=x.device)
    scale = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        return codes, scale
    with torch.cuda.device(x.device):
        err = _entry("quantize_rows_f32")(
            x.data_ptr(), x.stride(0),
            None if noise is None else noise.data_ptr(),
            0 if noise is None else noise.stride(0),
            r, c, codes.data_ptr(), codes.stride(0), scale.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"quantize: kernel launch failed with CUDA error {err}")
    quantize.launches += 1
    return codes, scale


def dequantize(codes, scale):
    """codes (R, C) int8, scale (R, 1) fp32 -> (R, C) fp32 (``meta`` and
    dry-run tallies as :func:`quantize`)."""
    if codes.device.type == "cpu" and not cost.counting():
        return dequantize_ref(codes, scale)
    if codes.device.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"dequantize: unsupported device {codes.device}")
    _check_rows("dequantize codes", codes, torch.int8)
    r, c = codes.shape
    if (scale.dtype != torch.float32 or scale.numel() != r
            or scale.device != codes.device or not scale.is_contiguous()):
        raise ValueError("dequantize: scale must be (R, 1) contiguous fp32 on codes' device")
    cost.charge("dequantize", *codec_cost(r, c, False, encode=False))
    if codes.device.type == "cpu":
        with cost.uncounted():
            return dequantize_ref(codes, scale)
    out = torch.empty((r, c), dtype=torch.float32, device=codes.device)
    if codes.device.type == "meta":
        return out
    with torch.cuda.device(codes.device):
        err = _entry("dequantize_rows_f32")(
            codes.data_ptr(), codes.stride(0), scale.data_ptr(), r, c,
            out.data_ptr(), out.stride(0),
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dequantize: kernel launch failed with CUDA error {err}")
    dequantize.launches += 1
    return out


quantize.launches = 0    # kernel launches since the last reset
dequantize.launches = 0
