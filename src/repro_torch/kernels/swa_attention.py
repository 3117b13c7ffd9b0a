"""Causal sliding-window flash attention: the Hopper port of the JAX
package's ``kernels/swa_attention.py`` Pallas kernel (``swa_attention``).

    out[b, i, h] = softmax_{i - window < j <= i}(q[b, i, h] . k[b, j, h // G] / sqrt(D))
                   @ v[b, j, h // G]

``csrc/swa_attention.cu`` computes it by one of two kernels, chosen by the
dtype (:func:`_route`): bf16 on the tensor cores (``"mma"``: bf16 products,
fp32 softmax and accumulation, P rounded to bf16 before P·V), fp32 in plain
fp32 FMAs (``"simt"``).  Output in the input dtype.  Two wrappers share
them:

* :func:`swa_attention_gqa` — the kernel's own form, in the layout
  ``attn_apply`` holds: q (B, S, H, D), k/v (B, S, Hkv, D); each query head
  reads its KV head by index, so no repeated or transposed copy is made;
* :func:`swa_attention` — the reference's (BH, S, D) signature.

A tensor on the CPU goes to the plain twin :func:`swa_attention_gqa_ref`;
a CUDA tensor launches the kernel or raises; a ``meta`` tensor is checked
as a CUDA one and gets an empty result.  While a dry-run counter is open
the wrapper charges :func:`swa_cost` on every device
(``kernels/cost.py``).  The kernel is compiled on its first CUDA call,
never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.build import load_library

BQ = BK = 128     # the reference kernel's block sizes: S and window multiples of them
NEG_INF = -1e30   # the reference's mask value
MAX_D = 128
_ENTRY = {"simt": "swa_attention_f32", "mma": "swa_attention_bf16_mma"}


def _route(dtype, D: int) -> str:
    """The kernel a CUDA tensor takes: ``"mma"`` (tensor cores) for bf16,
    ``"simt"`` (fp32 FMAs, full fp32 numerics) for fp32.  No fallback
    between them."""
    if not 0 < D <= MAX_D:
        raise ValueError(f"swa_attention: head dim {D} outside 1..{MAX_D}")
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "simt"
    raise TypeError(f"swa_attention: q, k, v must be float32 or bfloat16, got {dtype}")


@functools.lru_cache(maxsize=None)
def _entry(route):
    fn = getattr(load_library("swa_attention"), _ENTRY[route])
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3) * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def swa_cost(b: int, s: int, h: int, hkv: int, d: int, window: int, item: int):
    """(flops, bytes): 4·D flops per in-window (query, key) pair (q·k and
    p·v) against q, k, v read once and out written once."""
    w = min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w   # sum over queries of min(i + 1, window)
    return 4 * d * pairs * b * h, b * s * (2 * h + 2 * hkv) * d * item


def swa_attention_gqa_ref(q, k, v, window: int):
    """Plain twin: ``ref.swa_attention_ref`` per head, with query head h
    reading KV head h // G.  fp32 scores and softmax, output in q's dtype."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, S, Hkv, H // Hkv, D)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * (D ** -0.5)
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    w = torch.softmax(torch.where(mask, s, torch.full((), NEG_INF, device=q.device)), dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return o.reshape(B, S, H, D).to(q.dtype)


def swa_attention_gqa(q, k, v, window: int):
    """q (B, S, H, D), k/v (B, S, Hkv, D) with H % Hkv == 0 -> (B, S, H, D)
    in q's dtype.  fp32 or bf16, one dtype for all three, unit stride over
    D (any other strides); 1 <= D <= 128."""
    if q.device.type == "cpu" and not cost.counting():
        return swa_attention_gqa_ref(q, k, v, window)
    if q.device.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"swa_attention: unsupported device {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"swa_attention: q, k, v must share one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("swa_attention: q, k and v must share one device")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"swa_attention: want q (B, S, H, D), k/v (B, S, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    route = _route(q.dtype, D)
    if k.shape[:2] != q.shape[:2] or k.shape[3] != D or H % Hkv:
        raise ValueError(f"swa_attention: q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         f"agree (H % Hkv == 0, 1 <= D <= {MAX_D})")
    if int(window) < 1:
        raise ValueError(f"swa_attention: window {window} < 1")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("swa_attention: q, k and v need unit stride over D")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    cost.charge("swa_attention_gqa", *swa_cost(B, S, H, Hkv, D, int(window), q.element_size()))
    if q.device.type == "cpu":  # a dry-run counter is open: the twin's ops are not counted
        with cost.uncounted():
            out.copy_(swa_attention_gqa_ref(q, k, v, window))
        return out
    if q.device.type == "meta":
        return out
    with torch.cuda.device(q.device):
        err = _entry(route)(
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k.data_ptr(), k.stride(0), k.stride(1), k.stride(2),
            v.data_ptr(), v.stride(0), v.stride(1), v.stride(2),
            out.data_ptr(), out.stride(0), out.stride(1), out.stride(2),
            B, S, H, Hkv, D, int(window), D ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"swa_attention: kernel launch failed with CUDA error {err}")
    swa_attention_gqa.launches += 1
    return out


swa_attention_gqa.launches = 0  # kernel launches since the last reset


def swa_attention(q, k, v, window: int):
    """The reference's signature: q, k, v (BH, S, D), batch and heads
    merged -> (BH, S, D)."""
    return swa_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None], window)[:, :, 0]
