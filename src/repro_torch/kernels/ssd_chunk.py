"""Mamba2 SSD intra-chunk step: the Hopper port of the JAX package's
``kernels/ssd_chunk.py`` Pallas kernel (``ssd_chunk``).  [arXiv:2405.21060]

Per chunk cell g (batch x chunk) and head h, with L positions per chunk:

    y[i]   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xdt[j]
    state  = sum_j (B_j exp(cum_{L-1} - cum_j))^T xdt[j]       (N, P)
    decay  = exp(cum_{L-1})

One CUDA kernel (``csrc/ssd_chunk.cu``) computes all three, reading the
inputs through their strides: C·Bᵀ once per cell and 64-row tile, shared
by the heads (B and C have one group), and every product on the tensor
cores as three TF32 products of an fp32 split (3xTF32), which keeps fp32
accuracy.  It takes L <= ``MAX_L``.  A tensor on the CPU goes to the plain
twin :func:`ssd_chunk_ref`; a CUDA tensor launches the kernel or raises;
a ``meta`` tensor is checked as a CUDA one and gets empty results.  While
a dry-run counter is open the wrapper charges :func:`ssd_cost` on every
device (``kernels/cost.py``).  The kernel is compiled on its first CUDA
call, never at import.

:func:`ssd_scan` (the twin of the reference's ``kernels/ops.py ssd_scan``)
adds the inter-chunk recurrence, which stays plain torch as in the
reference.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.build import load_library

MAX_P = 128            # head dim the kernel takes (two 64-column passes)
MAX_L = 256            # chunk length: a 64-row tile's C·Bᵀ row lives in shared memory
MAX_SMEM = 232_448     # shared memory one block may use on Hopper


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("ssd_chunk")
    lib.ssd_chunk_f32.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3          # xdt
        + [ctypes.c_void_p] + [ctypes.c_longlong] * 2        # B
        + [ctypes.c_void_p] + [ctypes.c_longlong] * 2        # C
        + [ctypes.c_void_p] + [ctypes.c_longlong] * 3        # cum
        + [ctypes.c_void_p] * 3                              # y, state, decay
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]             # G, L, H, N, P, stream
    )
    lib.ssd_chunk_f32.restype = ctypes.c_int
    lib.ssd_chunk_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
    return lib


def ssd_cost(g: int, l: int, h: int, p: int, n: int, products: int = 1):
    """(flops, bytes): two flops per multiply-add of C·Bᵀ once per chunk
    cell over j <= i, the causal half of scores @ xdt per head and the
    state product per head, each multiply-add taken ``products`` times (3
    for the kernel's 3xTF32); xdt, B, C and cum read once, y, state and
    decay written once (fp32)."""
    tri = l * (l + 1) // 2
    flops = 2 * products * (g * tri * n + g * h * tri * p + g * h * l * n * p)
    return flops, 4 * (2 * g * l * h * p + 2 * g * l * n + g * l * h + g * h * n * p + g * h)


def ssd_chunk_ref(xdt, Bc, Cc, cum):
    """Plain twin: ``ref.ssd_chunk_ref`` batched over the chunk cells.

    xdt (G, L, H, P), Bc/Cc (G, L, N), cum (G, L, H), fp32 ->
    (y (G, L, H, P), state (G, H, N, P), decay (G, H))."""
    L = xdt.shape[1]
    xdt, Bc, Cc, cum = xdt.float(), Bc.float(), Cc.float(), cum.float()
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xdt.device))
    diff = cum[:, :, None, :] - cum[:, None, :, :]                     # (G, L, L, H)
    decay = torch.where(tri[None, :, :, None], torch.exp(diff), torch.zeros((), device=xdt.device))
    cb = torch.einsum("gin,gjn->gij", Cc, Bc)
    y = torch.einsum("gijh,gjhp->gihp", cb[..., None] * decay, xdt)
    to_end = torch.exp(cum[:, -1:, :] - cum)                            # (G, L, H)
    state = torch.einsum("gjn,gjhp->ghnp", Bc, xdt * to_end[..., None])
    return y, state, torch.exp(cum[:, -1])


def ssd_chunk(xdt, Bc, Cc, cum):
    """Batched intra-chunk SSD; the signature of the reference's
    ``ops.ssd_chunk``.  All four fp32 with unit stride over their last axis
    (any other strides)."""
    if xdt.device.type == "cpu" and not cost.counting():
        return ssd_chunk_ref(xdt, Bc, Cc, cum)
    if xdt.device.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"ssd_chunk: unsupported device {xdt.device}")
    if any(t.dtype != torch.float32 for t in (xdt, Bc, Cc, cum)):
        raise TypeError("ssd_chunk: xdt, B, C and cum must be float32")
    if any(t.device != xdt.device for t in (Bc, Cc, cum)):
        raise ValueError("ssd_chunk: all inputs must share one device")
    if xdt.dim() != 4 or Bc.dim() != 3 or Cc.dim() != 3 or cum.dim() != 3:
        raise ValueError("ssd_chunk: want xdt (G, L, H, P), B/C (G, L, N), cum (G, L, H)")
    G, L, H, P = xdt.shape
    N = Bc.shape[2]
    if (tuple(Bc.shape) != (G, L, N) or tuple(Cc.shape) != (G, L, N)
            or tuple(cum.shape) != (G, L, H)):
        raise ValueError(
            f"ssd_chunk: shapes {tuple(xdt.shape)}, {tuple(Bc.shape)}, {tuple(Cc.shape)}, "
            f"{tuple(cum.shape)} do not agree")
    if xdt.stride(3) != 1 or Bc.stride(2) != 1 or Cc.stride(2) != 1:
        raise ValueError("ssd_chunk: xdt, B and C need unit stride over their last axis")
    if not 0 < P <= MAX_P or not 0 < L <= MAX_L or N <= 0:
        raise ValueError(f"ssd_chunk: L={L}, N={N}, P={P} outside what the kernel takes "
                         f"(P <= {MAX_P}, L <= {MAX_L})")
    y = torch.empty((G, L, H, P), dtype=torch.float32, device=xdt.device)
    st = torch.empty((G, H, N, P), dtype=torch.float32, device=xdt.device)
    dec = torch.empty((G, H), dtype=torch.float32, device=xdt.device)
    cost.charge("ssd_chunk", *ssd_cost(G, L, H, P, N))
    if xdt.device.type == "cpu":  # a dry-run counter is open: the twin's ops are not counted
        with cost.uncounted():
            for dst, src in zip((y, st, dec), ssd_chunk_ref(xdt, Bc, Cc, cum)):
                dst.copy_(src)
        return y, st, dec
    if xdt.device.type == "meta":
        return y, st, dec
    lib = _lib()
    smem = lib.ssd_chunk_smem_bytes(N, P)
    if not 0 < smem <= MAX_SMEM:
        raise ValueError(f"ssd_chunk: N={N}, P={P} need {smem} bytes of shared memory "
                         f"(at most {MAX_SMEM})")
    with torch.cuda.device(xdt.device):
        err = lib.ssd_chunk_f32(
            xdt.data_ptr(), xdt.stride(0), xdt.stride(1), xdt.stride(2),
            Bc.data_ptr(), Bc.stride(0), Bc.stride(1),
            Cc.data_ptr(), Cc.stride(0), Cc.stride(1),
            cum.data_ptr(), cum.stride(0), cum.stride(1), cum.stride(2),
            y.data_ptr(), st.data_ptr(), dec.data_ptr(), G, L, H, N, P,
            torch.cuda.current_stream(xdt.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_chunk: kernel launch failed with CUDA error {err}")
    ssd_chunk.launches += 1
    return y, st, dec


ssd_chunk.launches = 0  # kernel launches since the last reset


def inter_chunk(y_intra, states, dec, Cc, cum):
    """The inter-chunk recurrence over chunks (plain torch, as the
    reference's ``lax.scan``): the state entering each chunk, decayed into
    every position and read out by C.  y_intra (B, nc, L, H, P), states
    (B, nc, H, N, P), dec (B, nc, H), Cc (B, nc, L, N), cum (B, nc, L, H)
    -> y (B, nc, L, H, P)."""
    h = torch.zeros_like(states[:, 0])
    before = []
    for c in range(states.shape[1]):
        before.append(h)
        h = h * dec[:, c, :, None, None] + states[:, c]
    h_before = torch.stack(before, 1)                                  # (B, nc, H, N, P)
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cc.float(), h_before) * torch.exp(cum)[..., None]
    return y_intra + y_inter


def ssd_scan(xdt, Bc, Cc, cum):
    """Full SSD over chunks: the intra-chunk kernel and the inter-chunk
    recurrence.  xdt (B, nc, L, H, P); Bc/Cc (B, nc, L, N); cum
    (B, nc, L, H) -> y (B, nc, L, H, P)."""
    B, nc, L, H, P = xdt.shape
    N = Bc.shape[-1]
    g = lambda t: t.reshape(B * nc, *t.shape[2:])
    y, st, dec = ssd_chunk(g(xdt), g(Bc), g(Cc), g(cum))
    return inter_chunk(y.view(B, nc, L, H, P), st.view(B, nc, H, N, P), dec.view(B, nc, H),
                       Cc, cum)
