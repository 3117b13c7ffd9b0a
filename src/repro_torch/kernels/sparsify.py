"""Histogram top-k threshold: the Hopper port of the JAX package's
``kernels/sparsify.py`` (``abs_histogram_rows``, ``abs_histogram``,
``threshold_mask``, ``topk_threshold_rows``, ``topk_threshold``) and of
``kernels/ops.py topk_mask_approx``.

A per-row top-k of a multi-million-element parameter matrix without a
sort: one pass counts |x| per row into 128 log-spaced bins from max·1e-7
to max and picks the bracketing bin, a second pass counts into 128 linear
bins inside it.  The result is a per-row threshold t with
``#{|x| >= t} >= k``, within one fine bin of exactly k.

The counting pass is a CUDA kernel (``csrc/sparsify.cu``); the edges,
the picks and the cumulative sums around it are a few small torch ops on
(N, 128) tables.  :func:`topk_mask_approx` then keeps |x| >= t in one
pass of the same source's mask kernel, reading t on the device.  A tensor
on the CPU goes to the plain twins :func:`abs_histogram_rows_ref` and
:func:`threshold_mask_ref`; a CUDA tensor launches the kernel or raises:
there is no fallback.  The kernels are compiled on their first CUDA call,
never at import.

The edges go through ``exp`` and ``log``.  The port takes both in fp64 and
rounds to fp32, which gives the correctly rounded fp32 value on the card
and on the CPU alike, so the two devices pick the same thresholds from the
same data; XLA's fp32 ``exp``/``log`` miss the correct rounding by an ulp
now and then, so thresholds agree with the JAX package's to a few ulp in
the log domain.  Given the same edges, the counts are bitwise equal.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.build import load_library

NBINS = 128
MAX_EDGES = 1024  # the kernel's shared-memory histogram
_REF_CHUNK = 1 << 27  # compare elements per step of the plain twin


_P = ctypes.c_void_p
_ARGTYPES = {
    "abs_histogram_rows_f32": [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, _P,
                               ctypes.c_int, _P, _P],
    "threshold_mask_f32": [_P, ctypes.c_longlong, _P, _P, _P, _P],
}


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(load_library("sparsify"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def abs_histogram_rows_ref(x, edges):
    """Plain twin of the kernel, the compare-and-count of
    ``kernels/ref.py abs_histogram_rows_ref``: x (N, P), edges (N, E) ->
    (N, E+1) int32, bucket = #{e : |x| >= edges[e]} over every edge.
    Rows go in groups so that the (rows, P, E) compare stays bounded."""
    a = x.to(torch.float32).abs()
    e = edges.to(torch.float32)
    n, p = a.shape
    nb = e.shape[1] + 1
    hist = torch.zeros((n, nb), dtype=torch.int64, device=a.device)
    step = max(1, _REF_CHUNK // max(p * nb, 1))
    for r in range(0, n, step):
        idx = (a[r:r + step, :, None] >= e[r:r + step, None, :]).sum(2)
        hist[r:r + step].scatter_add_(1, idx, torch.ones_like(idx))
    return hist.to(torch.int32)


def abs_histogram_rows(x, edges):
    """x (N, P) fp32 with unit column stride, edges (N, E) per row ->
    (N, E+1) int32 counts of |x| per bucket #{e : |x| >= edges[e]}."""
    if x.device.type == "cpu":
        return abs_histogram_rows_ref(x, edges)
    if x.device.type != "cuda":
        raise ValueError(f"abs_histogram_rows: unsupported device {x.device}")
    if x.dtype != torch.float32 or edges.dtype != torch.float32:
        raise TypeError("abs_histogram_rows: x and edges must be float32")
    if x.dim() != 2 or edges.dim() != 2 or edges.shape[0] != x.shape[0]:
        raise ValueError(f"abs_histogram_rows: want x (N, P), edges (N, E); got "
                         f"{tuple(x.shape)}, {tuple(edges.shape)}")
    if x.stride(1) != 1 or not edges.is_contiguous() or edges.device != x.device:
        raise ValueError("abs_histogram_rows: x rows and edges must be contiguous, on one device")
    n, p = x.shape
    e = edges.shape[1]
    if e > MAX_EDGES:
        raise ValueError(f"abs_histogram_rows: E={e} above {MAX_EDGES}")
    hist = torch.empty((n, e + 1), dtype=torch.int32, device=x.device)  # the entry zeroes it
    with torch.cuda.device(x.device):
        err = _entry("abs_histogram_rows_f32")(
            x.data_ptr(), x.stride(0), n, p, edges.data_ptr(), e, hist.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"abs_histogram_rows: kernel launch failed with CUDA error {err}")
    abs_histogram_rows.launches += 1
    return hist


abs_histogram_rows.launches = 0  # kernel launches since the last reset


def abs_histogram(x, edges):
    """x (M,), edges (E,) -> (E+1,) int32: the N=1 form of the row kernel."""
    return abs_histogram_rows(x.reshape(1, -1), edges.reshape(1, -1).contiguous())[0]


def _span(nbins: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, nbins)`` as XLA computes it in fp32: i times
    fl(1/(nbins-1)), then 1.0 (XLA turns the division by the constant
    into a multiplication by its reciprocal)."""
    if nbins == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    inv = float(np.float32(1.0) / np.float32(nbins - 1))
    step = torch.arange(nbins - 1, dtype=torch.float32, device=device) * inv
    return torch.cat([step, torch.ones(1, dtype=torch.float32, device=device)])


def _exp(x):
    return torch.exp(x.double()).float()


def _log(x):
    return torch.log(x.double()).float()


def _pick_edge_rows(a, k: int, edges):
    """Per row, the largest edge with #{|x| >= edge} >= k (0 where none
    is), and the next edge up.  a: (N, P) values (the histogram takes
    their magnitudes), edges: (N, E)."""
    nbins = edges.shape[1]
    hist = abs_histogram_rows(a, edges)                          # (N, E+1)
    surv = hist.flip(1).cumsum(1).flip(1)[:, 1:]                 # #{a >= edges[e]}
    ok = surv >= k
    pos = (torch.arange(nbins, device=a.device)[None, :] * ok).argmax(1)
    t = torch.where(ok.any(1), edges.gather(1, pos[:, None])[:, 0], 0.0)
    t_hi = edges.gather(1, torch.clamp_max(pos + 1, nbins - 1)[:, None])[:, 0]
    return t, t_hi


def topk_threshold_rows(x, k: int, nbins: int = NBINS):
    """Per-row histogram top-k threshold: x (N, P) -> t (N,) fp32 with
    #{|x[n]| >= t[n]} >= k, within one fine bin of exactly k.  Two launches
    of the histogram kernel: coarse log bins, then linear bins inside the
    bracketing one.  The histogram takes |x| itself, so no (N, P)
    magnitude copy is kept."""
    a = x.to(torch.float32)
    hi = a.abs().amax(1)
    lo = torch.clamp_min(hi * 1e-7, 1e-30)
    span = _span(nbins, a.device)[None, :]
    edges = _exp(
        _log(lo)[:, None] * (1.0 - span)
        + _log(torch.clamp_min(hi, 1e-30))[:, None] * span
    )
    t0, t0_hi = _pick_edge_rows(a, k, edges)
    fine = t0[:, None] * (1.0 - span) + torch.maximum(t0_hi, t0 + 1e-30)[:, None] * span
    t1, _ = _pick_edge_rows(a, k, fine.contiguous())
    return torch.maximum(t0, t1)


def topk_threshold(x, k: int, nbins: int = NBINS):
    """The one-vector form: x (M,) -> 0-d threshold t with #{|x| >= t} >= k.
    (Where every |x| is 0 this gives t = 0; the reference's log edges are
    NaN there.)"""
    return topk_threshold_rows(x.reshape(1, -1), k, nbins)[0]


def threshold_mask_ref(x, threshold):
    """Plain twin of the mask kernel (``kernels/ref.py threshold_mask_ref``):
    (x where |x| >= threshold else 0, the bool mask)."""
    keep = x.to(torch.float32).abs() >= threshold
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device)), keep


def threshold_mask(x, threshold):
    """x (M,) fp32, threshold a float or a one-element fp32 tensor ->
    (values (M,) fp32, mask (M,) bool)."""
    if x.device.type == "cpu":
        return threshold_mask_ref(x, threshold)
    if x.device.type != "cuda":
        raise ValueError(f"threshold_mask: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("threshold_mask: x must be a contiguous (M,) float32 tensor")
    if isinstance(threshold, torch.Tensor):
        if threshold.numel() != 1 or threshold.dtype != torch.float32 or threshold.device != x.device:
            raise ValueError("threshold_mask: threshold must be one float32 on x's device")
        t = threshold.reshape(1).contiguous()
    else:
        t = torch.full((1,), float(threshold), dtype=torch.float32, device=x.device)
    vals = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    with torch.cuda.device(x.device):
        err = _entry("threshold_mask_f32")(
            x.data_ptr(), x.shape[0], t.data_ptr(), vals.data_ptr(), mask.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"threshold_mask: kernel launch failed with CUDA error {err}")
    threshold_mask.launches += 1
    return vals, mask


threshold_mask.launches = 0  # kernel launches since the last reset


def topk_mask_approx(x, k: int):
    """Histogram-threshold approximate top-k of x (M,): (values, mask,
    threshold), as ``kernels/ops.py topk_mask_approx`` returns them."""
    t = topk_threshold(x, k)
    vals, mask = threshold_mask(x, t)
    return vals, mask, t
