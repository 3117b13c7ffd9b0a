"""Fused gather-merge gossip: the Hopper port of the JAX package's
``kernels/gossip_mix.py`` Pallas kernels (``gossip_mix_nodes`` and
``gossip_mix``).

    out[n, :] = sum_k w[n, k] * X[rows[n, k], :]     (fp32 accumulate)

One CUDA kernel (``csrc/gossip_mix.cu``) computes it, reading each operand
row of X by index, so no (N, K, P) stack of operands is ever built.  Three
wrappers share it:

* :func:`gossip_mix_rows` — the kernel's own form;
* :func:`gossip_mix_nodes` and :func:`gossip_mix` — the reference's stacked
  (N, K, M) and flat (K, M) signatures, on identity rows (no index tensor);
* :func:`mix_rows` — the engine's form, the (1+D)-way merge of each node's
  own row with its neighbour rows.

A tensor on the CPU goes to the plain twin :func:`gossip_mix_rows_ref`.  A
CUDA tensor launches the kernel or raises: there is no fallback.  A
``meta`` tensor is checked as a CUDA one and gets an empty result (the dry
run's shape-only route).  While a dry-run counter is open the wrapper
charges :func:`merge_cost` on every device (``kernels/cost.py``).  The
kernel is compiled on its first CUDA call, never at import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.build import load_library

MAX_K = 64  # operand slots per receiver (the kernel's shared-memory table)
_ENTRY = {torch.float32: "gossip_mix_rows_f32", torch.bfloat16: "gossip_mix_rows_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype):
    fn = getattr(load_library("gossip_mix"), _ENTRY[dtype])
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def merge_tables(nbr, w, w_self):
    """(rows (N, 1+D) int32, weights (N, 1+D) fp32) of the engine's merge:
    slot 0 is the node itself with ``w_self``, then its neighbours."""
    n = nbr.shape[0]
    if n and (int(nbr.min()) < 0 or int(nbr.max()) >= n):
        raise ValueError("neighbor ids out of range [0, N)")
    self_ids = torch.arange(n, dtype=torch.int32, device=nbr.device)[:, None]
    rows = torch.cat([self_ids, nbr.to(torch.int32)], 1).contiguous()
    ws = torch.cat([w_self.to(torch.float32)[:, None], w.to(torch.float32)], 1).contiguous()
    return rows, ws


def gossip_mix_rows_ref(X, rows, w):
    """Plain twin of the kernel: per slot, an index-select of operand rows
    and a weighted fp32 sum, self slot first (the kernel's order).
    ``rows`` None means rows n*K + k."""
    n, k = w.shape
    rows = torch.arange(n * k, device=X.device).view(n, k) if rows is None else rows.long()
    acc = torch.zeros((n, X.shape[1]), dtype=torch.float32, device=X.device)
    for j in range(k):
        acc = acc + w[:, j:j + 1].float() * X.index_select(0, rows[:, j]).float()
    return acc.to(X.dtype)


def merge_cost(n: int, k: int, p: int, item: int, x_rows: int):
    """(flops, bytes) of out[n] = sum_k w[n,k] X[rows[n,k]]: 2·k·n·p fp32
    operations; ``x_rows`` rows of X read once, the (n, k) index and
    weight tables read once, out written once."""
    return 2 * k * n * p, x_rows * p * item + n * k * 8 + n * p * item


def _vec_width(X, out) -> int:
    """Elements per vector access: the widest power of two up to 16 bytes
    that divides both row strides and both base addresses (the kernel
    masks the row's ragged tail itself)."""
    item = X.element_size()
    v = 16 // item
    while v > 1 and (
        X.stride(0) % v or out.stride(0) % v
        or X.data_ptr() % (v * item) or out.data_ptr() % (v * item)
    ):
        v //= 2
    return v


def gossip_mix_rows(X, rows, w, out=None):
    """out[n] = sum_k w[n, k] * X[rows[n, k]].

    X (R, P) fp32 or bf16 with unit column stride; rows (N, K) int32 in
    [0, R), or None for rows n*K + k (then R >= N*K); w (N, K) fp32.
    Returns (N, P) in X's dtype, written into ``out`` when given.
    """
    dev = X.device
    if dev.type == "cpu" and not cost.counting():
        res = gossip_mix_rows_ref(X, rows, w)
        return res if out is None else out.copy_(res)
    if dev.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"gossip_mix_rows: unsupported device {dev}")
    if X.dtype not in _ENTRY:
        raise TypeError(f"gossip_mix_rows: X must be float32 or bfloat16, got {X.dtype}")
    if w.dtype != torch.float32 or (rows is not None and rows.dtype != torch.int32):
        raise TypeError("gossip_mix_rows: rows must be int32 and w float32")
    if X.dim() != 2 or w.dim() != 2 or (rows is not None and rows.shape != w.shape):
        raise ValueError(
            f"gossip_mix_rows: want X (R, P), rows (N, K) or None, w (N, K); got "
            f"{tuple(X.shape)}, {None if rows is None else tuple(rows.shape)}, {tuple(w.shape)}"
        )
    n, k = w.shape
    if not 0 < k <= MAX_K:
        raise ValueError(f"gossip_mix_rows: K={k} outside 1..{MAX_K}")
    if rows is None and X.shape[0] < n * k:
        raise ValueError(f"gossip_mix_rows: identity rows need {n * k} rows of X, got {X.shape[0]}")
    if w.device != dev or (rows is not None and rows.device != dev):
        raise ValueError("gossip_mix_rows: X, rows and w must share one device")
    if X.stride(1) != 1 or not w.is_contiguous() or not (rows is None or rows.is_contiguous()):
        raise ValueError("gossip_mix_rows: X rows, rows and w must be contiguous")
    if out is None:
        out = torch.empty((n, X.shape[1]), dtype=X.dtype, device=dev)
    elif (tuple(out.shape) != (n, X.shape[1]) or out.dtype != X.dtype
          or out.device != dev or out.stride(1) != 1):
        raise ValueError("gossip_mix_rows: out must be (N, P), X's dtype and device, unit column stride")
    # the rows a call can read: X's, or the n*k identity rows
    cost.charge("gossip_mix_rows",
                *merge_cost(n, k, X.shape[1], X.element_size(), min(X.shape[0], n * k)))
    if dev.type == "cpu":  # a dry-run counter is open: the twin's ops are not counted
        with cost.uncounted():
            out.copy_(gossip_mix_rows_ref(X, rows, w))
        return out
    if dev.type == "meta":
        return out
    args = (X.data_ptr(), X.stride(0), None if rows is None else rows.data_ptr(), w.data_ptr(),
            n, k, X.shape[1], out.data_ptr(), out.stride(0), _vec_width(X, out),
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = _entry(X.dtype)(*args)
    else:
        with torch.cuda.device(dev):
            err = _entry(X.dtype)(*args)
    if err != 0:
        raise RuntimeError(f"gossip_mix_rows: kernel launch failed with CUDA error {err}")
    gossip_mix_rows.launches += 1
    return out


gossip_mix_rows.launches = 0  # kernel launches since the last reset


def _weights(w):
    return w if w.dtype == torch.float32 and w.is_contiguous() else w.to(torch.float32).contiguous()


def gossip_mix_nodes(neighbors, weights):
    """neighbors (N, K, M), weights (N, K) -> (N, M): each receiver's K-way
    weighted merge of its own stacked operand rows."""
    n, k, m = neighbors.shape
    if tuple(weights.shape) != (n, k):
        raise ValueError(f"gossip_mix_nodes: weights {tuple(weights.shape)} for neighbors "
                         f"{tuple(neighbors.shape)}")
    return gossip_mix_rows(neighbors.reshape(n * k, m), None, _weights(weights))


def gossip_mix(neighbors, weights):
    """neighbors (K, M), weights (K,) -> (M,)."""
    if neighbors.dim() != 2 or weights.dim() != 1 or weights.shape[0] != neighbors.shape[0]:
        raise ValueError(f"gossip_mix: weights {tuple(weights.shape)} for neighbors "
                         f"{tuple(neighbors.shape)}")
    return gossip_mix_rows(neighbors, None, _weights(weights).view(1, -1))[0]


def mix_rows(X, nbr, w, w_self):
    """X (N, P), nbr (N, D), w (N, D), w_self (N,) -> (N, P):
    x_i' = w_self_i * x_i + sum_k w[i, k] * x_nbr[i, k]."""
    return gossip_mix_rows(X, *merge_tables(nbr, w, w_self))
