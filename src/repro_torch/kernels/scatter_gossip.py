"""Payload-indexed gossip merge: the Hopper port of the JAX package's
``kernels/scatter_gossip.py`` Pallas kernel (``payload_mix_nodes``).

DecentralizePy's missing-coordinate rule over sparse payloads: receiver n
merges the (idx, val) payloads of its S operand slots, and a coordinate
absent from a payload falls back to the receiver's own value,

    out[n] = X[n] + sum_s scatter(idx[r], (val[r] - X[n][idx[r]]) * w[n, s]),
             r = rows[n, s]

One CUDA kernel (``csrc/scatter_gossip.cu``) computes it over column tiles
of every receiver, reading each sender's payload row by index, so no
(N, S, k) stack of operands is built.  The kernel finds a tile's entries by
searching each payload row, so it takes rows sorted by index: a caller
that knows its rows are sorted says so with ``sorted_idx=True`` (the
histogram top-k selector emits them in index order); otherwise the wrapper
sorts each (idx, val) row by index first (:func:`sort_payload_rows`),
which changes no bit of the result where indices are distinct within a
row.  Two wrappers share the kernel:

* :func:`payload_mix_rows` — the kernel's own form, the engine's;
* :func:`payload_mix_nodes` — the reference's stacked (N, K, k) signature.

The kernel applies the slots in order and is deterministic when indices
are distinct within each slot (every strategy's payload is).  A tensor on
the CPU goes to the plain twin :func:`payload_mix_rows_ref`, which adds in
the kernel's order; a CUDA tensor launches the kernel or raises: there is
no fallback.  The kernel is compiled on its first CUDA call, never at
import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.build import load_library


@functools.lru_cache(maxsize=None)
def _entry():
    fn = load_library("scatter_gossip").payload_mix_rows_f32
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [P, LL, P, LL, P, LL, I, P, P, I, I, LL, P, LL, P]
    fn.restype = ctypes.c_int
    return fn


def payload_mix_rows_ref(X, idx, val, rows, w):
    """Plain twin of the kernel: per slot in order, gather the senders'
    payloads and scatter-add (val - X[n][idx]) * w into a copy of X."""
    Xf = X.to(torch.float32)
    out = Xf.clone()
    rows = rows.long()
    for s in range(rows.shape[1]):
        ii = idx.index_select(0, rows[:, s]).long()
        vv = val.index_select(0, rows[:, s]).to(torch.float32)
        out.scatter_add_(1, ii, (vv - Xf.gather(1, ii)) * w[:, s:s + 1].to(torch.float32))
    return out


def sort_payload_rows(idx, val):
    """Each (idx, val) row sorted by index, as the kernel takes it: one
    ``torch.sort`` of idx and a ``gather`` of val.  Contiguous results."""
    idx, order = torch.sort(idx, dim=1)
    return idx, val.gather(1, order)


def payload_cost(n: int, p: int, r: int, k: int, s: int):
    """(flops, bytes) of one payload merge: X read and out written once,
    the (R, k) idx and val payloads and the (N, S) tables read once; a
    subtract, a multiply and an add per operand entry."""
    return 3 * n * s * k, 2 * n * p * 4 + r * k * 8 + n * s * 8


def payload_mix_rows(X, idx, val, rows, w, *, sorted_idx: bool = False):
    """out[n] = X[n] + sum_s scatter(idx[rows[n, s]],
    (val[rows[n, s]] - X[n][idx[rows[n, s]]]) * w[n, s]).

    X (N, P) fp32 and idx (R, k) int32 / val (R, k) fp32 with unit column
    stride; rows (N, S) int32 in [0, R); w (N, S) fp32.  sorted_idx: the
    caller's promise that every idx row is non-decreasing; without it the
    rows are sorted first.  Returns a new (N, P) fp32 tensor.  A ``meta``
    tensor gets an empty result (the dry run's shape-only route); while a
    dry-run tally is open the call charges :func:`payload_cost` on every
    device.
    """
    if X.device.type == "cpu" and not cost.counting():
        return payload_mix_rows_ref(X, idx, val, rows, w)
    if X.device.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"payload_mix_rows: unsupported device {X.device}")
    if (X.dtype != torch.float32 or val.dtype != torch.float32 or w.dtype != torch.float32
            or idx.dtype != torch.int32 or rows.dtype != torch.int32):
        raise TypeError("payload_mix_rows: X, val and w must be float32, idx and rows int32")
    if (X.dim() != 2 or idx.dim() != 2 or tuple(val.shape) != tuple(idx.shape)
            or rows.dim() != 2 or tuple(w.shape) != tuple(rows.shape)
            or rows.shape[0] != X.shape[0]):
        raise ValueError(
            f"payload_mix_rows: want X (N, P), idx/val (R, k), rows/w (N, S); got "
            f"{tuple(X.shape)}, {tuple(idx.shape)}, {tuple(val.shape)}, "
            f"{tuple(rows.shape)}, {tuple(w.shape)}"
        )
    if any(t.device != X.device for t in (idx, val, rows, w)):
        raise ValueError("payload_mix_rows: all operands must share one device")
    if (X.stride(1) != 1 or idx.stride(1) != 1 or val.stride(1) != 1
            or not rows.is_contiguous() or not w.is_contiguous()):
        raise ValueError("payload_mix_rows: rows of X, idx and val and the tables must be contiguous")
    n, p = X.shape
    cost.charge("payload_mix_rows", *payload_cost(n, p, idx.shape[0], idx.shape[1],
                                                  rows.shape[1]))
    if X.device.type == "cpu":  # a dry-run tally is open: the twin's ops are not counted
        with cost.uncounted():
            return payload_mix_rows_ref(X, idx, val, rows, w)
    if not sorted_idx:
        idx, val = sort_payload_rows(idx, val)
    out = torch.empty((n, p), dtype=torch.float32, device=X.device)
    if X.device.type == "meta":
        return out
    with torch.cuda.device(X.device):
        err = _entry()(
            X.data_ptr(), X.stride(0), idx.data_ptr(), idx.stride(0),
            val.data_ptr(), val.stride(0), idx.shape[1], rows.data_ptr(),
            w.data_ptr(), n, rows.shape[1], p, out.data_ptr(), out.stride(0),
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"payload_mix_rows: kernel launch failed with CUDA error {err}")
    payload_mix_rows.launches += 1
    return out


payload_mix_rows.launches = 0  # kernel launches since the last reset


def payload_mix_nodes(x, idx, val, w):
    """x (N, P); idx (N, K, k) int32; val (N, K, k); w (N, K) -> (N, P)
    fp32: each receiver's merge of its own stacked operand payloads."""
    n, K, k = idx.shape
    rows = torch.arange(n * K, dtype=torch.int32, device=x.device).view(n, K)
    return payload_mix_rows(
        x.to(torch.float32), idx.reshape(n * K, k).to(torch.int32),
        val.reshape(n * K, k).to(torch.float32), rows,
        w.to(torch.float32).contiguous(),
    )
