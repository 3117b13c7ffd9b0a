"""Compression module (paper §2.2): the per-row int8 codec carried in
gossip messages, through the hand-written codec kernels
(``kernels/quantize.py``), the packed int4 codec and the delta index codec
(plain torch: the JAX package has no kernel for them either), and the cold
population-row codec of the async cohort path (``DLConfig.cold_dtype``).
Codes and scales are bitwise the JAX package's ``core/compression.py``
under ``jit``.

Stochastic rounding (``key`` given) takes its noise from
``repro_torch.prng.uniform``, bitwise ``jax.random.uniform``, into the
quantize kernel's noise form.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels.quantize import dequantize, quantize

# fl(1/7): XLA turns the int4 codec's division by the constant 7 into a
# multiplication by its fp32 reciprocal, as it does for int8's 127
INV_7 = float(np.float32(1.0) / np.float32(7.0))


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


def quantize_int4(x, key=None):
    """Packed int4 symmetric quantization, per row: codes clip(round(x /
    scale), ±7) (or floor(x / scale + u) with a ``prng`` key, u drawn over
    x's shape), biased by 8 and packed two to a byte, even columns in the
    low nibble.

    x: (..., P) float, P even -> (packed uint8 (..., P/2), scale (..., 1)
    float32)."""
    if x.shape[-1] % 2:
        raise ValueError(f"quantize_int4 packs pairs of columns; the last axis of "
                         f"{tuple(x.shape)} is odd")
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) * INV_7, 1e-12)
    y = xf / scale
    if key is not None:
        y = torch.floor(y + prng.uniform(key, y.shape, device=x.device))
    else:
        y = torch.round(y)
    q = (torch.nan_to_num(torch.clamp(y, -7, 7), nan=0.0).to(torch.int8) + 8).to(torch.uint8)
    return q[..., 0::2] | (q[..., 1::2] << 4), scale


def dequantize_int4(packed, scale):
    """packed uint8 (..., P/2), scale (..., 1) -> (..., P) float32."""
    lo = (packed & 0xF).to(torch.int32) - 8
    hi = (packed >> 4).to(torch.int32) - 8
    q = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    return q.to(torch.float32) * scale


def delta_encode_indices(idx):
    """Sorted-index delta encoding: each row sorted, then the first index
    and the gaps between neighbours (small integers on the wire)."""
    idx = torch.sort(idx, dim=-1).values
    return torch.diff(idx, dim=-1, prepend=torch.zeros_like(idx[..., :1]))


def delta_decode_indices(deltas):
    return torch.cumsum(deltas, dim=-1, dtype=deltas.dtype)


# ---------------------------------------------------------------------------
# cold population-row codec (AsyncScheduler, ``DLConfig.cold_dtype``)
# ---------------------------------------------------------------------------
# The cohort path touches its cold (N, ...) population state only by row
# gathers and scatters, so it can live compressed: ``encode_cold`` maps a
# node-stacked tree to its stored form, ``decode_cold`` a stored tree (full
# or row-gathered) back to fp32.  'bf16' truncates each float leaf;
# 'int8' quantizes each leaf per row (``QuantRows``: codes in the leaf's
# shape and one (N,) fp32 scale), through the quantize and dequantize
# kernels.  Non-float leaves (AdamW's step count) pass through.

COLD_DTYPES = ("fp32", "bf16", "int8")


class QuantRows:
    """An int8-quantized node-stacked leaf: ``q`` int8 codes in the leaf's
    shape and ``s`` (N,) fp32 per-row scales."""

    __slots__ = ("q", "s")

    def __init__(self, q, s):
        self.q = q
        self.s = s

    def take(self, rows):
        """The rows ``rows`` of both fields."""
        return QuantRows(self.q[rows], self.s[rows])

    def put_(self, rows, sub: "QuantRows"):
        """Write ``sub``'s rows at the ids ``rows`` (unique), in place."""
        self.q[rows] = sub.q
        self.s[rows] = sub.s
        return self


def cold_tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, tuples and lists, with
    :class:`QuantRows` as a leaf."""
    if isinstance(tree, dict):
        return {k: cold_tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(cold_tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for t in tree for l in _tree_leaves(t)]
    return [tree]


def quantize_rows(a) -> QuantRows:
    """(N, ...) float leaf -> :class:`QuantRows`, one quantize launch over
    its (N, prod(...)) rows (a view where the leaf's rows have unit
    column stride)."""
    flat = a.reshape(a.shape[0], -1).to(torch.float32)
    if flat.stride(1) != 1:
        flat = flat.contiguous()
    q, s = quantize(flat)
    return QuantRows(q.reshape(a.shape), s[:, 0])


def dequantize_rows(enc: QuantRows, dtype=torch.float32):
    """:class:`QuantRows` -> the float leaf, one dequantize launch."""
    q = enc.q
    flat = dequantize(q.reshape(q.shape[0], -1), enc.s.reshape(-1, 1).contiguous())
    return flat.reshape(q.shape).to(dtype)


def encode_cold(tree, mode: str):
    """Node-stacked tree -> its ``cold_dtype`` stored form ('fp32' is the
    identity).  Float leaves only; everything else passes through."""
    if mode == "fp32":
        return tree
    if mode not in COLD_DTYPES:
        raise ValueError(f"unknown cold_dtype {mode!r} ({'|'.join(COLD_DTYPES)})")

    def enc(a):
        if not a.is_floating_point():
            return a
        return a.to(torch.bfloat16) if mode == "bf16" else quantize_rows(a)

    return cold_tree_map(enc, tree)


def decode_cold(tree, mode: str):
    """Stored form (full tree or a row-gathered one) -> fp32 tree."""
    if mode == "fp32":
        return tree

    def dec(x):
        if isinstance(x, QuantRows):
            return dequantize_rows(x)
        return x.to(torch.float32) if x.dtype == torch.bfloat16 else x

    return cold_tree_map(dec, tree)


def take_rows(tree, rows):
    """The rows ``rows`` of every leaf of a stored tree."""
    return cold_tree_map(lambda a: a.take(rows) if isinstance(a, QuantRows) else a[rows], tree)


def put_rows_(tree, rows, sub):
    """Write ``sub``'s rows into the stored tree at the unique ids
    ``rows``, in place."""
    def put(a, b):
        if isinstance(a, QuantRows):
            a.put_(rows, b)
        else:
            a[rows] = b
        return a

    return cold_tree_map(put, tree, sub)


def where_rows(mask, new, old):
    """Per-row select between two stored trees: ``new``'s rows where
    ``mask`` (N,) > 0, else ``old``'s (a QuantRows leaf selects its codes
    and scales together)."""
    def f(nw, od):
        if isinstance(nw, QuantRows):
            m = mask.reshape((-1,) + (1,) * (nw.q.dim() - 1)) > 0
            return QuantRows(torch.where(m, nw.q, od.q), torch.where(mask > 0, nw.s, od.s))
        return torch.where(mask.reshape((-1,) + (1,) * (nw.dim() - 1)) > 0, nw, od)

    return cold_tree_map(f, new, old)


def cold_leaf_bytes(leaf) -> int:
    """Stored bytes of one cold leaf (codes and scales for QuantRows)."""
    if isinstance(leaf, QuantRows):
        return int(leaf.q.numel() * leaf.q.element_size() + leaf.s.numel() * 4)
    return int(leaf.numel() * leaf.element_size())


def cold_leaf_fp32_bytes(leaf) -> int:
    """fp32-equivalent bytes of one cold leaf (the uncompressed baseline)."""
    if isinstance(leaf, QuantRows):
        return int(leaf.q.numel() * 4)
    if leaf.is_floating_point():
        return int(leaf.numel() * 4)
    return int(leaf.numel() * leaf.element_size())


def cold_tree_bytes(tree):
    """(stored, fp32-equivalent) byte totals of a cold tree."""
    leaves = _tree_leaves(tree)
    return (sum(cold_leaf_bytes(l) for l in leaves),
            sum(cold_leaf_fp32_bytes(l) for l in leaves))
