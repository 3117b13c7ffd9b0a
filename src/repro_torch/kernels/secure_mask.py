"""Fused secure-aggregation mask apply: the Hopper port of the JAX package's
``kernels/secure_mask.py`` Pallas kernels (``secure_mask_apply``,
``secure_mask_apply_nodes`` and ``secure_mask_apply_nodes_keyed``).

    out[b] = x[rows[b]] + sum_k signs[b, k] * U(bits[b, k])
    U(v)   = ((v >> 8) * 2^-24 * 2 - 1) * bound      (uniform in [-bound, bound))

A sender adds one cancellable mask per co-neighbour pair to its message in
one pass.  One CUDA source (``csrc/secure_mask.cu``) holds two kernels:

* :func:`secure_mask_apply_rows_keyed` — the bits come from (B, K, 2) pair
  keys, computed in the kernel by Threefry-2x32 in the counter layout of
  :func:`repro_torch.prng.counter_bits`, so no (B, K, M) bit tensor exists;
* :func:`secure_mask_apply_rows` — the bits come staged, (B, K, M) uint32.

Both read each message's base row of ``x`` by index (``rows``), so the
secure round never gathers its (N, D, P) neighbour stack, and both may
write in place (``out=x`` with ``rows=None``), as the recovery pass does.
:func:`secure_mask_apply_nodes_keyed`, :func:`secure_mask_apply_nodes` and
:func:`secure_mask_apply` keep the reference's stacked signatures.

Keys are 32-bit words: an int64 tensor of values in [0, 2^32), as
``prng`` makes them, or raw int32 words.  A tensor on the CPU goes to the
plain twins; a CUDA tensor launches the kernel or raises: there is no
fallback.  The kernels are compiled on their first CUDA call, never at
import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library
from repro_torch.prng import MASK32, counter_bits

MAX_K = 64  # slots per message (the kernels' shared-memory tables)
_TWIN_ELEMS = 1 << 25  # int64 words per step of the keyed twin

_P = ctypes.c_void_p
_LL = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(load_library("secure_mask"), name)
    fn.argtypes = [_P, _LL, _P, ctypes.c_int, _LL, _P, _P, ctypes.c_int, ctypes.c_float,
                   _P, _LL, _P]
    fn.restype = ctypes.c_int
    return fn


def mask_bits_to_uniform(bits, bound):
    """uint32 bits (any integer tensor holding them) -> fp32 masks in
    [-bound, bound): the top 24 bits scaled to [0, 1), as
    ``kernels/ref.py mask_bits_to_uniform`` maps them."""
    u01 = ((bits.long() & MASK32) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return (u01 * 2.0 - 1.0) * bound


def _accumulate(base, signs, bits_of, bound):
    """base + sum_k signs[:, k] * U(bits_of(k, rows)), over k in order from
    0.  Rows whose sign is 0 are skipped, as the kernels skip them (they
    would add exact zeros)."""
    acc = torch.zeros_like(base)
    for k in range(signs.shape[1]):
        rows = (signs[:, k] != 0).nonzero()[:, 0]
        if rows.numel():
            acc[rows] += signs[rows, k:k + 1] * mask_bits_to_uniform(bits_of(k, rows), bound)
    return base + acc


def _base_rows(x, rows):
    return (x if rows is None else x.index_select(0, rows.long())).to(torch.float32)


def secure_mask_apply_rows_keyed_ref(x, rows, keys, signs, bound=1.0):
    """Plain twin of the keyed kernel: the counter bits of every key from
    ``prng.counter_bits``, in groups of messages."""
    words = keys.long() & MASK32
    b_total, m = words.shape[0], x.shape[1]
    step = max(1, _TWIN_ELEMS // max(m, 1))
    out = []
    for s in range(0, b_total, step):
        kw, sg = words[s:s + step], signs[s:s + step].to(torch.float32)
        base = _base_rows(x[s:s + step], None) if rows is None else _base_rows(x, rows[s:s + step])
        out.append(_accumulate(
            base, sg, lambda k, r: counter_bits(kw[r, k, 0:1], kw[r, k, 1:2], m), bound))
    return torch.cat(out) if out else torch.empty((0, m), dtype=torch.float32, device=x.device)


def secure_mask_apply_rows_ref(x, rows, bits, signs, bound=1.0):
    """Plain twin of the staged kernel: bits (B, K, M) of raw 32-bit words."""
    return _accumulate(_base_rows(x, rows), signs.to(torch.float32),
                       lambda k, r: bits[r, k].view(torch.int32), bound)


def _check(name, x, rows, signs, K, out):
    """Validate the common operands; returns (B, out)."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"{name}: x must be (R, M) float32 with unit column stride")
    b = x.shape[0] if rows is None else rows.shape[0]
    if rows is not None and (rows.dtype != torch.int32 or rows.dim() != 1
                             or not rows.is_contiguous() or rows.device != x.device):
        raise ValueError(f"{name}: rows must be a contiguous (B,) int32 tensor on x's device")
    if (signs.dtype != torch.float32 or tuple(signs.shape) != (b, K)
            or not signs.is_contiguous() or signs.device != x.device):
        raise ValueError(f"{name}: signs must be a contiguous ({b}, {K}) float32 tensor "
                         f"on x's device")
    if not 0 <= K <= MAX_K:
        raise ValueError(f"{name}: K={K} outside 0..{MAX_K}")
    if out is None:
        out = torch.empty((b, x.shape[1]), dtype=torch.float32, device=x.device)
    elif (tuple(out.shape) != (b, x.shape[1]) or out.dtype != torch.float32
          or out.device != x.device or out.stride(1) != 1):
        raise ValueError(f"{name}: out must be ({b}, M) float32 with unit column stride")
    elif out.data_ptr() == x.data_ptr() and (rows is not None or out.stride(0) != x.stride(0)):
        raise ValueError(f"{name}: out may alias x only as x itself, with rows=None")
    return b, out


def _launch(name, x, rows, b, words, signs, bound, out):
    with torch.cuda.device(x.device):
        err = _entry(name)(
            x.data_ptr(), x.stride(0), None if rows is None else rows.data_ptr(), b,
            x.shape[1], words.data_ptr(), signs.data_ptr(), signs.shape[1], float(bound),
            out.data_ptr(), out.stride(0), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def _raw_words(t):
    """A tensor of 32-bit words as contiguous int32 bit patterns."""
    if t.dtype in (torch.int32, torch.uint32):
        return t.contiguous().view(torch.int32)
    w = t.long() & MASK32
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).contiguous()


def secure_mask_apply_rows_keyed(x, rows, keys, signs, bound=1.0, out=None):
    """out[b] = x[rows[b]] + sum_k signs[b, k] * U(counter_bits(keys[b, k])).

    x (R, M) fp32 with unit column stride; rows (B,) int32 into x, or None
    for rows 0..R-1; keys (B, K, 2) 32-bit words; signs (B, K) fp32 in
    {-1, 0, +1}.  Returns (B, M) fp32, written into ``out`` when given
    (``out`` may be ``x`` itself when ``rows`` is None).
    """
    if x.device.type == "cpu":
        res = secure_mask_apply_rows_keyed_ref(x, rows, keys, signs, bound)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"secure_mask_apply_rows_keyed: unsupported device {x.device}")
    K = keys.shape[1]
    b, out = _check("secure_mask_apply_rows_keyed", x, rows, signs, K, out)
    if tuple(keys.shape) != (b, K, 2) or keys.device != x.device:
        raise ValueError(f"secure_mask_apply_rows_keyed: keys must be ({b}, {K}, 2) on x's device")
    _launch("secure_mask_rows_keyed_f32", x, rows, b, _raw_words(keys), signs, bound, out)
    secure_mask_apply_rows_keyed.launches += 1
    return out


def secure_mask_apply_rows(x, rows, bits, signs, bound=1.0, out=None):
    """out[b] = x[rows[b]] + sum_k signs[b, k] * U(bits[b, k]); bits (B, K, M)
    of 32-bit words (uint32 or int32), the rest as
    :func:`secure_mask_apply_rows_keyed`."""
    if x.device.type == "cpu":
        res = secure_mask_apply_rows_ref(x, rows, bits, signs, bound)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"secure_mask_apply_rows: unsupported device {x.device}")
    K = bits.shape[1]
    b, out = _check("secure_mask_apply_rows", x, rows, signs, K, out)
    if (bits.dtype not in (torch.int32, torch.uint32) or tuple(bits.shape) != (b, K, x.shape[1])
            or not bits.is_contiguous() or bits.device != x.device):
        raise ValueError(f"secure_mask_apply_rows: bits must be contiguous ({b}, {K}, M) "
                         f"32-bit words on x's device")
    _launch("secure_mask_rows_bits_f32", x, rows, b, bits.view(torch.int32), signs, bound, out)
    secure_mask_apply_rows.launches += 1
    return out


secure_mask_apply_rows_keyed.launches = 0  # kernel launches since the last reset
secure_mask_apply_rows.launches = 0


def secure_mask_apply_nodes_keyed(x, keys, signs, bound=1.0):
    """The reference's stacked keyed form: x (B, M), keys (B, K, 2),
    signs (B, K) -> (B, M)."""
    return secure_mask_apply_rows_keyed(x.to(torch.float32).contiguous(), None, keys,
                                        signs.to(torch.float32).contiguous(), bound)


def secure_mask_apply_nodes(x, bits, signs, bound=1.0):
    """The reference's stacked staged form: x (B, M), bits (B, K, M),
    signs (B, K) -> (B, M)."""
    return secure_mask_apply_rows(x.to(torch.float32).contiguous(), None, bits,
                                  signs.to(torch.float32).contiguous(), bound)


def secure_mask_apply(x, bits, signs, bound=1.0):
    """The flat form: x (M,), bits (K, M), signs (K,) -> (M,)."""
    return secure_mask_apply_nodes(x.reshape(1, -1), bits[None], signs.reshape(1, -1), bound)[0]
