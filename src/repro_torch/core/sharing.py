"""Sharing module: message content and aggregation.

Strategies act on the node-stacked flat parameter matrix X (N, P) and
return the post-gossip X' with the bytes each node sent this round.

Ported: full sharing (D-PSGD); quantized full sharing (int8 codes and a
per-node scale, stochastic rounding or not); and the sparsified
strategies, :class:`RandomKSharing` (uniform or strided sampler),
:class:`TopKSharing` and :class:`ChocoSGD` (top-k or random-k
compressor), optionally with the int8 wire codec.  The sparsified ones
emit per-node payloads, ``idx`` (N, k) int32 and ``val`` (N, k),
aggregated by :func:`repro_torch.core.mixing.mix_payload` (one
payload-merge kernel launch; ``payload=False`` takes the dense-mask
oracle).  Random draws are ``jax.random``'s, bitwise, through
``repro_torch.prng`` with per-node keys.  The churn reweights live here
too.

Unlike the JAX package's pure functions, ``round`` updates the strategy
state (``last_shared``, ``xhat``) in place: at N=1024 each is a 2.4 GB
(N, P) matrix, and a functional update would hold two of them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core.compression import dequantize_int8, quantize_int8
from repro_torch.core.mixing import apply_W, mix_payload, mix_payload_masked, mix_payload_strided
from repro_torch.core.topology import SparseTopology
from repro_torch.kernels.sparsify import topk_threshold_rows

BYTES_IDX = 4   # int32 index on the wire

_FULL_NAMES = ("full", "fullsharing", "d-psgd")
_QUANT_NAMES = ("quant", "quantized", "int8")
_RANDK_NAMES = ("randomk", "random")
_CHOCO_NAMES = ("choco", "choco-sgd", "chocosgd")


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _resolve_selector(selector: str, x) -> str:
    """The top-k rule ``selector`` names for the tensor ``x``: 'auto' is
    'hist' on a CUDA tensor and 'exact' on the CPU (the reference picks the
    histogram on its accelerator and the sort elsewhere)."""
    if selector == "auto":
        return "hist" if x.is_cuda else "exact"
    if selector not in ("exact", "hist"):
        raise ValueError(f"unknown selector {selector!r} (auto|exact|hist)")
    return selector


def _topk_idx(x_abs, k: int, selector: str = "auto"):
    """(N, k) int32 indices of (approximately) the k largest coordinates
    per row of the magnitudes ``x_abs`` — the one selection rule of the
    payload path and the dense-mask oracle.

    selector: 'exact' — the first k of a stable descending sort, which
    puts the lower index first among equal values as ``lax.top_k`` does
    (``torch.topk`` promises no order among ties); 'hist' — the histogram
    threshold (``kernels.sparsify.topk_threshold_rows``, two histogram
    kernel launches), then the first k survivors in index order; 'auto' —
    see :func:`_resolve_selector`.

    Every 'hist' row is non-decreasing, which the payload merge relies on
    (``sorted_idx``).  A row with fewer than k survivors (non-finite
    magnitudes: a NaN makes the row's threshold NaN, and no magnitude
    compares >= it) is padded with index 0, as the reference pads it; the
    padding goes in front of the survivors, where the reference puts it
    after them, so that the row stays sorted.  The padded entries all
    carry coordinate 0's one value, so every use of the row (gather,
    merge, scatter into the state) gives the same bits in either order.
    """
    selector = _resolve_selector(selector, x_abs)
    if selector == "exact":
        order = torch.sort(x_abs, dim=1, descending=True, stable=True).indices
        return order[:, :k].to(torch.int32)
    n = x_abs.shape[0]
    keep = x_abs >= topk_threshold_rows(x_abs, k)[:, None]
    # int32 prefix counts: the int64 default would add 8 bytes per element
    keep &= torch.cumsum(keep, 1, dtype=torch.int32) <= k
    rows, cols = keep.nonzero(as_tuple=True)   # row-major: index order per row
    counts = keep.sum(1)
    # survivor q of row r goes to slot (k - counts[r]) + q: padding first
    slot = torch.arange(rows.numel(), device=x_abs.device) + (k - counts.cumsum(0))[rows]
    out = torch.zeros((n, k), dtype=torch.int32, device=x_abs.device)
    out[rows, slot] = cols.to(torch.int32)
    return out


def _wire(val, quantize: Optional[str], x_dtype):
    """Wire-form payload values: (valf, the fp32 values the receivers
    reconstruct; bytes per value on the wire; per-node header bytes)."""
    if quantize in (None, "none"):
        item = torch.empty((), dtype=x_dtype).element_size()
        return val.to(x_dtype).to(torch.float32), item, 0
    if quantize == "int8":
        codes, scale = quantize_int8(val.to(torch.float32))
        return dequantize_int8(codes, scale), 1, 4
    raise ValueError(f"unknown payload quantization {quantize!r} (int8|none)")


def _node_keys(key, n: int, device, rows=None):
    """(N, 1)-word batch of per-node keys: ``fold_in(key, i)`` for each
    node's global id i, as the reference's ``_node_keys`` folds them.
    ``rows`` (N,) global ids (a process worker's row block) defaults to
    arange(N)."""
    ids = (torch.arange(n, dtype=torch.int64, device=device) if rows is None
           else torch.as_tensor(rows, device=device).to(torch.int64))
    return prng.fold_in(key, ids[:, None])


def _randk_uniforms(key, shape, device, rows=None):
    """(N, P) per-node ``jax.random.uniform`` draws, node i's from its own
    key (:func:`_node_keys`)."""
    return prng.uniform(_node_keys(key, shape[0], device, rows), shape[1:])


def _randk_select(u, k: int):
    """(N, k) int32 indices of the k largest uniforms per row, the set
    ``lax.top_k`` picks: a stable descending sort puts the lower index
    first among equal values, as ``lax.top_k`` breaks ties (23-bit
    uniforms tie often at large P, so ``torch.topk``, which promises no
    order among ties, would pick another set).  Each row's indices are
    then sorted ascending, as the payload merge takes them
    (``sorted_idx``); the set is the reference's, only its slot order
    differs."""
    order = torch.sort(u, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.sort(order, dim=1).values.to(torch.int32)


def _randk_idx(key, shape, k: int, device, rows=None):
    """(N, k) int32 indices of k random coordinates per row without
    replacement, rows sorted: the top k of per-node iid uniforms.  With
    ``rows`` (the global ids of the N rows) each row draws what the
    simulator's row of that id draws."""
    return _randk_select(_randk_uniforms(key, shape, device, rows), k)


def _strided_phase(key, n: int, stride: int, device):
    """(N,) int32 random phases in [0, stride): node n shares the
    coordinates {i·stride + phase_n}.  Per-node keyed, one uniform each."""
    u = prng.uniform(_node_keys(key, n, device), ())
    return torch.floor(u * stride).to(torch.int32)


def sparse_aggregate(X, W, M):
    """Masked gossip with missing-coordinate fallback through two
    :func:`apply_W` passes: X + W@(M*X) - X*(W@M)."""
    Xf, Mf = X.to(torch.float32), M.to(torch.float32)
    return (Xf + apply_W(W, Mf * Xf) - Xf * apply_W(W, Mf)).to(X.dtype)


def participation_reweight(W, active):
    """Reweight a row-stochastic (N, N) mixing matrix for a per-round
    participation mask (churn): active (N,) {0,1} on W's device; a down node
    neither sends nor receives, so every edge touching it goes and the
    freed mass returns to each row's diagonal (a down node's row becomes
    e_i).  Returns W' only: the byte accounting's degree comes from
    :func:`participation_deg_eff` on the host, without reading the device."""
    Wf = W.to(torch.float32)
    m = active.to(torch.float32)
    diag = torch.eye(Wf.shape[0], dtype=torch.float32, device=Wf.device)
    off = Wf * (1.0 - diag) * m[:, None] * m[None, :]
    return off + diag * (1.0 - off.sum(1, keepdim=True))


def participation_reweight_sparse(topo: SparseTopology, active):
    """Sparse-form :func:`participation_reweight`: neighbour slots with a
    down endpoint get weight 0 and the freed mass returns to ``w_self``
    (a down node's row becomes the identity); O(N·D).  A new topology
    (``SparseTopology.reweighted``)."""
    m = active.to(torch.float32)
    w = topo.w.to(torch.float32) * (m[:, None] * m[topo.nbr.long()])
    return topo.reweighted(w, 1.0 - w.sum(-1))


def participation_reweight_rows(topo_rows: SparseTopology, active, rows):
    """Row-subset :func:`participation_reweight_sparse`: churn-reweight a
    gathered (C, D) cohort view (``topology.gather_rows``, ``nbr`` global
    ids) against the full (N,) ``active`` mask.  Each row's arithmetic is
    the dense reweight's, so the result is its (C,)-row slice.  The
    degree comes from :func:`participation_deg_eff` on the host, which
    counts every live edge, not only the cohort's."""
    m = active.to(torch.float32)
    pair = m[rows][:, None] * m[topo_rows.nbr.long()]
    w = topo_rows.w.to(torch.float32) * pair
    return SparseTopology(topo_rows.nbr, w, 1.0 - w.sum(-1))


def live_edge_mask(nbr, live, active=None) -> np.ndarray:
    """(N, E) bool host mask of the edges a churn round sends on: the
    static edges ``live`` (N, E) whose endpoints are both up in
    ``active`` (N,) (all of them where ``active`` is None); ``nbr`` (N, E)
    holds the far endpoints, None for the columns of a dense W."""
    if active is None:
        return np.asarray(live, bool)
    m = np.asarray(active) > 0
    far = m[None, :] if nbr is None else m[nbr]
    return live & m[:, None] & far


def participation_deg_eff(nbr, live, active) -> np.float32:
    """The churn round's mean live degree, as the reference's reweights
    compute it (live edges over active nodes, one fp32 division), from
    host arrays as :func:`live_edge_mask` takes them."""
    edges = np.count_nonzero(live_edge_mask(nbr, live, active))
    return np.float32(edges) / np.float32(max(int(np.count_nonzero(np.asarray(active) > 0)), 1))


def edge_reweight(W, live):
    """Renormalize a row-stochastic (N, N) mixing matrix for a per-edge
    {0,1} mask (message loss): ``live[i, j] = 0`` drops the message
    j -> i, and the freed mass returns to the receiver's diagonal, so rows
    stay stochastic.  Composes with :func:`participation_reweight`."""
    Wf = W.to(torch.float32)
    diag = torch.eye(Wf.shape[0], dtype=torch.float32, device=Wf.device)
    off = Wf * (1.0 - diag) * live.to(torch.float32)
    return off + diag * (1.0 - off.sum(1, keepdim=True))


def edge_reweight_sparse(topo: SparseTopology, live):
    """Sparse-form :func:`edge_reweight` over the (N, D) neighbour slots:
    lost slots get weight 0 and the freed mass returns to ``w_self``.  A
    new topology (``SparseTopology.reweighted``)."""
    w = topo.w.to(torch.float32) * live.to(torch.float32)
    return topo.reweighted(w, 1.0 - w.sum(-1))


def edge_readmit_sparse(topo0: SparseTopology, live):
    """Re-admission: the effective topology recomputed from the pristine
    table ``topo0`` and the current (N, D) live mask, the exact inverse of
    :func:`edge_reweight_sparse`.  When every slot is live the pristine
    object itself comes back: its ``w_self`` was built in float64 before
    the fp32 cast, which an fp32 ``1 - w.sum(-1)`` could miss by an ulp."""
    if bool((torch.as_tensor(live) == 1.0).all()):
        return topo0
    return edge_reweight_sparse(topo0, torch.as_tensor(live))


class FullSharing:
    """Baseline: serialize the full parameter vector (D-PSGD)."""

    def init_state(self, X):
        return ()

    def round(self, X, W, state, key=None, degree=1.0, rnd=0):
        X2 = apply_W(W, X).to(X.dtype)
        return X2, state, degree * X.shape[1] * X.element_size()

    def wire_dtype(self, x_dtype) -> str:
        return _dtype_name(x_dtype)

    def stage_bytes_per_round(self, n: int, p: int) -> int:
        return n * p * 4  # the fp32 mixing operand itself


@dataclasses.dataclass(frozen=True)
class _PayloadSharing:
    """Shared machinery of the payload-emitting sparsified strategies.

    payload: aggregate through :func:`mix_payload` (True) or the dense-mask
    oracle (False).  quantize: None or 'int8' (the wire codec of
    ``core/compression.py``, 1 byte per value and a 4-byte scale per
    node).  selector: the top-k rule (see :func:`_topk_idx`).
    """

    budget: float  # fraction of parameters shared (paper: 0.10)
    payload: bool = True
    quantize: Optional[str] = None  # None | 'int8'
    selector: str = "auto"          # auto | exact | hist

    def _k(self, X) -> int:
        return max(1, int(self.budget * X.shape[1]))

    def _aggregate(self, X, W, idx, valf, sorted_idx: bool):
        if self.payload:
            return mix_payload(W, idx, valf, X, exact_values=self.quantize is None,
                               sorted_idx=sorted_idx).to(X.dtype)
        return mix_payload_masked(W, idx, valf, X).to(X.dtype)

    def _nbytes(self, degree, k: int, item: int, header: int):
        return degree * (k * (BYTES_IDX + item) + header)

    def wire_dtype(self, x_dtype) -> str:
        return "int8" if self.quantize == "int8" else _dtype_name(x_dtype)

    def _static_idx_bytes(self, p: int):
        return BYTES_IDX

    def _payload_stage_bytes(self, n: int, p: int):
        """Bytes of the (idx, val) payloads of one round, and the scales."""
        k = max(1, int(self.budget * p))
        item = 1 if self.quantize == "int8" else 4
        header = 4 if self.quantize == "int8" else 0
        return n * (k * (self._static_idx_bytes(p) + item) + header)

    def stage_bytes_per_round(self, n: int, p: int) -> int:
        """Bytes of message tensors the sharing stage materializes per
        round: (idx, val) payloads, vs scattered (N, P) fp32 value and
        byte mask matrices on the dense-mask oracle path."""
        return self._payload_stage_bytes(n, p) if self.payload else n * p * (4 + 1)


@dataclasses.dataclass(frozen=True)
class RandomKSharing(_PayloadSharing):
    """Random sampling sparsification (paper Fig. 4): k random coordinates
    per node, emitted as an (idx, val) payload (per-node keyed draws).

    sampler: 'uniform' — the k-subset of the top k of (N, P) iid uniforms
    (:func:`_randk_idx`; int32 coordinates on the wire); 'strided' — the
    columns split into k cells of width ceil(P/k) and node n shares
    {i·stride + phase_n}, one narrow offset per message on the wire,
    merged by :func:`mix_payload_strided`.
    """

    sampler: str = "uniform"  # uniform | strided

    def init_state(self, X):
        return ()

    def _static_idx_bytes(self, p: int):
        if self.sampler != "strided":
            return BYTES_IDX
        # one phase offset per message, amortized over the k values
        k = max(1, int(self.budget * p))
        stride = -(-p // k)
        return (1 if stride <= 256 else (2 if stride <= 65536 else 4)) / k

    def round(self, X, W, state, key=None, degree=1.0, rnd=0):
        k = self._k(X)
        if self.sampler == "strided":
            return self._round_strided(X, W, state, key, degree, k)
        if self.sampler != "uniform":
            raise ValueError(f"unknown sampler {self.sampler!r} (uniform|strided)")
        idx = _randk_idx(key, X.shape, k, X.device)
        val = X.gather(1, idx.long())
        valf, item, header = _wire(val, self.quantize, X.dtype)
        X2 = self._aggregate(X, W, idx, valf, sorted_idx=True)
        return X2, state, self._nbytes(degree, k, item, header)

    def _round_strided(self, X, W, state, key, degree, k: int):
        """Strided-grid round: P padded with zero columns up to k·stride
        (every node's pad is zero, so it contributes w·(0 - 0) = 0 and is
        cut off), one phase per node."""
        n, p = X.shape
        stride = -(-p // k)
        Xp = F.pad(X, (0, k * stride - p))
        phase = _strided_phase(key, n, stride, X.device)
        idx = torch.arange(k, dtype=torch.int32, device=X.device)[None, :] * stride + phase[:, None]
        val = Xp.gather(1, idx.long())
        valf, item, header = _wire(val, self.quantize, X.dtype)
        if self.payload:
            X2p = mix_payload_strided(W, phase, valf, Xp, exact_values=self.quantize is None)
        else:
            X2p = mix_payload_masked(W, idx, valf, Xp)
        phase_bytes = 1 if stride <= 256 else (2 if stride <= 65536 else 4)
        nbytes = degree * (k * item + phase_bytes + header)
        # contiguous: the engine's parameter tree is views of the state
        return X2p[:, :p].to(X.dtype).contiguous(), state, nbytes


@dataclasses.dataclass(frozen=True)
class TopKSharing(_PayloadSharing):
    """TopK sparsification [Alistarh et al. '18]: share the k coordinates
    whose accumulated change since they were last shared is largest; the
    residual stays in ``last_shared``, the Model module's extra state."""

    # a churn round passes the participation mask: a down node's
    # last_shared must not record a payload it never sent
    needs_act = True

    def init_state(self, X):
        return {"last_shared": X.to(torch.float32).clone()}

    def round(self, X, W, state, key=None, degree=1.0, rnd=0, act=None):
        """``act``: the round's (N,) participation mask on X's device, or
        None; a down row's ``last_shared`` stays bitwise as it was (its
        scatter rewrites the values already there)."""
        k = self._k(X)
        last = state["last_shared"]
        selector = _resolve_selector(self.selector, X)
        idx = _topk_idx((X.to(torch.float32) - last).abs_(), k, selector)
        val = X.gather(1, idx.long())
        valf, item, header = _wire(val, self.quantize, X.dtype)
        X2 = self._aggregate(X, W, idx, valf, sorted_idx=selector == "hist")
        # error feedback: record what the receivers reconstructed, so a
        # quantization residual stays in the delta and is shared again
        sent = valf if act is None else torch.where(act[:, None] > 0, valf,
                                                     last.gather(1, idx.long()))
        last.scatter_(1, idx.long(), sent)
        return X2, state, self._nbytes(degree, k, item, header)


@dataclasses.dataclass(frozen=True)
class ChocoSGD(_PayloadSharing):
    """CHOCO-SGD [Koloskova et al. '19]: gossip on compressed differences
    to a public copy x̂, with consensus step size gamma.

        q_i  = C(x_i - x̂_i)           (top-k or random-k compressor)
        x̂_i += q_i
        x_i += gamma * sum_j W_ij (x̂_j - x̂_i)

    The wire carries the (idx, val) payload of q; the consensus step mixes
    the locally tracked dense x̂ copies through :func:`apply_W`.
    """

    gamma: float = 0.3
    compressor: str = "topk"  # 'topk' | 'randk' (the reference takes any other as randk)

    def init_state(self, X):
        return {"xhat": torch.zeros(X.shape, dtype=torch.float32, device=X.device)}

    def stage_bytes_per_round(self, n: int, p: int) -> int:
        # the q payload in both modes; the dense x̂ mix is local state
        return self._payload_stage_bytes(n, p)

    # a churn round passes the participation mask: a down node's x̂ must
    # not take a q it never sent
    needs_act = True

    def round(self, X, W, state, key=None, degree=1.0, rnd=0, act=None):
        """``act``: the round's (N,) participation mask on X's device, or
        None; a down row's x̂ takes +0.0 at its payload's coordinates,
        which leaves every value x̂ can hold bitwise as it was (x̂ starts at
        +0.0 and only adds, so it never holds -0.0)."""
        k = self._k(X)
        xhat = state["xhat"]
        Xf = X.to(torch.float32)
        diff = Xf - xhat
        if self.compressor == "topk":
            idx = _topk_idx(diff.abs(), k, self.selector).long()
        else:
            idx = _randk_idx(key, X.shape, k, X.device).long()
        valf, item, header = _wire(diff.gather(1, idx), self.quantize, torch.float32)
        del diff
        if act is not None:
            valf = torch.where(act[:, None] > 0, valf, 0.0)
        xhat.scatter_add_(1, idx, valf)
        X2 = Xf + self.gamma * (apply_W(W, xhat) - xhat)
        return X2.to(X.dtype), state, self._nbytes(degree, k, item, header)


@dataclasses.dataclass(frozen=True)
class QuantizedSharing:
    """Full sharing through the int8 codec: codes and a per-node fp32
    scale on the wire (4x fewer bytes than fp32), dequantized before the
    Metropolis-Hastings merge.  ``stochastic`` rounds floor(x/scale + u)
    with u a per-node ``jax.random.uniform`` draw (the quantize kernel's
    noise form), else to nearest."""

    stochastic: bool = True

    def init_state(self, X):
        return ()

    def round(self, X, W, state, key=None, degree=1.0, rnd=0):
        keys = _node_keys(key, X.shape[0], X.device) if self.stochastic else None
        codes, scale = quantize_int8(X, keys)
        Xq = dequantize_int8(codes, scale)  # what the receivers reconstruct
        X2 = apply_W(W, Xq).to(X.dtype)
        return X2, state, degree * (X.shape[1] * 1 + 4)

    def wire_dtype(self, x_dtype) -> str:
        return "int8"

    def stage_bytes_per_round(self, n: int, p: int) -> int:
        return n * (p * 1 + 4)


def strategy_takes_budget(name: str) -> bool:
    """Whether ``name`` is a sparsified strategy parameterized by a budget."""
    return name.lower() not in _FULL_NAMES + _QUANT_NAMES


def is_full_sharing(name: str) -> bool:
    """Whether ``name`` aliases plain full sharing (D-PSGD)."""
    return name.lower() in _FULL_NAMES


def make_sharing(name: str, budget: Optional[float] = None, **kw):
    """Build a sharing strategy by name.  Every keyword goes to the
    strategy's constructor; unknown or inapplicable ones raise
    ``ValueError``.  ``budget`` defaults to 0.1 for the sparsified
    strategies and is rejected for full sharing."""
    name_l = name.lower()

    def build(cls, **kwargs):
        try:
            return cls(**kwargs)
        except TypeError as e:
            raise ValueError(f"invalid kwargs for sharing strategy {name!r}: {e}") from None

    if name_l in _FULL_NAMES + _QUANT_NAMES:
        if budget is not None:
            raise ValueError(
                f"sharing strategy {name!r} shares every coordinate; 'budget' does not apply"
            )
        return build(FullSharing if name_l in _FULL_NAMES else QuantizedSharing, **kw)
    b = 0.1 if budget is None else budget
    if name_l in _RANDK_NAMES:
        return build(RandomKSharing, budget=b, **kw)
    if name_l == "topk":
        return build(TopKSharing, budget=b, **kw)
    if name_l in _CHOCO_NAMES:
        return build(ChocoSGD, budget=b, **kw)
    raise ValueError(f"unknown sharing strategy {name!r}")
