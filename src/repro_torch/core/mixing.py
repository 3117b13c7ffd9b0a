"""Gossip mixing: x_i' = sum_j W_ij x_j, W the overlay's Metropolis-Hastings
weights.

* :func:`apply_W` — the strategy-facing primitive, one W @ Y.  On a
  :class:`SparseTopology` it is the fused gather-merge kernel
  (``kernels/gossip_mix.py``), which reads neighbour rows by index and so
  never builds the (N, D, P) gather of the JAX package's ``apply_W``; on a
  dense (N, N) W it is ``torch.matmul``.
* :func:`mix_sparse` / :func:`mix_dense` — the same over a node-stacked
  parameter tree.
* :func:`mix_circulant` — static circulant d-regular gossip (the LM
  trainer's ``ring``/``regular`` mixing), one launch of the same merge
  kernel per leaf over cached circulant tables; :func:`mix_fully` — the
  fully connected graph, a plain mean over nodes.
* :func:`mix_payload` — the compressed-sharing aggregation from per-node
  (idx, val) payloads: on a :class:`SparseTopology` one launch of the
  payload-merge kernel (``kernels/scatter_gossip.py``), which reads each
  sender's payload row by index, so the (N, D, k) operand stacks of the
  JAX package's ``_payload_operands`` are never built; on a dense W the
  dense-mask oracle :func:`mix_payload_masked`.
* :func:`mix_payload_strided` — the same for the strided random-k
  sampler's payloads (one phase per node), through the payload-merge
  kernel on the rebuilt index rows.
* :func:`gossip_pair_avg` — one cohort of pairwise asynchronous gossip
  (AD-PSGD): each fired node averages with one sampled neighbour.

Summation order: the kernel adds the self slot first and then the
neighbour slots in order; the JAX ``apply_W`` adds ``w_self * x`` after the
neighbour contraction.  The two agree to fp32 rounding, not bitwise.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.topology import SparseTopology, circulant_offsets, sample_neighbor_slots
from repro_torch.kernels.gossip_mix import gossip_mix_rows
from repro_torch.kernels.scatter_gossip import payload_mix_rows
from repro_torch.utils.pytree import tree_map


def mix_dense(stacked, W):
    """x_i' = sum_j W_ij x_j per leaf; W (N, N)."""
    W = W.to(torch.float32)
    return tree_map(
        lambda a: (W @ a.float().reshape(a.shape[0], -1)).reshape(a.shape).to(a.dtype),
        stacked,
    )


def apply_W(W, Y):
    """Row-stochastic mix Y' = W @ Y with fp32 accumulation, Y (N, ...).

    W: a dense (N, N) tensor or a ``SparseTopology`` whose tables live on
    Y's device.
    """
    Yf = Y.to(torch.float32)
    flat = Yf.reshape(Yf.shape[0], -1)
    if isinstance(W, SparseTopology):
        return gossip_mix_rows(flat, *W.merge_tables()).reshape(Yf.shape)
    return (W.to(torch.float32) @ flat).reshape(Yf.shape)


def mix_sparse(stacked, topo: SparseTopology):
    """Neighbor-indexed gossip over a tree: x_i' = w_self_i x_i +
    sum_k w[i,k] x_nbr[i,k] per leaf, through the fused merge kernel."""
    return tree_map(lambda a: apply_W(topo, a).to(a.dtype), stacked)


def mix_fully(stacked):
    """Fully connected with uniform MH weights: every node gets the fp32
    mean over nodes, cast back to the leaf's dtype."""
    return tree_map(
        lambda a: a.float().mean(0, keepdim=True).expand(a.shape).to(a.dtype), stacked)


@functools.lru_cache(maxsize=None)
def circulant_tables(n: int, degree: int, device: torch.device):
    """The merge operands of the d-regular circulant graph on ``n`` nodes:
    rows (n, K) int32, node i's slots ``[i, i+o1, i-o1, i+o2, ...]`` for the
    offsets of ``topology.circulant_offsets`` (the antipodal offset of an
    odd degree has one neighbour), and slot (K,) int64, the index into the
    ``[w_self, w_off1, ...]`` weight vector that each slot takes.  Built
    once per (n, degree, device) and kept there."""
    shifts, slot = [0], [0]
    for k, o in enumerate(circulant_offsets(n, degree)):
        shifts.append(o)
        slot.append(1 + k)
        if 2 * o % n != 0:
            shifts.append(-o)
            slot.append(1 + k)
    rows = (torch.arange(n, device=device)[:, None]
            + torch.tensor(shifts, device=device)[None, :]) % n
    return (rows.to(torch.int32).contiguous(),
            torch.tensor(slot, dtype=torch.int64, device=device))


@functools.lru_cache(maxsize=None)
def _uniform_circulant_weights(n: int, degree: int, device: torch.device):
    k = circulant_tables(n, degree, device)[0].shape[1]
    return torch.full((n, k), 1.0 / (degree + 1), dtype=torch.float32, device=device)


def mix_circulant(stacked, n: int, degree: int, weights=None):
    """Static circulant d-regular gossip, x_i' = w_0 x_i + sum_k w_{1+k}
    (x_{i+o_k} + x_{i-o_k}) (one term for the antipodal offset), through
    the gather-merge kernel: one launch per leaf, reading neighbour rows by
    index from the cached :func:`circulant_tables`.

    weights: optional (1 + n_offsets,) ``[w_self, w_off1, ...]`` tensor;
    defaults to uniform MH 1/(degree+1).  The kernel adds the slots in
    order, the reference adds each offset's pair first: fp32 rounding
    apart, the same sums.
    """
    def f(a):
        if a.shape[0] != n:
            raise ValueError(f"mix_circulant: leaf of {a.shape[0]} nodes, want {n}")
        rows, slot = circulant_tables(n, degree, a.device)
        if weights is None:
            w = _uniform_circulant_weights(n, degree, a.device)
        else:
            w = weights.to(device=a.device, dtype=torch.float32)[slot].expand(n, -1).contiguous()
        return gossip_mix_rows(a.reshape(n, -1), rows, w).reshape(a.shape)

    return tree_map(f, stacked)


# ---------------------------------------------------------------------------
# payload-indexed aggregation: the compressed-sharing wire primitive
# ---------------------------------------------------------------------------
#
# Sparsified strategies emit per-node payloads, ``idx`` (N, k) int32
# coordinates and ``val`` (N, k) wire values, and aggregate them with the
# missing-coordinate rule
#
#     x_i'[c] = x_i[c] + sum_j W_ij * m_j[c] * (v_j[c] - x_i[c]).
#
# The self slot rides along with weight w_self: it cancels exactly when
# val == x[idx] and reproduces the dense rule's self round trip when the
# wire codec perturbs values.


def mix_payload(W, idx, val, X, *, exact_values: bool = True, sorted_idx: bool = False):
    """Payload-indexed sparse aggregation: X' (N, P) fp32 from per-node
    payloads idx (N, k) int32 and val (N, k).

    W: a ``SparseTopology`` (one payload-merge kernel launch over the
    cached merge tables) or a dense (N, N) tensor (the dense-mask oracle).
    exact_values: promise that ``val`` is bit for bit the sender's own
    coordinates, so the self slot's correction is exactly zero and its
    slot is dropped; pass False for quantized payloads.  sorted_idx:
    promise that every idx row is non-decreasing, so the kernel's wrapper
    need not sort the payloads first.
    """
    Xf = X.to(torch.float32)
    valf = val.to(torch.float32)
    if isinstance(W, SparseTopology):
        rows, w = W.merge_tables(include_self=not exact_values)
        return payload_mix_rows(Xf, idx.to(torch.int32), valf, rows, w, sorted_idx=sorted_idx)
    return mix_payload_masked(W, idx, valf, Xf)


def mix_payload_strided(W, phase, val, X, *, exact_values: bool = True):
    """Strided-payload aggregation: sender n's payload is its value at
    offset ``phase[n]`` of each of the k cells of width ``stride`` of X
    (the caller pads P up to k·stride), idx = i·stride + phase_n.

    phase (N,) int32 in [0, stride); val (N, k); X (N, k·stride).  The
    index rows are rebuilt and go through :func:`mix_payload` as rows
    sorted by construction (one payload-merge launch on a
    ``SparseTopology``, the dense-mask oracle on a dense W).  The JAX
    package applies each payload as one column update of a (stride, k)
    cell view; the sums are the same up to fp32 summation order.
    """
    k = val.shape[1]
    stride = X.shape[1] // k
    idx = (torch.arange(k, dtype=torch.int32, device=X.device)[None, :] * stride
           + phase.to(torch.int32)[:, None])
    return mix_payload(W, idx, val, X, exact_values=exact_values, sorted_idx=True)


def _scatter_rows(idx, val, shape):
    """Dense (N, P) scatter of per-row payloads (payload indices are unique
    per row, so set == add)."""
    return torch.zeros(shape, dtype=torch.float32, device=val.device).scatter_(
        1, idx.long(), val.to(torch.float32)
    )


def mix_payload_masked(W, idx, val, X):
    """Dense-mask oracle of :func:`mix_payload`: scatter the payload into
    (N, P) value and mask matrices and apply the rule as
    X' = X + W@(M*V) - X*(W@M), two :func:`apply_W` passes (two launches
    of the merge kernel on a ``SparseTopology``).  The ``payload="off"``
    execution mode."""
    Xf = X.to(torch.float32)
    MX = _scatter_rows(idx, val, Xf.shape)
    M = _scatter_rows(idx, torch.ones_like(val, dtype=torch.float32), Xf.shape)
    return Xf + apply_W(W, MX) - Xf * apply_W(W, M)


def gossip_pair_avg(topo: SparseTopology, X, key, *, fire=None, act=None, rows=None):
    """One cohort of pairwise asynchronous gossip (AD-PSGD, one-sided
    read): each row draws one valid neighbour slot
    (``topology.sample_neighbor_slots``) and, where it fired (``fire``
    (N,) {0,1}, None for all) and its partner is up (``act`` (N,) {0,1},
    None for all), becomes ``0.5 * (x_i + x_partner)``; other rows stay.

    Returns ``(X', partner, ok)``: the (N,) global partner ids (a row's
    own id where no exchange happened) and the (N,) fp32 {0,1} mask of
    the exchanges that happened."""
    Xf = X.to(torch.float32)
    slot = sample_neighbor_slots(key, topo, rows=rows)
    partner = topo.nbr.gather(1, slot[:, None])[:, 0].to(torch.int64)
    ok = torch.ones(partner.shape[0], dtype=torch.float32, device=X.device)
    if fire is not None:
        ok = ok * fire
    if act is not None:
        ok = ok * act[partner]
    X2 = torch.where(ok[:, None] > 0, 0.5 * (Xf + Xf[partner]), Xf)
    partner = torch.where(ok > 0, partner, torch.arange(partner.shape[0], device=X.device))
    return X2.to(X.dtype), partner, ok
