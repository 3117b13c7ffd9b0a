"""Secure aggregation for DL (paper §3.4, after Bonawitz et al. CCS'17):
the port of the JAX package's ``core/secure.py``.

Every receiver r aggregates the models of its neighbour set N(r) with
equal weights.  Each sender pair (i, j) in N(r), i < j, shares a seed; i
adds +PRF(seed) and j adds -PRF(seed) to the copy each sends to r, so the
masks cancel in r's sum while each message is a one-time-padded blob.

    y_r = (1 - w·|N(r)|) x_r + w * sum_{i in N(r)} msg_{i->r}

The PRF is Threefry keyed by fold_in(fold_in(fold_in(fold_in(key, rnd),
min(i, j)), max(i, j)), r) (:mod:`repro_torch.prng`), its bits expanded in
the counter layout of the reference's kernel and mapped to uniform
[-b, b).  The keys come from the *sorted* pair, so the +1 and -1
occurrences of a pair expand the same bits and cancel exactly.

* :meth:`SecureAggregation.round` — the engine's path: the pair keys of
  every (message, co-neighbour) slot are derived on the device with torch
  integer ops, and one launch of the keyed mask kernel
  (``kernels/secure_mask.py``) masks all N·D messages, reading each
  sender's row of X by index (no (N, D, P) gather).  With recovery, a
  second launch subtracts the dropped pairs' masks in place.  One launch
  of the gather-merge kernel sums each receiver's live messages.
* :meth:`SecureAggregation.round_reference` — the Python dict-of-messages
  schedule (:meth:`messages`), the oracle.  Its bits are the counter
  layout's too; the JAX package's ``messages`` calls ``jax.random.bits``,
  whose layout jax 0.9 changed, so there the two no longer agree.

``W`` may be the dense (N, N) matrix or a ``SparseTopology``; only the
per-receiver weight is read from it.

* :meth:`SecureAggregation._round_sharded` — the node-sharded round
  (``mixing.ShardedTopology`` / ``ShardedDense``): the co-neighbours'
  rows arrive through the operand's exchange, and the pair keys are
  folded from global node ids, so every mask pair cancels as on one
  device.

Communication: each edge carries the P masked values plus metadata (pair
seeds, framing), accounted as 3% after the paper's cost model.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.mixing import ShardedDense, ShardedTopology
from repro_torch.core.topology import SparseTopology, neighbor_table
from repro_torch.kernels.gossip_mix import gossip_mix_rows
from repro_torch.kernels.secure_mask import mask_bits_to_uniform, secure_mask_apply_rows_keyed

METADATA_OVERHEAD = 0.03  # paper: ~3% extra bytes (seeds, framing)
# one revealed seed share on the recovery round: the co-neighbour re-sends
# the (dropped pair, receiver) key-chain material, a 32-byte record (pair
# seed + ids + round), after Bonawitz et al. CCS'17 §5
SEED_SHARE_BYTES = 32


def wire_bytes(degree, p: int, item: int):
    """Bytes a node sends in a round: degree · P · item · 1.03.  A churn
    round's degree is an fp32 value (``np.float32``); the reference computes
    the product on its device, where XLA folds the constant factors into
    one fp32 constant first, and so does this.  A Python float degree
    multiplies in float64, as the reference's host code does."""
    if isinstance(degree, np.floating):
        return degree * np.float32(np.float32(p * item) * np.float32(1.0 + METADATA_OVERHEAD))
    return degree * p * item * (1.0 + METADATA_OVERHEAD)


def pair_keys(kround, i, j, r):
    """Key words of the PRF of sender pair (i, j) at receiver r, from a key
    already folded with the round; i, j, r are ints or int64 tensors."""
    return prng.fold_in(prng.fold_in(prng.fold_in(kround, i), j), r)


def _pair_mask(key, rnd, a: int, b: int, r: int, p: int, bound: float, device):
    k = pair_keys(prng.fold_in(key, rnd), a, b, r)
    return mask_bits_to_uniform(prng.counter_bits(k[0], k[1], p, device=device), bound)


@dataclasses.dataclass(frozen=True)
class SecureAggregation:
    """Masked full sharing over a static graph.

    adj: (N, N) bool numpy adjacency.  recovery: the Bonawitz seed-recovery
    pass that keeps the aggregate exact under churn
    (``DLConfig.secure_recovery``): live co-neighbours re-derive the masks
    of the pairs whose other sender dropped, the receiver subtracts them and
    aggregates its live neighbours only, which equals the churn-reweighted
    plain aggregate.  ``key`` is a ``prng`` word pair.
    """

    adj: np.ndarray
    mask_bound: float = 1.0
    recovery: bool = False

    def __post_init__(self):
        nbr, valid = neighbor_table(np.asarray(self.adj))
        object.__setattr__(self, "_nbr", nbr)
        object.__setattr__(self, "_valid", valid)
        object.__setattr__(self, "_tables_on", {})

    def init_state(self, X):
        return ()

    @property
    def needs_act(self) -> bool:
        """Recovery needs the participation mask (``act=``) in :meth:`round`."""
        return self.recovery

    def _tables(self, device):
        """(nbr (N, D) int64, valid (N, D) fp32) on ``device``, built once."""
        dev = torch.device(device)
        if dev not in self._tables_on:
            self._tables_on[dev] = (
                torch.as_tensor(self._nbr, dtype=torch.int64, device=dev),
                torch.as_tensor(self._valid, dtype=torch.float32, device=dev),
            )
        return self._tables_on[dev]

    def messages(self, X, key, rnd):
        """Masked message from i to r for every edge (i, r): a dict
        {(i, r): (P,) fp32 tensor}, for emulation-scale N."""
        N, P = X.shape
        out = {}
        for r in range(N):
            nbrs = [int(i) for i in np.nonzero(self.adj[r])[0]]
            for i in nbrs:
                msg = X[i].to(torch.float32)
                for j in nbrs:
                    if j == i:
                        continue
                    a, b = (i, j) if i < j else (j, i)
                    sign = 1.0 if i < j else -1.0
                    msg = msg + sign * _pair_mask(key, rnd, a, b, r, P, self.mask_bound, X.device)
                out[(i, r)] = msg
        return out

    def round(self, X, W, state, key, degree, rnd=0, act=None):
        """Masked aggregation.  W (dense (N, N) tensor or SparseTopology on
        X's device) gives equal weight w to all of a receiver's neighbours;
        ``act`` is the (N,) participation mask on X's device (recovery
        only), with which W already carries the churn reweight."""
        if isinstance(W, (ShardedTopology, ShardedDense)):
            return self._round_sharded(X, W, state, key, degree, rnd, act)
        nbr, validf = self._tables(X.device)
        if isinstance(W, SparseTopology):
            # equal weights: any live slot's weight is w, and the row max
            # skips w=0 padding and churn-zeroed slots
            wvec = W.w.to(torch.float32).amax(1)
        else:
            wvec = (W.to(torch.float32).gather(1, nbr) * validf).amax(1)
        act_nbr = None if act is None else act.to(torch.float32)[nbr]
        return self._masked_aggregate(X.to(torch.float32), nbr, validf, wvec, key, rnd,
                                      degree, X.dtype, state, act_nbr)

    def message_tables(self, key, rnd, device, nbr=None, validf=None, recv=None):
        """The mask kernel's operands for every message of a round, message
        r·D + s being neighbour slot s's copy for receiver r: (rows (N·D,)
        int32, the sender of each message; keys (N·D, D, 2) int64 words of
        the pair PRF with each co-neighbour slot; signs (N·D, D) fp32, +1
        where the sender is the smaller id, -1 where it is the larger, 0 on
        the sender itself and on invalid slots).  Computed on ``device``,
        over the whole table, or over the receiver rows ``recv`` (global
        ids) whose (B, D) neighbour table ``nbr`` (global ids, int64) and
        validity ``validf`` are given."""
        if nbr is None:
            nbr, validf = self._tables(device)
        N, D = nbr.shape
        i_mat, j_mat = nbr[:, :, None], nbr[:, None, :]            # sender, co-neighbour
        signs = (torch.where(i_mat < j_mat, 1.0, -1.0) * validf[:, None, :]
                 * (1.0 - torch.eye(D, dtype=torch.float32, device=nbr.device)))
        r = (torch.arange(N, dtype=torch.int64, device=nbr.device) if recv is None
             else recv.to(torch.int64))[:, None, None]
        keys = prng.key_data(pair_keys(prng.fold_in(key, rnd), torch.minimum(i_mat, j_mat),
                                       torch.maximum(i_mat, j_mat), r))
        return (nbr.reshape(-1).to(torch.int32), keys.reshape(N * D, D, 2),
                signs.reshape(N * D, D))

    def _round_sharded(self, X, W, state, key, degree, rnd, act=None):
        """The node-sharded round: X is this rank's (B, P) rows, W a
        sharded operand, ``act`` this rank's (B,) block.  The messages'
        senders are read from the operand's local stack of exchanged rows
        (the slot-permutation exchange, or the all-gather) and the masks
        are keyed by global node ids, so every pair cancels as on one
        device.  Recovery (``act`` given) uses the canonical neighbour
        table at this rank's rows, over the all-gathered rows: the
        operand's churn-zeroed weights cannot be told apart from its
        padding, and recovery must see the schedule the masks were keyed
        over."""
        Xf = X.to(torch.float32)
        rows = W.rows
        if isinstance(W, ShardedTopology) and act is None:
            nbr = W.nbr.to(torch.int64)
            validf = (W.w > 0).to(torch.float32)
            wvec = W.w.to(torch.float32).amax(1)
            src = W.exchange(Xf), W.merge_tables(include_self=False)[0]
        else:
            nbr_all, valid_all = self._tables(X.device)
            nbr, validf = nbr_all[rows], valid_all[rows]
            if isinstance(W, ShardedTopology):
                wvec = W.w.to(torch.float32).amax(1)
            else:
                wvec = (W.W.to(torch.float32).gather(1, nbr) * validf).amax(1)
            src = W.shard.gather(Xf), nbr
        act_nbr = None if act is None else W.shard.gather(act.to(torch.float32))[nbr]
        return self._masked_aggregate(Xf, nbr, validf, wvec, key, rnd, degree, X.dtype, state,
                                      act_nbr, recv=rows, src=src)

    def _masked_aggregate(self, Xf, nbr, validf, wvec, key, rnd, degree, dtype, state,
                          act_nbr=None, recv=None, src=None):
        """Pass 1 applies the masks every sender transmitted (it masks
        against every valid co-neighbour: it does not know who dropped);
        with ``act_nbr`` (the neighbour slots' participation, (N, D)) pass 2
        subtracts the (sender, dropped co-neighbour) masks in place and the
        receiver sums its live slots only.  ``recv`` and ``src`` are the
        sharded round's: the receivers' global ids, and (the rows the
        senders are read from, each message's row in them (B, D))."""
        N, P = Xf.shape
        D = nbr.shape[1]
        if recv is None:
            rows, keys, signs = self.message_tables(key, rnd, Xf.device)
            base = Xf
        else:
            _, keys, signs = self.message_tables(key, rnd, Xf.device, nbr, validf, recv)
            base, table = src
            rows = table.reshape(-1).to(torch.int32).contiguous()
        msgs = secure_mask_apply_rows_keyed(base, rows, keys, signs, self.mask_bound)  # (N·D, P)
        live = validf
        if act_nbr is not None:
            down = validf * (1.0 - act_nbr)                         # dropped co-neighbours
            secure_mask_apply_rows_keyed(
                msgs, None, keys, -signs * down.repeat_interleave(D, 0), self.mask_bound,
                out=msgs)
            live = validf * act_nbr
        # the live slots' sum, reading each message once (weights 0 or 1,
        # so the merge's fused multiply-adds round as the reference's sum)
        slots = torch.arange(N * D, dtype=torch.int32, device=Xf.device).view(N, D)
        total = gossip_mix_rows(msgs, slots, live.contiguous())
        del msgs
        deg_r = live.sum(1)
        acc = (1.0 - wvec * deg_r)[:, None] * Xf + wvec[:, None] * total
        X2 = torch.where((deg_r > 0)[:, None], acc, Xf)
        item = torch.empty((), dtype=dtype).element_size()
        return X2.to(dtype), state, wire_bytes(degree, P, item)

    def wire_dtype(self, x_dtype) -> str:
        return str(x_dtype).replace("torch.", "")

    def stage_bytes_per_round(self, n: int, p: int) -> int:
        # recovery stages a second full mask pass over the messages
        return n * p * 4 * (2 if self.recovery else 1)

    def round_reference(self, X, W, state, key, degree: float, rnd: int = 0):
        """Python-scheduled reference: aggregate the dict of masked
        messages.  W is the dense (N, N) matrix."""
        N, P = X.shape
        Xf = X.to(torch.float32)
        msgs = self.messages(Xf, key, rnd)
        Wn = np.asarray(W.cpu() if isinstance(W, torch.Tensor) else W)
        rows = []
        for r in range(N):
            nbrs = [int(i) for i in np.nonzero(self.adj[r])[0]]
            w = float(Wn[r, nbrs[0]]) if nbrs else 0.0
            acc = (1.0 - w * len(nbrs)) * Xf[r]
            for i in nbrs:
                acc = acc + w * msgs[(i, r)]
            rows.append(acc)
        X2 = torch.stack(rows).to(X.dtype)
        item = torch.empty((), dtype=X.dtype).element_size()
        return X2, state, wire_bytes(degree, P, item)
