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
* Node-sharded gossip over a ``torch.distributed`` group (the JAX
  package's ``shard_map`` forms): :class:`NodeShard` (this rank's block of
  the node axis and its collectives), :class:`ShardedTopology` and
  :class:`ShardedDense` (the mixing operands that :func:`apply_W`,
  :func:`mix_payload` and the strategies take in place of a
  ``SparseTopology`` or a dense W), and :func:`mix_sparse_shmap`,
  :func:`mix_circulant_shmap` and :func:`mix_compressed_circulant_shmap`.

Summation order: the kernel adds the self slot first and then the
neighbour slots in order; the JAX ``apply_W`` adds ``w_self * x`` after the
neighbour contraction.  The two agree to fp32 rounding, not bitwise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.topology import (
    SparseTopology,
    build_permute_schedule,
    circulant_offsets,
    decompose_slot_permutations,
    sample_neighbor_slots,
)
from repro_torch.kernels.gossip_mix import gossip_mix_rows
from repro_torch.kernels.scatter_gossip import payload_mix_rows
from repro_torch.utils.pytree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# node-sharded gossip over torch.distributed
# ---------------------------------------------------------------------------
#
# The node axis is block-sharded over the ranks of a process group: rank d
# holds the B = N/S consecutive rows [d·B, (d+1)·B) of every node-stacked
# tensor.  Each rank is its own process (the launcher is
# ``launch/shard.py``), where the JAX package runs one ``shard_map``
# program over its devices.  Two mixing operands stand in for the
# single-device ones, and ``apply_W`` / ``mix_payload`` dispatch on them,
# so every sharing strategy runs sharded unchanged:
#
# * ``ShardedTopology`` — this rank's (B, D) neighbour rows.  Each mix
#   first builds the rank's local stack L of operand rows, then makes ONE
#   launch of the gather-merge kernel over it with a cached local index
#   table.  Backend 'gather': L is the all-gathered (N, ...) tensor and the
#   table holds the global neighbour ids, so each row's arithmetic is the
#   single-device merge's, bit for bit.  Backend 'ppermute': the table is
#   slot-rebalanced into permutation columns
#   (``topology.decompose_slot_permutations``) and each slot's rows that
#   cross ranks move in one point-to-point exchange per rank rotation
#   (``topology.build_permute_schedule``; rotation 0 is a local read):
#   L = [own rows; received rows], O(D·B·P) bytes instead of all-gather's
#   O(N·P).  The local table then points each slot of the table as it is
#   at an L row holding that neighbour, so the merge adds in the table's
#   own slot order: bitwise the single-device merge here too.
# * ``ShardedDense`` — this rank's (B, N) rows of a dense W; all-gather
#   and a local product.


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(eq=False)
class NodeShard:
    """This rank's block of a node axis block-sharded over the default
    ``torch.distributed`` group: ``ndev`` ranks of ``block`` rows each.

    The collectives (``gather``, ``psum``, ``pmax``, ``exchange``) move
    the tensor's memory directly where the group's backend can (nccl, or
    gloo on CPU tensors).  Gloo cannot move CUDA memory, so there each
    collective copies its operands into pinned host buffers and its results
    back, explicitly: ``staged_bytes`` counts those copies (both
    directions), the transport's cost.  ``sent_bytes`` counts the payload
    bytes this rank hands the group for other ranks."""

    ndev: int
    block: int
    rank: int
    sent_bytes: int = 0
    staged_bytes: int = 0

    @staticmethod
    def of_group(n: int) -> "NodeShard":
        """The sharding of ``n`` nodes over the initialized default group."""
        if not dist.is_initialized():
            raise RuntimeError(
                "node sharding runs one process per rank under an initialized "
                "torch.distributed group; start the ranks with "
                "repro_torch.launch.shard.run")
        ndev, rank = dist.get_world_size(), dist.get_rank()
        if n % ndev:
            raise ValueError(f"N={n} nodes do not divide evenly over {ndev} ranks")
        return NodeShard(ndev, n // ndev, rank)

    @property
    def n(self) -> int:
        return self.ndev * self.block

    @property
    def backend(self) -> str:
        return str(dist.get_backend())

    def dev(self) -> int:
        """This rank's index along the node axis."""
        return self.rank

    def rows(self, device=None) -> torch.Tensor:
        """Global node ids of this rank's block, (B,) int64."""
        lo = self.rank * self.block
        return torch.arange(lo, lo + self.block, device=device)

    def local(self, x, axis: int = 0):
        """This rank's B rows of a replicated array whose node axis is
        ``axis`` ((N, ...) by default)."""
        lo = self.rank * self.block
        return x[(slice(None),) * axis + (slice(lo, lo + self.block),)]

    def _staged(self, x) -> bool:
        return x.device.type != "cpu" and self.backend == "gloo"

    def _host(self, x):
        """A pinned host copy of ``x`` (counted as staged)."""
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        self.staged_bytes += _nbytes(x)
        return h

    def _back(self, out, h):
        out.copy_(h)
        self.staged_bytes += _nbytes(out)
        return out

    def gather(self, x):
        """All-gather the node axis: (B, ...) -> (N, ...)."""
        x = x.contiguous()
        out = torch.empty((self.n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        self.sent_bytes += _nbytes(x) * (self.ndev - 1)
        if not self._staged(x):
            dist.all_gather_into_tensor(out, x)
            return out
        h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.all_gather_into_tensor(h_out, self._host(x))
        return self._back(out, h_out)

    def _reduce(self, x, op):
        x = x.clone()
        self.sent_bytes += _nbytes(x)
        if not self._staged(x):
            dist.all_reduce(x, op=op)
            return x
        h = self._host(x)
        dist.all_reduce(h, op=op)
        return self._back(x, h)

    def psum(self, x):
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)

    def exchange(self, send, sends, recv, recvs):
        """One batch of point-to-point transfers: ``send[lo:hi]`` to each
        ``(peer, lo, hi, tag)`` of ``sends`` and ``recv[lo:hi]`` from each
        of ``recvs`` (both buffers contiguous along dim 0).  Every rank enumerates its transfers in the same order
        and tags a message by its slot, so nccl's ordered matching and
        gloo's tags pair them alike."""
        if not sends and not recvs:
            return recv
        staged = self._staged(send) or self._staged(recv)
        s, r = send, recv
        if staged:
            s = self._host(send)
            r = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True)
        ops = [dist.P2POp(dist.isend, s[lo:hi], p, tag=tag) for p, lo, hi, tag in sends]
        ops += [dist.P2POp(dist.irecv, r[lo:hi], p, tag=tag) for p, lo, hi, tag in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        row = _nbytes(send[:1]) if send.shape[0] else 0
        self.sent_bytes += row * sum(hi - lo for _, lo, hi, _ in sends)
        return self._back(recv, r) if staged else recv


@dataclasses.dataclass(eq=False)
class _ExchangePlan:
    """One rank's static transfers of a permutation schedule: the local
    rows it sends (``send_rows``, in the order of ``sends``), the
    ``(peer, lo, hi, tag)`` slices of the send and receive buffers, the
    received row count, and the (B, S) local table: slot s of row i reads
    row ``table[i, s]`` of L = [own rows; received rows]."""

    send_rows: np.ndarray
    sends: List[Tuple[int, int, int, int]]
    recvs: List[Tuple[int, int, int, int]]
    n_recv: int
    table: np.ndarray


@dataclasses.dataclass(eq=False)
class PermuteSchedule:
    """Static rotation-grouped transfer tables for per-slot permutation
    gossip (``topology.build_permute_schedule``).  Engines build one per
    static topology and reuse it; each rank's plan is derived once."""

    slots: list  # per slot: {rotation: (send_idx (ndev, K), recv_pos (ndev, K))}
    _plans: Dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def from_table(nbr_perm, ndev: int) -> "PermuteSchedule":
        return PermuteSchedule(build_permute_schedule(np.asarray(nbr_perm), ndev))

    def plan(self, rank: int, block: int) -> _ExchangePlan:
        """This rank's transfers.  Only the rows that cross ranks move,
        and only the real ones: both ends know each count from the
        schedule, so the padded lanes never go on the wire."""
        if (rank, block) in self._plans:
            return self._plans[(rank, block)]
        ndev = next(iter(self.slots[0].values()))[0].shape[0] if self.slots else 1
        table = np.full((block, len(self.slots)), -1, np.int64)
        send_rows, sends, recvs = [], [], []
        n_recv = 0
        for s, slot in enumerate(self.slots):
            for r in sorted(slot):
                send_idx, recv_pos = slot[r]
                if r == 0:  # a local move: read the rows in place
                    m = recv_pos[rank] < block
                    table[recv_pos[rank][m], s] = send_idx[rank][m]
                    continue
                tag = s * ndev + r
                c_send = int((recv_pos[(rank + r) % ndev] < block).sum())
                c_recv = int((recv_pos[rank] < block).sum())
                if c_send:
                    sends.append(((rank + r) % ndev, len(send_rows), len(send_rows) + c_send, tag))
                    send_rows.extend(int(i) for i in send_idx[rank][:c_send])
                if c_recv:
                    recvs.append(((rank - r) % ndev, n_recv, n_recv + c_recv, tag))
                    table[recv_pos[rank][:c_recv], s] = block + n_recv + np.arange(c_recv)
                    n_recv += c_recv
        if (table < 0).any():
            raise ValueError("the schedule's slots are not permutations")
        plan = _ExchangePlan(np.asarray(send_rows, np.int64), sends, recvs, n_recv, table)
        self._plans[(rank, block)] = plan
        return plan


def _exchange_rows(x, plan: _ExchangePlan, shard: NodeShard, send_rows):
    """L = [x; the rows this rank receives] for a plan, x (B, ...)."""
    L = torch.empty((x.shape[0] + plan.n_recv,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    L[:x.shape[0]] = x
    shard.exchange(x.index_select(0, send_rows).contiguous(), plan.sends,
                   L[x.shape[0]:], plan.recvs)
    return L


def _permute_block(x, slot_sched, shard: NodeShard):
    """Apply one global node permutation to this rank's (B, ...) block:
    out[i] = x_global[src[global_row(i)]], one exchange per rotation that
    carries rows (rotation 0 a local read).  The JAX package's per-slot
    primitive, kept for its surface: the sharded operands exchange all of
    a table's slots at once (:meth:`ShardedTopology.exchange`)."""
    plan = PermuteSchedule([slot_sched]).plan(shard.rank, shard.block)
    L = _exchange_rows(x, plan, shard, torch.as_tensor(plan.send_rows, device=x.device))
    return L.index_select(0, torch.as_tensor(plan.table[:, 0], device=x.device))


def _in_slot_order(table, slot_nbr, nbr):
    """Re-read a plan's (B, D) local table, whose slots follow the
    rebalanced rows ``slot_nbr``, in the slot order of the rows ``nbr``
    (the same neighbours per row, in another order): each slot reads an L
    row that holds its neighbour.  Copies of one neighbour's row are
    equal, so any of them serves."""
    out = np.empty_like(table)
    for i in range(table.shape[0]):
        where = dict(zip(slot_nbr[i].tolist(), table[i].tolist()))
        out[i] = [where[j] for j in nbr[i].tolist()]
    return out


@dataclasses.dataclass(eq=False)
class ShardedTopology:
    """Node-sharded view of a SparseTopology: ``topo`` holds this rank's
    (B, D) rows with global neighbour ids, as tensors on the rank's
    device.  With ``sched`` (ppermute), ``ltable`` is the (B, D) local
    table into :meth:`exchange`'s L in ``topo``'s slot order.  Churn
    reweights change its weights per round (:meth:`reweighted`) while the
    exchange plan and the local index table stay."""

    topo: SparseTopology
    shard: NodeShard
    sched: Optional[PermuteSchedule] = None
    ltable: Optional[np.ndarray] = None
    _link: Dict = dataclasses.field(default_factory=dict, repr=False)
    _merge: Dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def rows(self) -> torch.Tensor:
        return self.shard.rows(self.topo.w.device)

    @property
    def nbr(self):
        return self.topo.nbr

    @property
    def w(self):
        return self.topo.w

    def _tables(self):
        """(local table (B, D) int32 into L, self column (B, 1) int32,
        send rows or None), built once per topology and its reweights."""
        if not self._link:
            dev = self.topo.w.device
            if self.sched is None:
                table = self.topo.nbr.to(torch.int32)
                self_col = self.rows.to(torch.int32)
                send_rows = None
            else:
                plan = self.sched.plan(self.shard.rank, self.shard.block)
                table = torch.as_tensor(self.ltable, dtype=torch.int32, device=dev)
                self_col = torch.arange(self.shard.block, dtype=torch.int32, device=dev)
                send_rows = torch.as_tensor(plan.send_rows, device=dev)
            self._link.update(table=table.contiguous(), self_col=self_col[:, None],
                              send_rows=send_rows)
        return self._link["table"], self._link["self_col"], self._link["send_rows"]

    def exchange(self, Y):
        """This rank's local stack L of operand rows for the node-stacked
        block Y (B, ...): the all-gathered (N, ...) tensor (gather), or
        [Y; the rows received for every slot] (ppermute)."""
        if self.sched is None:
            return self.shard.gather(Y)
        _, _, send_rows = self._tables()
        plan = self.sched.plan(self.shard.rank, self.shard.block)
        return _exchange_rows(Y, plan, self.shard, send_rows)

    def merge_tables(self, include_self: bool = True):
        """(rows (B, [1+]D) int32 into :meth:`exchange`'s L, weights fp32):
        the merge kernels' operands, the self slot first unless dropped."""
        if include_self not in self._merge:
            table, self_col, _ = self._tables()
            w = self.topo.w.to(torch.float32)
            if include_self:
                rows = torch.cat([self_col, table], 1).contiguous()
                w = torch.cat([self.topo.w_self.to(torch.float32)[:, None], w], 1)
            else:
                rows = table
            self._merge[include_self] = (rows, w.contiguous())
        return self._merge[include_self]

    def reweighted(self, w, w_self) -> "ShardedTopology":
        """The same rows and exchange with the weights ``w`` (B, D) and
        ``w_self`` (B,)."""
        return ShardedTopology(SparseTopology(self.topo.nbr, w, w_self), self.shard, self.sched,
                               self.ltable, _link=self._link)

    def neighbor_stack(self, Y):
        """(B, D, ...) stack of each local receiver's neighbour rows."""
        table, _, _ = self._tables()
        L = self.exchange(Y)
        return L.index_select(0, table.reshape(-1).long()).reshape(
            table.shape + tuple(Y.shape[1:]))

    def apply(self, Yf):
        """This rank's rows of W @ Y_global, Yf (B, ...) fp32: one launch
        of the gather-merge kernel over the local stack."""
        flat = Yf.reshape(Yf.shape[0], -1)
        return gossip_mix_rows(self.exchange(flat), *self.merge_tables()).reshape(Yf.shape)


@dataclasses.dataclass(eq=False)
class ShardedDense:
    """Node-sharded dense mixing operand: this rank's (B, N) rows of W."""

    W: torch.Tensor
    shard: NodeShard

    @property
    def rows(self) -> torch.Tensor:
        return self.shard.rows(self.W.device)

    def apply(self, Yf):
        flat = Yf.reshape(Yf.shape[0], -1)
        return (self.W.to(torch.float32) @ self.shard.gather(flat)).reshape(Yf.shape)


def shard_topology(topo: SparseTopology, shard: NodeShard, device,
                   backend: str = "gather") -> ShardedTopology:
    """This rank's :class:`ShardedTopology` of a global numpy table, its
    rows as they are: backend 'gather' all-gathers; 'ppermute'
    slot-rebalances the table and exchanges by the rebalanced table's
    schedule; a table that does not decompose raises."""
    lo, hi = shard.rank * shard.block, (shard.rank + 1) * shard.block
    nbr = np.asarray(topo.nbr)[lo:hi]
    local = SparseTopology(nbr, np.asarray(topo.w)[lo:hi], np.asarray(topo.w_self)[lo:hi])
    if backend != "ppermute":
        return ShardedTopology(local.to(device), shard)
    dec = decompose_slot_permutations(topo)
    if dec is None:
        raise ValueError("topology does not decompose into per-slot permutations; "
                         "use the 'gather' backend")
    sched = PermuteSchedule.from_table(dec.nbr, shard.ndev)
    plan = sched.plan(shard.rank, shard.block)
    ltable = _in_slot_order(plan.table, np.asarray(dec.nbr)[lo:hi], nbr)
    return ShardedTopology(local.to(device), shard, sched, ltable)


def _mix_rows(W):
    """Global node ids of a mixing operand's rows: this rank's block for
    the sharded operands, None (arange) otherwise."""
    return W.rows if isinstance(W, (ShardedTopology, ShardedDense)) else None


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
    Y's device, or a sharded operand (:class:`ShardedTopology`,
    :class:`ShardedDense`) with Y this rank's (B, ...) rows.
    """
    Yf = Y.to(torch.float32)
    if isinstance(W, (ShardedTopology, ShardedDense)):
        return W.apply(Yf)  # Y is this rank's block of rows
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
    cached merge tables), a :class:`ShardedTopology` (the same launch over
    this rank's local stacks of exchanged payloads; X, idx and val are
    this rank's rows), a :class:`ShardedDense` (all-gathered payloads
    through the dense-mask rule) or a dense (N, N) tensor (the dense-mask
    oracle).
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
    if isinstance(W, ShardedTopology):
        # the (B, k) payloads ride the operand's exchange: O(D·B·k) bytes
        rows, w = W.merge_tables(include_self=not exact_values)
        return payload_mix_rows(Xf, W.exchange(idx.to(torch.int32)), W.exchange(valf), rows, w,
                                sorted_idx=sorted_idx)
    if isinstance(W, ShardedDense):
        idx_g, val_g = W.shard.gather(idx.to(torch.int32)), W.shard.gather(valf)
        MX = _scatter_rows(idx_g, val_g, (idx_g.shape[0], Xf.shape[1]))
        M = _scatter_rows(idx_g, torch.ones_like(val_g), MX.shape)
        Wf = W.W.to(torch.float32)
        return Xf + Wf @ MX - Xf * (Wf @ M)
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
    cells = torch.arange(k, dtype=torch.int32, device=X.device)[None, :] * stride
    if isinstance(W, ShardedTopology):
        # one phase per sender on the wire, its index row rebuilt here
        rows, w = W.merge_tables(include_self=not exact_values)
        idx = cells + W.exchange(phase.to(torch.int32))[:, None]
        return payload_mix_rows(X.to(torch.float32), idx, W.exchange(val.to(torch.float32)),
                                rows, w, sorted_idx=True)
    idx = cells + phase.to(torch.int32)[:, None]
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


# ---------------------------------------------------------------------------
# node-sharded tree mixings (the JAX package's shard_map functions)
# ---------------------------------------------------------------------------


def mix_sparse_shmap(stacked, topo: SparseTopology, shard: Optional[NodeShard] = None, *,
                     backend: str = "auto"):
    """Node-sharded ``mix_sparse``: every leaf of ``stacked`` is this
    rank's (B, ...) block of a node-stacked tree over the global numpy
    table ``topo``; returns this rank's block of the mixed tree.

    backend: 'ppermute' (point-to-point exchanges of the rows that cross
    ranks, by the slot-rebalanced table's schedule), 'gather'
    (all-gather) or 'auto' (ppermute where the table decomposes, as the
    JAX package picks); both merge in the table's own slot order.  ``shard`` defaults to the default process group's.  One
    gather-merge launch per leaf."""
    if backend not in ("auto", "ppermute", "gather"):
        raise ValueError(f"unknown backend {backend!r} (auto|ppermute|gather)")
    shard = shard or NodeShard.of_group(topo.n)
    if shard.n != topo.n:
        raise ValueError(f"N={topo.n} nodes over {shard.ndev} ranks of {shard.block} rows")
    if backend == "auto":
        backend = "gather" if decompose_slot_permutations(topo) is None else "ppermute"
    st = shard_topology(topo, shard, tree_leaves(stacked)[0].device, backend)
    return tree_map(lambda a: st.apply(a.to(torch.float32)).to(a.dtype), stacked)


def _circulant_links(n: int, degree: int, rank: int, weights=None):
    """Rank ``rank``'s circulant neighbours, one node per rank: the peers
    it sends to and receives from for each slot, in the JAX package's
    order (per offset o: from rank - o, then from rank + o unless o is
    antipodal), with each slot's weight and the self weight."""
    offs = circulant_offsets(n, degree)
    wts = ([1.0 / (degree + 1)] * (1 + len(offs)) if weights is None
           else [float(v) for v in torch.as_tensor(weights).reshape(-1)])
    links = []  # (send to, receive from, weight)
    for k, o in enumerate(offs):
        links.append(((rank + o) % n, (rank - o) % n, wts[1 + k]))
        if 2 * o % n != 0:
            links.append(((rank - o) % n, (rank + o) % n, wts[1 + k]))
    return links, wts[0]


def _node_per_rank(shard: Optional[NodeShard], what: str) -> NodeShard:
    """``shard``, or the default group's one node per rank, checked."""
    if shard is None:
        shard = NodeShard.of_group(dist.get_world_size() if dist.is_initialized() else 1)
    if shard.block != 1:
        raise ValueError(f"{what} holds one node per rank")
    return shard


def _exchange_each(shard: NodeShard, x, links):
    """[x; what each link brings]: x sent to every link's peer, one row
    block received from each (a batch of point-to-point transfers)."""
    b = x.shape[0]
    L = torch.empty((b * (1 + len(links)),) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    L[:b] = x
    sends = [(to, 0, b, j) for j, (to, _, _) in enumerate(links)]
    recvs = [(frm, j * b, (j + 1) * b, j) for j, (_, frm, _) in enumerate(links)]
    shard.exchange(x.contiguous(), sends, L[b:], recvs)
    return L


def mix_circulant_shmap(stacked, shard: Optional[NodeShard], degree: int, weights=None):
    """Circulant gossip with one node per rank (N = the group's size):
    per leaf, one batch of point-to-point exchanges carrying this rank's
    (1, ...) block to its 2·offsets neighbours (one for the antipodal
    offset), then one gather-merge launch over [own; received] — the
    JAX package's per-offset ``collective_permute`` form.  Leaves keep
    their dtype on the wire.  weights: optional (1 + n_offsets,)
    ``[w_self, w_off1, ...]``, default uniform MH 1/(degree+1)."""
    sh = _node_per_rank(shard, "mix_circulant_shmap")

    def f(a):
        if a.shape[0] != 1:
            raise ValueError("mix_circulant_shmap holds one node per rank")
        links, w0 = _circulant_links(sh.ndev, degree, sh.rank, weights)
        flat = a.reshape(1, -1)
        L = _exchange_each(sh, flat, links)
        w = torch.tensor([[w0] + [wt for _, _, wt in links]], dtype=torch.float32,
                         device=a.device)
        rows = torch.arange(1 + len(links), dtype=torch.int32, device=a.device)[None, :]
        return gossip_mix_rows(L, rows, w).reshape(a.shape)

    return tree_map(f, stacked)


ROW = 1 << 20  # compressed mixing's row block: int32 indices at any leaf size


def mix_compressed_circulant_shmap(stacked, shard: Optional[NodeShard], degree: int, *,
                                   budget: float = 0.1, mode: str = "sparse", weights=None):
    """Compressed circulant gossip with one node per rank: the trainer's
    ``mixing_impl`` 'sparse', 'quant' and 'sparse+quant'.

    Per leaf, this rank's block is cut into rows of ``ROW`` elements
    (zero-padded); 'sparse' keeps the top ``budget`` fraction of each row
    by magnitude (``sharing._topk_idx``: the exact sort on the CPU, the
    histogram selector's kernels on the card), 'quant' codes the values
    int8 with one fp32 scale per row (the quantize kernel; the receivers
    dequantize with the dequantize kernel).  Only the compressed payload
    moves, and the receiver applies the missing-coordinate rule

        x_i' = x_i + sum_nbr w * scatter(idx_nbr, vals_nbr - x_i[idx_nbr])

    in one payload-merge launch ('sparse' modes) or one gather-merge
    launch over [x_i; dequantized rows] with weights [1 - S·w, w, ...]
    ('quant', every coordinate present).  The JAX package accumulates
    ``w * (v - x)`` per neighbour: the same sums to fp32 rounding."""
    from repro_torch.core.compression import dequantize_int8, quantize_int8
    from repro_torch.core.sharing import _topk_idx

    if mode not in ("sparse", "quant", "sparse+quant"):
        raise ValueError(f"unknown mode {mode!r} (sparse|quant|sparse+quant)")

    sh = _node_per_rank(shard, "mix_compressed_circulant_shmap")

    def f(x):
        if x.shape[0] != 1:
            raise ValueError("mix_compressed_circulant_shmap holds one node per rank")
        links, _ = _circulant_links(sh.ndev, degree, sh.rank, weights)
        size = x.numel()
        R = min(ROW, size)
        f32 = F.pad(x.reshape(-1).to(torch.float32), (0, (-size) % R)).reshape(-1, R)
        nr = f32.shape[0]
        idx = None
        vals = f32
        if "sparse" in mode:
            k = max(1, int(budget * R))
            idx = _topk_idx(f32.abs(), k).contiguous()
            vals = f32.gather(1, idx.long())
        if "quant" in mode:
            codes, scale = quantize_int8(vals)
            r_vals = dequantize_int8(_exchange_each(sh, codes, links),
                                     _exchange_each(sh, scale, links))
        else:
            r_vals = _exchange_each(sh, vals, links)
        n_op = len(links)
        w = torch.tensor([wt for _, _, wt in links], dtype=torch.float32, device=x.device)
        recv = (torch.arange(n_op, device=x.device)[None, :] + 1) * nr \
            + torch.arange(nr, device=x.device)[:, None]          # (nr, S): row j of link s
        if idx is not None:
            out = payload_mix_rows(f32, _exchange_each(sh, idx, links), r_vals.contiguous(),
                                   recv.to(torch.int32), w.expand(nr, n_op).contiguous())
        else:
            L = torch.cat([f32, r_vals[nr:]])
            rows = torch.cat([torch.arange(nr, device=x.device)[:, None], recv], 1)
            ws = torch.cat([1.0 - w.sum().reshape(1), w]).expand(nr, 1 + n_op).contiguous()
            out = gossip_mix_rows(L, rows.to(torch.int32).contiguous(), ws)
        return out.reshape(-1)[:size].reshape(x.shape).to(x.dtype)

    return tree_map(f, stacked)


def mixing_bytes_per_node(graph, n_params: int, bytes_per_param: int = 4) -> float:
    """Mean bytes each node sends a round under full sharing (the paper's
    cumulative-bytes metric), over a :class:`~repro_torch.core.topology.Graph`."""
    return float(graph.degrees().mean()) * n_params * bytes_per_param
