"""Graph module: the overlay topology (numpy; tables bitwise those of the
JAX package's ``core/topology.py``).

* :class:`Graph` — dense (N, N) boolean adjacency, for construction,
  file I/O (edge lists, adjacency-list JSON), changes at run time and
  spectral analysis.
* :class:`SparseTopology` — padded (N, D) neighbor and Metropolis-Hastings
  weight tables, the form sparse overlays are executed in.  Built in numpy;
  the engine moves it to the device once with :meth:`SparseTopology.to`.
* :class:`PeerSampler` — the dynamic overlay: a new random d-regular
  graph every round, as per-round tables or stacks of them.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng


@dataclasses.dataclass
class Graph:
    """Undirected overlay graph over ``n`` nodes; adjacency as a bool matrix
    (no self loops stored; every node implicitly talks to itself)."""

    adj: np.ndarray  # (n, n) bool, symmetric, zero diagonal

    @staticmethod
    def ring(n: int) -> "Graph":
        adj = np.zeros((n, n), bool)
        idx = np.arange(n)
        adj[idx, (idx + 1) % n] = True
        adj[(idx + 1) % n, idx] = True
        return Graph(adj)

    @staticmethod
    def fully_connected(n: int) -> "Graph":
        adj = np.ones((n, n), bool)
        np.fill_diagonal(adj, False)
        return Graph(adj)

    @staticmethod
    def star(n: int, center: int = 0) -> "Graph":
        adj = np.zeros((n, n), bool)
        adj[center, :] = True
        adj[:, center] = True
        adj[center, center] = False
        return Graph(adj)

    @staticmethod
    def regular_circulant(n: int, degree: int) -> "Graph":
        """d-regular circulant graph: neighbors at offsets ±1, ±2, … (plus
        n/2 if the degree is odd and n even)."""
        assert 0 < degree < n
        adj = np.zeros((n, n), bool)
        idx = np.arange(n)
        for o in circulant_offsets(n, degree):
            adj[idx, (idx + o) % n] = True
            adj[(idx + o) % n, idx] = True
        return Graph(adj)

    @staticmethod
    def random_regular(n: int, degree: int, seed: int) -> "Graph":
        """Random d-regular graph (see :func:`random_regular_neighbors`)."""
        nbr = random_regular_neighbors(n, degree, seed)
        adj = np.zeros((n, n), bool)
        adj[np.repeat(np.arange(n), degree), nbr.reshape(-1)] = True
        return Graph(adj)

    @staticmethod
    def from_edge_list(path: str, n: int) -> "Graph":
        adj = np.zeros((n, n), bool)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                a, b = map(int, line.split()[:2])
                adj[a, b] = adj[b, a] = True
        np.fill_diagonal(adj, False)
        return Graph(adj)

    @staticmethod
    def from_adjacency_json(path: str) -> "Graph":
        """A graph from a JSON object mapping each node id to its list of
        neighbour ids."""
        with open(path) as f:
            d = json.load(f)
        n = len(d)
        adj = np.zeros((n, n), bool)
        for k, nbrs in d.items():
            for j in nbrs:
                adj[int(k), int(j)] = adj[int(j), int(k)] = True
        np.fill_diagonal(adj, False)
        return Graph(adj)

    def to_edge_list(self, path: str) -> None:
        """Write one ``a b`` line per edge, a < b, in row-major order."""
        with open(path, "w") as f:
            for a, b in zip(*np.nonzero(np.triu(self.adj))):
                f.write(f"{a} {b}\n")

    @property
    def n(self) -> int:
        return self.adj.shape[0]

    def degrees(self) -> np.ndarray:
        return self.adj.sum(1)

    def neighbors(self, i: int) -> np.ndarray:
        return np.nonzero(self.adj[i])[0]

    def is_connected(self) -> bool:
        """Whether every node is reachable from node 0."""
        seen = {0}
        frontier = [0]
        while frontier:
            i = frontier.pop()
            for j in np.nonzero(self.adj[i])[0]:
                if j not in seen:
                    seen.add(int(j))
                    frontier.append(int(j))
        return len(seen) == self.n

    # the graph can change at run time (an engine builds its tables from it
    # when it is constructed)
    def add_edge(self, a: int, b: int) -> None:
        if a != b:
            self.adj[a, b] = self.adj[b, a] = True

    def remove_edge(self, a: int, b: int) -> None:
        self.adj[a, b] = self.adj[b, a] = False

    def neighbor_table(self) -> Tuple[np.ndarray, np.ndarray]:
        return neighbor_table(self.adj)

    def metropolis_hastings(self) -> np.ndarray:
        """Symmetric doubly-stochastic mixing matrix W (Xiao–Boyd):
        W_ij = 1 / (1 + max(deg_i, deg_j)) for edges, diagonal = residual."""
        deg = self.degrees()
        n = self.n
        W = np.zeros((n, n))
        ii, jj = np.nonzero(self.adj)
        W[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
        W[np.arange(n), np.arange(n)] = 1.0 - W.sum(1)
        return W

    def uniform_weights(self) -> np.ndarray:
        """W_ij = 1/(deg_i+1): row-stochastic equal-neighbour weights."""
        n = self.n
        W = self.adj / (self.degrees()[:, None] + 1.0)
        W[np.arange(n), np.arange(n)] = 1.0 / (self.degrees() + 1.0)
        return W

    def spectral_gap(self) -> float:
        """1 - the second largest eigenvalue modulus of the
        Metropolis-Hastings matrix: how fast gossip mixes on the graph."""
        w = np.linalg.eigvalsh(self.metropolis_hastings())
        return 1.0 - max(abs(w[0]), abs(w[-2]))


def neighbor_table(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(nbr (N, dmax) int32, valid (N, dmax) bool) padded neighbor lists;
    short rows are padded with the node's own index and marked invalid."""
    n = adj.shape[0]
    dmax = max(int(adj.sum(1).max()) if n else 0, 1)
    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, dmax))
    valid = np.zeros((n, dmax), bool)
    for r in range(n):
        ns = np.nonzero(adj[r])[0]
        nbr[r, : len(ns)] = ns
        valid[r, : len(ns)] = True
    return nbr, valid


def circulant_offsets(n: int, degree: int) -> List[int]:
    """Offsets of the d-regular circulant graph."""
    offs = list(range(1, degree // 2 + 1))
    if degree % 2 == 1:
        assert n % 2 == 0, "odd degree needs even n (antipodal offset)"
        offs.append(n // 2)
    return offs


def circulant_neighbor_table(n: int, degree: int) -> np.ndarray:
    """(N, degree) int32 neighbor table of the d-regular circulant graph,
    built from the offsets without the (N, N) adjacency; rows sorted
    ascending, as :func:`neighbor_table` gives them."""
    assert 0 < degree < n
    assert n <= np.iinfo(np.int32).max, "node ids are int32 on device"
    idx = np.arange(n, dtype=np.int64)[:, None]
    cols = []
    for o in circulant_offsets(n, degree):
        cols.append((idx + o) % n)
        if (2 * o) % n != 0:  # the antipodal offset is its own inverse
            cols.append((idx - o) % n)
    nbr = np.concatenate(cols, axis=1)
    nbr.sort(axis=1)
    return nbr.astype(np.int32)


def random_regular_neighbors(n: int, degree: int, seed: int) -> np.ndarray:
    """(N, degree) int32 neighbor table of a random simple d-regular graph:
    configuration model with batched re-pairing of self-loops and repeated
    edges, falling back to circulant + double-edge swaps."""
    assert 0 < degree < n and n * degree % 2 == 0, "n*degree must be even"
    assert n <= np.iinfo(np.int32).max, "node ids are int32 on device"
    rng = np.random.default_rng(seed)
    stubs = np.repeat(np.arange(n, dtype=np.int64), degree)
    rng.shuffle(stubs)
    e = stubs.reshape(-1, 2)
    for _ in range(500):
        a, b = e.min(1), e.max(1)
        key = a * n + b
        order = np.argsort(key, kind="stable")
        dup_sorted = np.zeros(key.shape, bool)
        sk = key[order]
        dup_sorted[1:] = sk[1:] == sk[:-1]
        bad = a == b
        bad[order] |= dup_sorted
        n_bad = int(bad.sum())
        if n_bad == 0:
            src = np.concatenate([a, b])
            dst = np.concatenate([b, a])
            o = np.argsort(src, kind="stable")
            return dst[o].reshape(n, degree).astype(np.int32)
        good = np.nonzero(~bad)[0]
        k = min(good.size, max(2 * n_bad, 8))
        pool = np.concatenate([np.nonzero(bad)[0], rng.choice(good, k, replace=False)])
        mixed = e[pool].reshape(-1)
        rng.shuffle(mixed)
        e[pool] = mixed.reshape(-1, 2)
    return _random_regular_swaps(n, degree, rng)


def _random_regular_swaps(n: int, degree: int, rng) -> np.ndarray:
    adj = Graph.regular_circulant(n, degree).adj
    edges = [tuple(e) for e in np.argwhere(np.triu(adj))]
    swaps, target = 0, 10 * len(edges)
    for _ in range(100 * target):
        if swaps >= target:
            break
        i, j = rng.integers(0, len(edges), 2)
        if i == j:
            continue
        (a, b), (c, d) = edges[i], edges[j]
        if rng.random() < 0.5:
            c, d = d, c
        if len({a, b, c, d}) < 4 or adj[a, c] or adj[b, d]:
            continue
        adj[a, b] = adj[b, a] = adj[c, d] = adj[d, c] = False
        adj[a, c] = adj[c, a] = adj[b, d] = adj[d, b] = True
        edges[i], edges[j] = (a, c), (b, d)
        swaps += 1
    ii, jj = np.nonzero(adj)
    return jj.reshape(n, degree).astype(np.int32)


def mh_weight_table(nbr: np.ndarray, valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Metropolis–Hastings weights in neighbor-slot form: (w (N, D) float32,
    0 on padding; w_self (N,) float32, the diagonal residual)."""
    deg = valid.sum(1).astype(np.float64)
    w = np.where(valid, 1.0 / (1.0 + np.maximum(deg[:, None], deg[nbr])), 0.0)
    w_self = 1.0 - w.sum(1)
    return w.astype(np.float32), w_self.astype(np.float32)


@dataclasses.dataclass(eq=False)
class SparseTopology:
    """Neighbor-indexed mixing topology: padded (N, D) tables.

    ``nbr[i, k]`` is node i's k-th neighbor (padded with i itself),
    ``w[i, k]`` its weight (0 on padding) and ``w_self[i]`` the diagonal
    weight.  Fields are numpy arrays, or tensors after :meth:`to`.
    """

    nbr: object     # (N, D) int32
    w: object       # (N, D) float32
    w_self: object  # (N,) float32
    _merge: Dict[bool, Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=dict, init=False, repr=False
    )

    @property
    def n(self) -> int:
        return self.nbr.shape[-2]

    @property
    def dmax(self) -> int:
        return self.nbr.shape[-1]

    def stage_bytes(self) -> int:
        """Host->device bytes of the tables (vs 4·N² for a dense W)."""
        return int(sum(np.asarray(a).nbytes for a in (self.nbr, self.w, self.w_self)))

    def to(self, device) -> "SparseTopology":
        """The same tables as tensors on ``device``."""
        return SparseTopology(
            torch.as_tensor(np.asarray(self.nbr), dtype=torch.int32, device=device),
            torch.as_tensor(np.asarray(self.w), dtype=torch.float32, device=device),
            torch.as_tensor(np.asarray(self.w_self), dtype=torch.float32, device=device),
        )

    def merge_tables(self, include_self: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows (N, 1+D) int32, weights (N, 1+D) fp32): the self slot
        first, then the neighbor slots — the operands of the merge
        kernels.  ``include_self=False`` drops the self slot: (N, D)
        contiguous tables.  Each form is built once per topology and
        cached."""
        if include_self not in self._merge:
            from repro_torch.kernels.gossip_mix import merge_tables

            rows, w = merge_tables(
                torch.as_tensor(self.nbr), torch.as_tensor(self.w),
                torch.as_tensor(self.w_self),
            )
            if not include_self:
                rows, w = rows[:, 1:].contiguous(), w[:, 1:].contiguous()
            self._merge[include_self] = (rows, w)
        return self._merge[include_self]

    def reweighted(self, w, w_self) -> "SparseTopology":
        """A new topology over this one's neighbour table with the weights
        ``w`` (N, D) and ``w_self`` (N,) (tensors on the table's device).
        The neighbour ids this one's merge tables were checked for carry
        over, so building the new tables reads nothing from the device;
        this object and its cached tables are left as they are."""
        t = SparseTopology(self.nbr, w, w_self)
        rows = self.merge_tables()[0]
        t._merge[True] = (rows, torch.cat([w_self.to(torch.float32)[:, None],
                                           w.to(torch.float32)], 1))
        t._merge[False] = (self.merge_tables(include_self=False)[0],
                           w.to(torch.float32).contiguous())
        return t

    @staticmethod
    def from_graph(g: Graph) -> "SparseTopology":
        nbr, valid = neighbor_table(g.adj)
        w, w_self = mh_weight_table(nbr, valid)
        return SparseTopology(nbr, w, w_self)

    @staticmethod
    def regular_circulant(n: int, degree: int) -> "SparseTopology":
        """Bitwise ``from_graph(Graph.regular_circulant(n, degree))``,
        built in O(N·d) without the (N, N) adjacency."""
        nbr = circulant_neighbor_table(n, degree)
        w, w_self = mh_weight_table(nbr, np.ones(nbr.shape, bool))
        return SparseTopology(nbr, w, w_self)

    @staticmethod
    def from_neighbors(nbr: np.ndarray, valid: Optional[np.ndarray] = None) -> "SparseTopology":
        if valid is None:
            valid = np.ones(nbr.shape, bool)
        w, w_self = mh_weight_table(np.asarray(nbr), np.asarray(valid))
        return SparseTopology(np.asarray(nbr, np.int32), w, w_self)

    def to_dense(self) -> np.ndarray:
        """(N, N) float32 W — the oracle for the sparse path."""
        n, d = self.n, self.dmax
        W = np.zeros((n, n), np.float32)
        np.add.at(
            W,
            (np.repeat(np.arange(n), d), np.asarray(self.nbr).reshape(-1)),
            np.asarray(self.w).reshape(-1),
        )
        W[np.arange(n), np.arange(n)] += np.asarray(self.w_self)
        return W


def stage_rounds(stack: "SparseTopology", device) -> List["SparseTopology"]:
    """The rounds of an (R, N, D) table stack on ``device``, one
    :class:`SparseTopology` per round, each with its merge tables (both
    forms of :meth:`SparseTopology.merge_tables`) built on the host and
    sent with the tables in one copy each, so that no round reads the
    device to check its neighbour ids.  Every round is a fresh object: no
    round sees another's cached tables."""
    nbr = np.asarray(stack.nbr, np.int32)
    r, n, d = nbr.shape
    if nbr.size and (nbr.min() < 0 or nbr.max() >= n):
        raise ValueError("neighbor ids out of range [0, N)")
    rows = np.concatenate([np.broadcast_to(np.arange(n, dtype=np.int32)[None, :, None],
                                           (r, n, 1)), nbr], 2)
    w = np.asarray(stack.w, np.float32)
    w_self = np.asarray(stack.w_self, np.float32)
    ws = np.concatenate([w_self[:, :, None], w], 2)
    rows_d, ws_d, w_d, w_self_d = (torch.as_tensor(a, device=device)
                                   for a in (rows, ws, w, w_self))
    views = []
    for i in range(r):
        nbr_i = rows_d[i, :, 1:].contiguous()
        t = SparseTopology(nbr_i, w_d[i], w_self_d[i])
        t._merge[True] = (rows_d[i], ws_d[i])
        t._merge[False] = (nbr_i, w_d[i])
        views.append(t)
    return views


def decompose_slot_permutations(topo: SparseTopology) -> Optional[SparseTopology]:
    """Slot-rebalance a padded (N, D) neighbour table so that every column
    is a permutation of range(N), the form node-sharded gossip exchanges
    slot by slot (``mixing.PermuteSchedule``).

    Counting the padding self-edges, a symmetric graph's directed-edge
    bipartite multigraph is D-regular, so König's theorem splits it into D
    perfect matchings; each becomes one slot, and the weights travel with
    their edges, so ``to_dense`` of the result equals ``to_dense(topo)``.
    Kuhn's augmenting paths find the matchings, receiver by receiver and
    edge by edge in the JAX package's order, so the tables are bitwise its
    tables.  Returns None where no perfect matching exists (an asymmetric
    or irregular hand-built table); callers then gather instead.
    """
    nbr = np.asarray(topo.nbr)
    w = np.asarray(topo.w)
    if nbr.ndim != 2:
        return None
    n, d = nbr.shape
    import sys

    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 8 * n + 100))
    try:
        # receiver -> its (sender, slot) edges not yet placed
        adj: List[List[Tuple[int, int]]] = [
            [(int(nbr[i, k]), k) for k in range(d)] for i in range(n)
        ]
        new_nbr = np.empty_like(nbr)
        new_w = np.empty_like(w)
        for s in range(d):
            match_src = -np.ones(n, np.int64)   # sender -> the receiver it serves
            match_edge = np.zeros(n, np.int64)  # sender -> the slot of that edge

            def try_assign(i, seen):
                for src, k in adj[i]:
                    if seen[src]:
                        continue
                    seen[src] = True
                    if match_src[src] < 0 or try_assign(int(match_src[src]), seen):
                        match_src[src] = i
                        match_edge[src] = k
                        return True
                return False

            for i in range(n):
                if not try_assign(i, np.zeros(n, bool)):
                    return None
            for src in range(n):
                i, k = int(match_src[src]), int(match_edge[src])
                new_nbr[i, s] = src
                new_w[i, s] = w[i, k]
                adj[i].remove((src, k))
        return SparseTopology(new_nbr, new_w, np.asarray(topo.w_self).copy())
    finally:
        sys.setrecursionlimit(limit)


def build_permute_schedule(nbr_perm: np.ndarray, ndev: int):
    """Per-slot rotation-grouped send and receive index tables for
    block-sharded permutation gossip.

    nbr_perm: (N, S) rebalanced table (every column a permutation, see
    :func:`decompose_slot_permutations`), N nodes block-sharded over
    ``ndev`` ranks of B = N/ndev rows.  Applying column s means rank e
    receives, from each rank d, the rows x[src] with src on d and the
    receiver on e; grouped by the rotation r = (e - d) mod ndev, each group
    is one exchange d -> (d + r) % ndev.

    Returns a list over slots of ``{r: (send_idx, recv_pos)}``: send_idx[d]
    the local rows rank d sends under rotation r (padded with 0),
    recv_pos[e] the local receiver rows on rank e (padded with B, out of
    range).  Only rotations that carry rows appear.  Bitwise the JAX
    package's tables.
    """
    n, s_slots = nbr_perm.shape
    if n % ndev:
        raise ValueError("node count must divide evenly across devices")
    b = n // ndev
    out = []
    for s in range(s_slots):
        src = nbr_perm[:, s].astype(np.int64)
        dst = np.arange(n, dtype=np.int64)
        rot = ((dst // b) - (src // b)) % ndev
        sched = {}
        for r in np.unique(rot):
            counts = []
            pairs = []
            for d in range(ndev):
                sel = (rot == r) & (src // b == d)
                i_sel = dst[sel]  # ascending: both sides enumerate this order
                pairs.append((src[sel] % b, i_sel % b))
                counts.append(i_sel.size)
            k = max(counts)
            if k == 0:
                continue
            send_idx = np.zeros((ndev, k), np.int32)
            recv_pos = np.full((ndev, k), b, np.int32)  # b: out of range
            for d, (s_loc, d_loc) in enumerate(pairs):
                send_idx[d, : s_loc.size] = s_loc
                e = (d + int(r)) % ndev
                recv_pos[e, : d_loc.size] = d_loc
            sched[int(r)] = (send_idx, recv_pos)
        out.append(sched)
    return out


def gather_rows(topo: SparseTopology, rows) -> SparseTopology:
    """Cohort view of a topology on the device: the (C, D) ``nbr``/``w``
    and (C,) ``w_self`` rows of the global ids ``rows``.  ``nbr`` keeps
    global ids, which the cohort path resolves against the population."""
    return SparseTopology(topo.nbr[rows], topo.w[rows], topo.w_self[rows])


def sample_neighbor_slots(key, topo: SparseTopology, rows=None):
    """(N,) int64: one uniformly drawn valid neighbour slot per row (valid
    slots have w > 0), bitwise the JAX package's draw: row i's uniform is
    ``prng.uniform(fold_in(key, ids[i]), ())`` with ``ids`` the global ids
    (``rows``, default arange), its target rank ``floor(u * max(deg, 1))``
    among the valid slots.  A row without a valid slot gets slot 0, whose
    padded entry is the node itself."""
    valid = topo.w > 0
    deg = valid.sum(1)
    ids = (torch.arange(valid.shape[0], device=valid.device) if rows is None
           else rows.to(torch.int64))
    u = prng.uniform(prng.fold_in(key, ids.reshape(-1, 1)), ())
    t = torch.floor(u * torch.clamp_min(deg, 1).to(torch.float32)).to(torch.int64)
    pos = torch.cumsum(valid, 1) - 1
    hit = valid & (pos == t[:, None])
    # the first slot holding the target rank (slot 0 where none does)
    return torch.where(hit.any(1), hit.to(torch.int8).argmax(1), 0)


@dataclasses.dataclass
class PeerSampler:
    """Centralized peer sampler (paper §3.2): a new random d-regular
    topology every round, from the seed chain ``seed * 100003 + round``
    (numpy-seeded, so bitwise the JAX package's tables)."""

    n: int
    degree: int
    seed: int = 0

    def _round_seed(self, round_idx: int) -> int:
        return self.seed * 100003 + round_idx

    def round_graph(self, round_idx: int) -> Graph:
        return Graph.random_regular(self.n, self.degree, self._round_seed(round_idx))

    def round_weights(self, round_idx: int) -> np.ndarray:
        return self.round_graph(round_idx).metropolis_hastings()

    def weights_stack(self, start: int, n_rounds: int) -> np.ndarray:
        """(R, N, N) float32 stack of the mixing matrices of rounds
        [start, start + n_rounds): the ``mixing="dense"`` form, O(R·N²)."""
        return np.stack(
            [self.round_weights(start + r) for r in range(n_rounds)]
        ).astype(np.float32)

    def round_table(self, round_idx: int) -> SparseTopology:
        """One round's (N, D) tables, the graph of :meth:`round_graph`
        built without the (N, N) adjacency.  On a d-regular graph every
        Metropolis-Hastings weight is 1/(d+1)."""
        nbr = random_regular_neighbors(self.n, self.degree, self._round_seed(round_idx))
        w = np.full(nbr.shape, 1.0 / (self.degree + 1.0), np.float32)
        w_self = np.full((self.n,), 1.0 / (self.degree + 1.0), np.float32)
        return SparseTopology(nbr, w, w_self)

    def sparse_stack(self, start: int, n_rounds: int) -> SparseTopology:
        """(R, N, D) stack of the tables of rounds [start, start + n_rounds):
        O(R·N·d) to stage."""
        ts = [self.round_table(start + r) for r in range(n_rounds)]
        return SparseTopology(
            np.stack([t.nbr for t in ts]),
            np.stack([t.w for t in ts]),
            np.stack([t.w_self for t in ts]),
        )
