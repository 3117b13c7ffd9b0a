"""Port parity of the node-sharding tables against the JAX package on the
CPU: ``decompose_slot_permutations`` and ``build_permute_schedule``
bitwise on regular, ring, random-regular and star graphs, the
non-decomposable table (None in both), the host round trip of the
rotation-grouped transfers (``tests/test_sharded_engine.py``'s), and each
rank's exchange plan (``mixing.PermuteSchedule.plan``), emulated on the
host: the rows it sends and receives rebuild every slot's permutation,
and only the rows that cross ranks move.  No process is spawned here.
"""
import numpy as np
import pytest

from repro.core.topology import Graph as JGraph
from repro.core.topology import SparseTopology as JSparse
from repro.core.topology import build_permute_schedule as jschedule
from repro.core.topology import decompose_slot_permutations as jdecompose
from repro_torch.core.mixing import PermuteSchedule
from repro_torch.core.topology import Graph, SparseTopology, build_permute_schedule
from repro_torch.core.topology import decompose_slot_permutations

GRAPHS = {
    "ring12": lambda G: G.ring(12),
    "circ16d4": lambda G: G.regular_circulant(16, 4),
    "circ16d5": lambda G: G.regular_circulant(16, 5),
    "circ1024d5": lambda G: G.regular_circulant(1024, 5),
    "rr64d6": lambda G: G.random_regular(64, 6, seed=3),
    "rr32d5": lambda G: G.random_regular(32, 5, seed=7),
    "star8": lambda G: G.star(8),
}


def _pair(name):
    return (SparseTopology.from_graph(GRAPHS[name](Graph)),
            JSparse.from_graph(GRAPHS[name](JGraph)))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_decomposition_is_the_references_bitwise(name):
    st, jst = _pair(name)
    dec, jdec = decompose_slot_permutations(st), jdecompose(jst)
    assert dec is not None and jdec is not None
    for a, b in ((dec.nbr, jdec.nbr), (dec.w, jdec.w), (dec.w_self, jdec.w_self)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    n = st.n
    for s in range(dec.nbr.shape[1]):
        assert np.array_equal(np.sort(dec.nbr[:, s]), np.arange(n))
    np.testing.assert_array_equal(dec.to_dense(), st.to_dense())


def test_non_decomposable_returns_none_in_both():
    nbr = np.array([[1, 1], [0, 0], [0, 0], [0, 0]], np.int32)
    w = np.full(nbr.shape, 0.25, np.float32)
    w_self = np.full((4,), 0.5, np.float32)
    assert decompose_slot_permutations(SparseTopology(nbr, w, w_self)) is None
    assert jdecompose(JSparse(nbr, w, w_self)) is None


@pytest.mark.parametrize("name,ndev", [("ring12", 4), ("circ16d5", 4), ("circ16d5", 8),
                                       ("rr32d5", 8), ("rr64d6", 4), ("star8", 2),
                                       ("circ1024d5", 4)])
def test_schedule_is_the_references_bitwise(name, ndev):
    st, _ = _pair(name)
    nbr = decompose_slot_permutations(st).nbr
    got, want = build_permute_schedule(nbr, ndev), jschedule(nbr, ndev)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for r in w:
            for a, b in zip(g[r], w[r]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_schedule_host_roundtrip():
    """The reference's host emulation of the rotation-grouped transfers
    reproduces each slot's permutation, on the port's tables."""
    st = SparseTopology.from_graph(Graph.random_regular(32, 5, seed=7))
    dec = decompose_slot_permutations(st)
    ndev, b = 8, 4
    sched = build_permute_schedule(dec.nbr, ndev)
    x = np.random.default_rng(0).normal(size=(32, 3)).astype(np.float32)
    for s, slots in enumerate(sched):
        out = np.zeros_like(x)
        for r, (send_idx, recv_pos) in slots.items():
            for d in range(ndev):
                e = (d + r) % ndev
                payload = x[d * b:(d + 1) * b][send_idx[d]]
                for j, p in enumerate(recv_pos[e]):
                    if p < b:
                        out[e * b + p] = payload[j]
        np.testing.assert_array_equal(out, x[dec.nbr[:, s]])


def test_uneven_schedule_raises():
    with pytest.raises(ValueError, match="divide evenly"):
        build_permute_schedule(np.zeros((6, 2), np.int32), 4)


@pytest.mark.parametrize("name,ndev", [("circ16d5", 4), ("rr32d5", 8), ("rr64d6", 4),
                                       ("star8", 4), ("circ1024d5", 4)])
def test_rank_plans_rebuild_every_slot(name, ndev):
    """Every rank's plan, its transfers carried out on the host: L = [own
    rows; received rows] read through its table gives x[nbr[:, s]] for
    each slot; each message is real rows only (the padded lanes stay home),
    sends and receives pair up by peer and tag, and the rows moved are
    the rows whose sender sits on another rank."""
    st, _ = _pair(name)
    dec = decompose_slot_permutations(st)
    n, d = dec.nbr.shape
    b = n // ndev
    sched = PermuteSchedule.from_table(dec.nbr, ndev)
    plans = [sched.plan(r, b) for r in range(ndev)]
    x = np.random.default_rng(1).normal(size=(n, 5)).astype(np.float32)
    inbox = {}
    for r, p in enumerate(plans):
        send = x[r * b:(r + 1) * b][p.send_rows]
        for peer, lo, hi, tag in p.sends:
            inbox[(r, peer, tag)] = send[lo:hi]
    for r, p in enumerate(plans):
        L = np.concatenate([x[r * b:(r + 1) * b], np.zeros((p.n_recv, 5), np.float32)])
        for peer, lo, hi, tag in p.recvs:
            L[b + lo:b + hi] = inbox.pop((peer, r, tag))
        for s in range(d):
            np.testing.assert_array_equal(L[p.table[:, s]], x[dec.nbr[r * b:(r + 1) * b, s]])
    assert not inbox  # every message was received
    crossing = int(sum(((dec.nbr[:, s] // b) != (np.arange(n) // b)).sum() for s in range(d)))
    assert sum(len(p.send_rows) for p in plans) == crossing
    assert plans[0] is sched.plan(0, b)  # derived once
