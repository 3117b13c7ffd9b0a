"""Port parity: overlay graphs, neighbor tables and Metropolis-Hastings
weights are bitwise the JAX package's, and so are the graph's queries,
run-time edits, files and spectral gap; the link-time formula, the links
and the experiment time agree."""
import dataclasses
import json

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core import mixing as jmix
from repro.core import network as jnet
from repro.core import topology as jtop
from repro_torch.core import mixing as tmix
from repro_torch.core import network as tnet
from repro_torch.core import topology as ttop


def _graphs(mod, n=12):
    return {
        "ring": mod.Graph.ring(n),
        "regular": mod.Graph.regular_circulant(n, 5),
        "random-regular": mod.Graph.random_regular(n, 4, 3),
        "fully": mod.Graph.fully_connected(n),
        "star": mod.Graph.star(n),
    }


@pytest.mark.parametrize("kind", ["ring", "regular", "random-regular", "fully", "star"])
def test_graphs_and_tables_bitwise(kind):
    a, b = _graphs(jtop)[kind], _graphs(ttop)[kind]
    np.testing.assert_array_equal(a.adj, b.adj)
    np.testing.assert_array_equal(a.metropolis_hastings(), b.metropolis_hastings())
    for x, y in zip(a.neighbor_table(), b.neighbor_table()):
        np.testing.assert_array_equal(x, y)
    sa, sb = jtop.SparseTopology.from_graph(a), ttop.SparseTopology.from_graph(b)
    for f in ("nbr", "w", "w_self"):
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
    np.testing.assert_array_equal(sa.to_dense(), sb.to_dense())
    assert sa.stage_bytes() == sb.stage_bytes()


def test_edge_list_file_bitwise(tmp_path):
    path = tmp_path / "g.txt"
    path.write_text("# edges\n0 1\n1 2\n2 3\n3 0\n0 2\n")
    np.testing.assert_array_equal(
        jtop.Graph.from_edge_list(str(path), 5).adj,
        ttop.Graph.from_edge_list(str(path), 5).adj,
    )


@pytest.mark.parametrize("n,d", [(16, 5), (10, 2), (64, 4), (1024, 5)])
def test_circulant_tables_bitwise(n, d):
    assert jtop.circulant_offsets(n, d) == ttop.circulant_offsets(n, d)
    np.testing.assert_array_equal(
        jtop.circulant_neighbor_table(n, d), ttop.circulant_neighbor_table(n, d)
    )
    sa = jtop.SparseTopology.regular_circulant(n, d)
    sb = ttop.SparseTopology.regular_circulant(n, d)
    for f in ("nbr", "w", "w_self"):
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))


@pytest.mark.parametrize("n,d,seed", [(20, 3, 0), (64, 5, 11), (6, 5, 2)])
def test_random_regular_bitwise(n, d, seed):
    np.testing.assert_array_equal(
        jtop.random_regular_neighbors(n, d, seed), ttop.random_regular_neighbors(n, d, seed)
    )


def test_mh_weight_table_from_neighbors_bitwise():
    g = jtop.Graph.star(7)
    nbr, valid = jtop.neighbor_table(g.adj)
    for x, y in zip(jtop.mh_weight_table(nbr, valid), ttop.mh_weight_table(nbr, valid)):
        np.testing.assert_array_equal(x, y)
    sa = jtop.SparseTopology.from_neighbors(nbr, valid)
    sb = ttop.SparseTopology.from_neighbors(nbr, valid)
    np.testing.assert_array_equal(sa.w, sb.w)


def test_merge_tables_and_device_copy():
    st = ttop.SparseTopology.regular_circulant(8, 4).to("cpu")
    rows, ws = st.merge_tables()
    assert rows.dtype == torch.int32 and ws.dtype == torch.float32
    np.testing.assert_array_equal(rows[:, 0].numpy(), np.arange(8))
    np.testing.assert_array_equal(rows[:, 1:].numpy(), st.nbr.numpy())
    np.testing.assert_array_equal(ws[:, 0].numpy(), st.w_self.numpy())
    assert st.merge_tables()[0] is rows  # built once


@pytest.mark.parametrize("net", ["paper_testbed", "wan_deployment"])
@pytest.mark.parametrize("parallel", [False, True])
def test_network_round_times_match(net, parallel):
    n = 12
    a, b = getattr(jnet, net)(n), getattr(tnet, net)(n)
    for x, y in zip(a.matrices(), b.matrices()):
        np.testing.assert_array_equal(x, y)
    ct = jnet.straggler_compute_times(n, 0.5, 4.0, 0.25, seed=3)
    np.testing.assert_array_equal(ct, tnet.straggler_compute_times(n, 0.5, 4.0, 0.25, seed=3))
    ga, gb = jtop.Graph.regular_circulant(n, 4), ttop.Graph.regular_circulant(n, 4)
    ta = a.round_time(ga, 1e6, ct, parallel)
    tb = b.round_time(gb, 1e6, ct, parallel)
    assert ta == tb
    np.testing.assert_array_equal(a.node_times(ga, 1e6, ct, parallel),
                                  b.node_times(gb, 1e6, ct, parallel))
    # the tensor form of the shared formula (the engine's, fp32 on device)
    lat, gp = (torch.as_tensor(m) for m in b.matrices())
    A = torch.as_tensor(gb.adj.astype(np.float32))
    tt = tnet.node_round_times(A, lat, gp, torch.tensor(1e6), torch.as_tensor(ct), parallel)
    np.testing.assert_allclose(tt.numpy(), b.node_times(gb, 1e6, ct, parallel), rtol=1e-6)


def test_linkspec_rejects_full_drop():
    with pytest.raises(ValueError):
        tnet.LinkSpec(1e9, 1e-3, drop_rate=1.0)
    assert tnet.LAN.transfer_time(1e6) == jnet.LAN.transfer_time(1e6)


@pytest.mark.parametrize("n,d,seed", [(8, 5, 0), (16, 4, 3), (33, 2, 7), (64, 5, 1)])
def test_peer_sampler_tables_and_stacks_bitwise(n, d, seed):
    """The dynamic overlay's per-round graphs, weights, tables and stacks
    are the JAX package's, bit for bit (numpy-seeded)."""
    a, b = jtop.PeerSampler(n, d, seed), ttop.PeerSampler(n, d, seed)
    for r in (0, 1, 5):
        np.testing.assert_array_equal(a.round_graph(r).adj, b.round_graph(r).adj)
        np.testing.assert_array_equal(a.round_weights(r), b.round_weights(r))
        ta, tb = a.round_table(r), b.round_table(r)
        for f in ("nbr", "w", "w_self"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
    np.testing.assert_array_equal(a.weights_stack(2, 3), b.weights_stack(2, 3))
    sa, sb = a.sparse_stack(2, 3), b.sparse_stack(2, 3)
    for f in ("nbr", "w", "w_self"):
        np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
    assert sa.stage_bytes() == sb.stage_bytes()
    assert not np.array_equal(sb.nbr[0], sb.nbr[1])


def test_staged_rounds_are_fresh_views_with_the_rounds_merge_tables():
    """Each staged round is its own object whose merge tables (both forms)
    are the ones ``merge_tables`` builds from that round's tables: no round
    reuses another round's cache."""
    stack = ttop.PeerSampler(12, 3, 5).sparse_stack(0, 4)
    views = ttop.stage_rounds(stack, "cpu")
    assert len({id(v) for v in views}) == 4
    for r, v in enumerate(views):
        fresh = ttop.SparseTopology(stack.nbr[r], stack.w[r], stack.w_self[r]).to("cpu")
        for inc in (True, False):
            for got, want in zip(v.merge_tables(inc), fresh.merge_tables(inc)):
                assert got.is_contiguous()
                np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(v.nbr.numpy(), stack.nbr[r])
    assert not torch.equal(views[0].merge_tables()[0], views[1].merge_tables()[0])
    bad = ttop.SparseTopology(stack.nbr + 12, stack.w, stack.w_self)
    with pytest.raises(ValueError, match="out of range"):
        ttop.stage_rounds(bad, "cpu")


@pytest.mark.parametrize("kind", ["ring", "regular", "random-regular", "fully", "star"])
def test_graph_queries_and_weights_bitwise(kind):
    a, b = _graphs(jtop)[kind], _graphs(ttop)[kind]
    for i in range(a.n):
        np.testing.assert_array_equal(a.neighbors(i), b.neighbors(i))
    assert a.is_connected() is b.is_connected() is True
    np.testing.assert_array_equal(a.uniform_weights(), b.uniform_weights())
    assert abs(a.spectral_gap() - b.spectral_gap()) <= 1e-12


def test_graph_is_connected_on_a_split_graph():
    for mod in (jtop, ttop):
        g = mod.Graph.ring(8)
        g.remove_edge(0, 1)
        assert g.is_connected()
        g.remove_edge(4, 5)
        assert not g.is_connected()


def test_graph_mutation_bitwise():
    """The graph changed at run time: the same edits give the same
    adjacency, weights and tables in both packages."""
    a, b = jtop.Graph.ring(10), ttop.Graph.ring(10)
    for g in (a, b):
        g.add_edge(0, 5)
        g.add_edge(3, 3)  # a self loop is no edge
        g.add_edge(2, 7)
        g.remove_edge(0, 1)
        g.remove_edge(4, 8)  # absent: a no-op
    np.testing.assert_array_equal(a.adj, b.adj)
    assert not b.adj[3, 3] and b.adj[5, 0] and not b.adj[1, 0]
    np.testing.assert_array_equal(a.metropolis_hastings(), b.metropolis_hastings())
    for x, y in zip(a.neighbor_table(), b.neighbor_table()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["ring", "random-regular", "star"])
def test_graph_files_byte_for_byte(kind, tmp_path):
    a, b = _graphs(jtop)[kind], _graphs(ttop)[kind]
    pa, pb = tmp_path / "a.edges", tmp_path / "b.edges"
    a.to_edge_list(str(pa))
    b.to_edge_list(str(pb))
    assert pa.read_bytes() == pb.read_bytes()
    np.testing.assert_array_equal(ttop.Graph.from_edge_list(str(pb), b.n).adj, b.adj)
    # adjacency-list JSON, as the reference's test writes it
    d = {str(i): [int(j) for j in a.neighbors(i)] for i in range(a.n)}
    pj = tmp_path / "g.json"
    pj.write_text(json.dumps(d))
    ga, gb = jtop.Graph.from_adjacency_json(str(pj)), ttop.Graph.from_adjacency_json(str(pj))
    np.testing.assert_array_equal(ga.adj, gb.adj)
    np.testing.assert_array_equal(gb.adj, b.adj)


def test_spectral_gap_ordering():
    gaps = [ttop.Graph.ring(32).spectral_gap(), ttop.Graph.regular_circulant(32, 5).spectral_gap(),
            ttop.Graph.fully_connected(32).spectral_gap()]
    assert gaps[0] < gaps[1] < gaps[2] + 1e-12


@pytest.mark.parametrize("net", ["paper_testbed", "wan_deployment"])
def test_links_and_experiment_time_match(net):
    n = 12
    a, b = getattr(jnet, net)(n), getattr(tnet, net)(n)
    for i in range(n):
        for j in range(n):
            assert a.mapping.same_machine(i, j) == b.mapping.same_machine(i, j)
            assert dataclasses.astuple(a.link(i, j)) == dataclasses.astuple(b.link(i, j))
    assert b.link(5, 5) is b.local and b.link(0, 1) is b.remote
    ct = jnet.straggler_compute_times(n, 0.5, 4.0, 0.25, seed=3)
    ga, gb = jtop.Graph.regular_circulant(n, 4), ttop.Graph.regular_circulant(n, 4)
    for rounds in (1, 7):
        ta = a.experiment_time(ga, 2e5, ct, rounds)
        assert ta == b.experiment_time(gb, 2e5, ct, rounds) > 0
    assert b.experiment_time(gb, 2e5, 0.01, 3) == 3 * b.round_time(gb, 2e5, 0.01)


@pytest.mark.parametrize("kind", ["ring", "regular", "fully"])
@pytest.mark.parametrize("n_params,bpp", [(1000, 4), (62006, 1)])
def test_mixing_bytes_per_node_matches(kind, n_params, bpp):
    a, b = _graphs(jtop)[kind], _graphs(ttop)[kind]
    want = jmix.mixing_bytes_per_node(a, n_params, bpp)
    assert tmix.mixing_bytes_per_node(b, n_params, bpp) == want > 0
