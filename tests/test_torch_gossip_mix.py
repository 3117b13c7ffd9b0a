"""Port parity: the fused gather-merge gossip kernel module and the mixing
layer above it, against the JAX package's Pallas kernels (run in
interpret mode, as the JAX package's own tests run them on the CPU) and
its ``apply_W`` / ``mix_sparse`` / ``mix_dense``.

On the CPU every wrapper computes with the kernel's plain twin; the
kernel itself is held against the twin on the card by the ``gpu``-marked
tests of ``test_torch_kernels_gpu.py``.  Tolerances: fp32 1e-5 and bf16 1e-2, as the JAX package's kernel
tests; the summation order differs (the twin adds the self slot first).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmix
from repro.core import sharing as jshare
from repro.core import topology as jtop
from repro.kernels import ops as jops
from repro_torch.core import engine as tengine
from repro_torch.core import mixing as tmix
from repro_torch.core import sharing as tshare
from repro_torch.core import topology as ttop
from repro_torch.kernels import gossip_mix as gm

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(shape, k_shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.uniform(size=k_shape).astype(np.float32))


@pytest.mark.parametrize("B,K,M", [(4, 3, 100), (16, 7, 1000), (2, 2, 65536 + 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gossip_mix_nodes_twin_matches_pallas(B, K, M, dtype):
    x, w = _inputs((B, K, M), (B, K), B * M)
    want = jops.gossip_mix_nodes(jnp.asarray(x).astype(dtype), jnp.asarray(w))
    got = gm.gossip_mix_nodes(torch.as_tensor(x).to(getattr(torch, dtype)), torch.as_tensor(w))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, M)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("K,M", [(3, 100), (6, 70001)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gossip_mix_twin_matches_pallas(K, M, dtype):
    x, w = _inputs((K, M), (K,), K + M)
    want = jops.gossip_mix(jnp.asarray(x).astype(dtype), jnp.asarray(w))
    got = gm.gossip_mix(torch.as_tensor(x).to(getattr(torch, dtype)), torch.as_tensor(w))
    assert got.shape == (M,)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _topologies(n=16):
    return {
        "regular": jtop.Graph.regular_circulant(n, 5),
        "ring": jtop.Graph.ring(n),
        "star": jtop.Graph.star(n),  # ragged rows: padded slots of weight 0
    }


@pytest.mark.parametrize("kind", ["regular", "ring", "star"])
@pytest.mark.parametrize("P", [37, 1030])
def test_apply_W_matches_jax(kind, P):
    g = _topologies()[kind]
    js = jtop.SparseTopology.from_graph(g)
    ts = ttop.SparseTopology.from_graph(g).to("cpu")
    x, _ = _inputs((g.n, P), (1,), P)
    want = np.asarray(jmix.apply_W(jtop.SparseTopology(*(jnp.asarray(a) for a in
                                                         (js.nbr, js.w, js.w_self))),
                                   jnp.asarray(x)))
    got = tmix.apply_W(ts, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the dense form: torch.matmul against the JAX einsum
    W = g.metropolis_hastings().astype(np.float32)
    want_d = np.asarray(jmix.apply_W(jnp.asarray(W), jnp.asarray(x)))
    np.testing.assert_allclose(tmix.apply_W(torch.as_tensor(W), torch.as_tensor(x)).numpy(),
                               want_d, rtol=1e-5, atol=1e-5)


def test_mix_sparse_and_dense_trees_match_jax():
    g = jtop.Graph.regular_circulant(12, 4)
    js = jtop.SparseTopology.from_graph(g)
    jst = jtop.SparseTopology(jnp.asarray(js.nbr), jnp.asarray(js.w), jnp.asarray(js.w_self))
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(12, 3, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(12, 7)).astype(np.float32)}}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = {"a": torch.as_tensor(tree["a"]), "b": {"c": torch.as_tensor(tree["b"]["c"])}}
    want_s = jmix.mix_sparse(jtree, jst, use_pallas=True, interpret=True)
    got_s = tmix.mix_sparse(ttree, ttop.SparseTopology.from_graph(g).to("cpu"))
    W = g.metropolis_hastings().astype(np.float32)
    want_d = jmix.mix_dense(jtree, jnp.asarray(W))
    got_d = tmix.mix_dense(ttree, torch.as_tensor(W))
    for want, got in ((want_s, got_s), (want_d, got_d)):
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]),
                                   rtol=1e-5, atol=1e-5)
        assert got["a"].shape == (12, 3, 5)


def test_full_sharing_round_matches_jax():
    g = jtop.Graph.regular_circulant(8, 5)
    js = jtop.SparseTopology.from_graph(g)
    jst = jtop.SparseTopology(jnp.asarray(js.nbr), jnp.asarray(js.w), jnp.asarray(js.w_self))
    x, _ = _inputs((8, 301), (1,), 9)
    jX2, _, jb = jshare.make_sharing("full").round(jnp.asarray(x), jst, (), None, degree=5.0)
    sh = tshare.make_sharing("full")
    tX2, _, tb = sh.round(torch.as_tensor(x), ttop.SparseTopology.from_graph(g).to("cpu"), (),
                          degree=5.0)
    np.testing.assert_allclose(tX2.numpy(), np.asarray(jX2), rtol=1e-5, atol=1e-5)
    assert float(jb) == tb == 5.0 * 301 * 4
    assert sh.wire_dtype(torch.float32) == str(np.dtype(jshare.FullSharing().wire_dtype(jnp.float32)))
    assert sh.stage_bytes_per_round(8, 301) == jshare.FullSharing().stage_bytes_per_round(8, 301)
    for name in ("full", "randomk", "topk", "quant", "nope"):
        assert tshare.strategy_takes_budget(name) == jshare.strategy_takes_budget(name)
        assert tshare.is_full_sharing(name) == jshare.is_full_sharing(name)
    assert type(tshare.make_sharing("randomk")).__name__ == "RandomKSharing"
    with pytest.raises(ValueError):
        tshare.make_sharing("nope")


def test_nan_row_propagates_through_zero_weight_slot():
    X = torch.ones((3, 8))
    X[2] = float("nan")
    rows = torch.tensor([[0, 2], [1, 0], [2, 1]], dtype=torch.int32)
    w = torch.tensor([[1.0, 0.0], [0.5, 0.5], [0.5, 0.5]])
    out = gm.gossip_mix_rows(X, rows, w)
    assert torch.isnan(out[0]).all() and torch.isnan(out[2]).all()
    assert torch.equal(out[1], torch.ones(8))


def test_cpu_tensor_takes_the_twin_and_leaves_the_counter():
    before = gm.gossip_mix_rows.launches
    x, w = _inputs((5, 4, 33), (5, 4), 1)
    got = gm.gossip_mix_nodes(torch.as_tensor(x), torch.as_tensor(w))
    st = ttop.SparseTopology.regular_circulant(6, 2).to("cpu")
    X = torch.as_tensor(_inputs((6, 10), (1,), 2)[0])
    mixed = gm.mix_rows(X, st.nbr, st.w, st.w_self)
    out = torch.empty((6, 10))
    res = gm.gossip_mix_rows(X, *st.merge_tables(), out=out)
    assert gm.gossip_mix_rows.launches == before
    assert res is out and torch.equal(out, mixed)
    ref = gm.gossip_mix_rows_ref(torch.as_tensor(x).reshape(20, 33),
                                 torch.arange(20, dtype=torch.int32).view(5, 4),
                                 torch.as_tensor(w))
    assert torch.equal(got, ref)


def _padded(n, p, dtype, per):
    """(n, p) view with the row stride rounded up to ``per`` elements."""
    return torch.empty((n, -(-p // per) * per), dtype=dtype)[:, :p]


def test_vector_width_and_aligned_rows():
    X = _padded(4, 579_594, torch.float32, 4)
    assert X.stride(0) % 4 == 0 and X.data_ptr() % 16 == 0
    assert gm._vec_width(X, X) == 4  # the kernel masks the 2-column tail
    Xc = torch.empty((4, 579_594))
    assert gm._vec_width(Xc, Xc) == 2  # rows of odd n start 8 bytes off
    Xb = torch.empty((4, 1_000_003), dtype=torch.bfloat16)
    assert gm._vec_width(Xb, Xb) == 1
    Xb8 = _padded(4, 1_000_003, torch.bfloat16, 8)
    assert Xb8.stride(0) % 8 == 0 and gm._vec_width(Xb8[:, :1_000_000], Xb8[:, :1_000_000]) == 8


def test_merge_tables_reject_out_of_range_ids():
    with pytest.raises(ValueError, match="out of range"):
        gm.merge_tables(torch.tensor([[1], [2]], dtype=torch.int32),
                        torch.ones((2, 1)), torch.zeros(2))


def test_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.RoundEngine(tengine.DLConfig(n_nodes=4, degree=2), None, None, None,
                            None, None)
    assert tengine.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("N", [1, 3])
@pytest.mark.parametrize("K", [1, 6, 9])
def test_identity_rows_equal_explicit_arange_rows(N, K):
    """rows None (what gossip_mix and gossip_mix_nodes pass: no index
    tensor) means rows n*K + k: bitwise the explicit arange table, and the
    stacked form agrees with the JAX package's Pallas kernel."""
    x, w = _inputs((N * K, 333), (N, K), N * 10 + K)
    X, W = torch.as_tensor(x), torch.as_tensor(w)
    arange = torch.arange(N * K, dtype=torch.int32).view(N, K)
    got = gm.gossip_mix_rows(X, None, W)
    assert torch.equal(got, gm.gossip_mix_rows(X, arange, W))
    assert torch.equal(gm.gossip_mix_nodes(X.view(N, K, 333), W), got)
    want = jops.gossip_mix_nodes(jnp.asarray(x).reshape(N, K, 333), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
