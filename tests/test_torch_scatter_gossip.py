"""Port parity: the payload-merge kernel module (``kernels/scatter_gossip.py``)
and the payload aggregation of the mixing layer above it, against the JAX
package's Pallas kernel (in interpret mode, as the JAX package's own
tests run it on the CPU), its ``kernels/ref.py`` oracle and
``core/mixing.py`` ``mix_payload`` / ``mix_payload_masked``.

Tolerance: atol 1e-6 (fp32; the port adds the slots in order into a copy
of X, the reference sums the corrections first and then adds X).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmix
from repro.core import topology as jtop
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import mixing as tmix
from repro_torch.core import topology as ttop
from repro_torch.kernels import scatter_gossip as sg

ATOL = 1e-6


def _stack(N, P, K, k, seed, distinct=True):
    """x (N, P), idx (N, K, k) int32 (distinct within each slot when asked;
    duplicates across slots either way), val (N, K, k), w (N, K)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, P)).astype(np.float32)
    if distinct:
        idx = np.stack([np.stack([rng.choice(P, k, replace=False) for _ in range(K)])
                        for _ in range(N)]).astype(np.int32)
    else:
        idx = rng.integers(0, P, size=(N, K, k)).astype(np.int32)
    val = rng.normal(size=(N, K, k)).astype(np.float32)
    w = rng.uniform(size=(N, K)).astype(np.float32)
    return x, idx, val, w


@pytest.mark.parametrize("N,P,K,k,distinct", [
    (4, 100, 3, 5, True), (8, 1000, 7, 11, True), (2, 65536 + 3, 2, 4, True),
    (4, 50, 6, 20, False),  # duplicates within slots too
])
def test_payload_mix_nodes_matches_pallas_and_ref(N, P, K, k, distinct):
    x, idx, val, w = _stack(N, P, K, k, N * P + K, distinct)
    got = sg.payload_mix_nodes(torch.tensor(x), torch.tensor(idx), torch.tensor(val),
                               torch.tensor(w))
    assert got.dtype == torch.float32 and got.shape == (N, P)
    args = tuple(jnp.asarray(a) for a in (x, idx, val, w))
    for want in (jref.payload_mix_nodes_ref(*args), jops.payload_mix_nodes(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("N,P,K,k,distinct", [
    (4, 100, 3, 5, True), (8, 1000, 7, 11, True), (2, 65536 + 3, 2, 4, True),
    (4, 50, 6, 20, False),
])
def test_sorting_the_payload_rows_leaves_the_twin_unchanged(N, P, K, k, distinct):
    """The wrapper's sort step (each (idx, val) row by index, as the kernel
    takes it) changes no bit of the merge where indices are distinct within
    a row; with duplicates their adds change order (atol)."""
    x, idx, val, w = _stack(N, P, K, k, N * P + K, distinct)
    X = torch.tensor(x)
    flat_idx, flat_val = torch.tensor(idx).reshape(N * K, k), torch.tensor(val).reshape(N * K, k)
    rows = torch.arange(N * K, dtype=torch.int32).view(N, K)
    s_idx, s_val = sg.sort_payload_rows(flat_idx, flat_val)
    assert bool((s_idx.diff(dim=1) >= 0).all()) and s_idx.is_contiguous()
    got = sg.payload_mix_rows_ref(X, s_idx, s_val, rows, torch.tensor(w))
    want = sg.payload_mix_rows_ref(X, flat_idx, flat_val, rows, torch.tensor(w))
    if distinct:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("sorted_idx", [False, True])
def test_rows_form_on_shuffled_and_sorted_rows_matches_pallas(sorted_idx):
    """payload_mix_rows with the sorted promise off, on rows in random
    order, and on, on rows sorted by index, against the JAX kernel in
    interpret mode on the same payloads."""
    N, P, K, k = 6, 3000, 4, 40
    x, idx, val, w = _stack(N, P, K, k, 77)
    if sorted_idx:
        order = np.argsort(idx, axis=2)
        idx, val = np.take_along_axis(idx, order, 2), np.take_along_axis(val, order, 2)
    rows = torch.arange(N * K, dtype=torch.int32).view(N, K)
    got = sg.payload_mix_rows(torch.tensor(x), torch.tensor(idx).reshape(N * K, k),
                              torch.tensor(val).reshape(N * K, k), rows, torch.tensor(w),
                              sorted_idx=sorted_idx)
    want = jops.payload_mix_nodes(*(jnp.asarray(a) for a in (x, idx, val, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_duplicate_indices_across_slots_accumulate():
    out = sg.payload_mix_nodes(torch.zeros((1, 8)), torch.tensor([[[3], [3]]], dtype=torch.int32),
                               torch.tensor([[[1.0], [2.0]]]), torch.tensor([[0.5, 0.25]]))
    assert float(out[0, 3]) == 0.5 * 1.0 + 0.25 * 2.0
    assert float(out.abs().sum()) == 1.0


def test_rows_form_reads_payloads_by_index():
    """The engine form: receiver n merges the payload rows rows[n, s] of an
    (R, k) table, as the stacked form does with gathered copies."""
    rng = np.random.default_rng(4)
    R, N, P, k, S = 5, 6, 64, 9, 4
    x = torch.tensor(rng.normal(size=(N, P)).astype(np.float32))
    idx = torch.tensor(np.stack([rng.choice(P, k, replace=False) for _ in range(R)]),
                       dtype=torch.int32)
    val = torch.tensor(rng.normal(size=(R, k)).astype(np.float32))
    rows = torch.tensor(rng.integers(0, R, size=(N, S)), dtype=torch.int32)
    w = torch.tensor(rng.uniform(size=(N, S)).astype(np.float32))
    got = sg.payload_mix_rows(x, idx, val, rows, w)
    want = sg.payload_mix_nodes(x, idx[rows.long()], val[rows.long()], w)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _sparse(g):
    js = jtop.SparseTopology.from_graph(g)
    return (jtop.SparseTopology(*(jnp.asarray(a) for a in (js.nbr, js.w, js.w_self))),
            ttop.SparseTopology.from_graph(g).to("cpu"))


@pytest.mark.parametrize("kind", ["regular", "star"])
@pytest.mark.parametrize("exact_values", [True, False])
def test_mix_payload_matches_jax(kind, exact_values):
    n, P, k = 12, 301, 30
    g = jtop.Graph.regular_circulant(n, 4) if kind == "regular" else jtop.Graph.star(n)
    jW, tW = _sparse(g)
    rng = np.random.default_rng(11)
    X = rng.normal(size=(n, P)).astype(np.float32)
    idx = np.stack([rng.choice(P, k, replace=False) for _ in range(n)]).astype(np.int32)
    val = np.take_along_axis(X, idx, 1)
    if not exact_values:  # a lossy wire: values off the sender's coordinates
        val = val + rng.normal(size=val.shape).astype(np.float32) * 0.01
    jargs = (jnp.asarray(idx), jnp.asarray(val), jnp.asarray(X))
    targs = (torch.tensor(idx), torch.tensor(val), torch.tensor(X))
    got = tmix.mix_payload(tW, *targs, exact_values=exact_values)
    for want in (jmix.mix_payload(jW, *jargs, exact_values=exact_values),
                 jmix.mix_payload(jW, *jargs, exact_values=exact_values, use_pallas=True,
                                  interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # the dense-mask oracle (the payload="off" mode), on the sparse and dense W
    W = g.metropolis_hastings().astype(np.float32)
    for jw, tw in ((jW, tW), (jnp.asarray(W), torch.tensor(W))):
        np.testing.assert_allclose(tmix.mix_payload_masked(tw, *targs).numpy(),
                                   np.asarray(jmix.mix_payload_masked(jw, *jargs)),
                                   rtol=0, atol=ATOL)
    # a dense W takes the masked oracle in both packages
    np.testing.assert_allclose(
        tmix.mix_payload(torch.tensor(W), *targs, exact_values=exact_values).numpy(),
        np.asarray(jmix.mix_payload(jnp.asarray(W), *jargs, exact_values=exact_values)),
        rtol=0, atol=ATOL)
    # with exact values the self slot is skipped: the same result as with it
    if exact_values:
        torch.testing.assert_close(got, tmix.mix_payload(tW, *targs, exact_values=False),
                                   rtol=0, atol=ATOL)


def test_merge_tables_without_the_self_slot_are_cached_and_contiguous():
    st = ttop.SparseTopology.regular_circulant(10, 4).to("cpu")
    rows, w = st.merge_tables(include_self=False)
    full_rows, full_w = st.merge_tables()
    assert rows.is_contiguous() and w.is_contiguous() and rows.shape == (10, 4)
    assert torch.equal(rows, full_rows[:, 1:]) and torch.equal(w, full_w[:, 1:])
    assert st.merge_tables(include_self=False)[0] is rows


def test_cpu_tensor_takes_the_twin_and_leaves_the_counter():
    before = sg.payload_mix_rows.launches
    x, idx, val, w = _stack(3, 40, 2, 5, 1)
    sg.payload_mix_nodes(torch.tensor(x), torch.tensor(idx), torch.tensor(val), torch.tensor(w))
    assert sg.payload_mix_rows.launches == before
    from types import SimpleNamespace

    with pytest.raises(ValueError, match="unsupported device"):
        sg.payload_mix_rows(SimpleNamespace(device=torch.device("xpu")), *([None] * 4))
