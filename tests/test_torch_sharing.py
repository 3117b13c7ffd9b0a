"""Port parity: the compressed sharing strategies (``core/sharing.py``
TopK and CHOCO-SGD, their top-k selection and wire codec) against the JAX
package's, one ``round`` at a time on identical numpy X, state and
topology.  The JAX side's histogram selector runs its Pallas kernels in
interpret mode.

Tolerances: selected indices equal; X' and the state within atol 1e-6
(fp32 with another summation order in the merge); bytes equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharing as jshare
from repro.core import topology as jtop
from repro_torch.core import engine as tengine
from repro_torch.core import mixing as tmix
from repro_torch.core import sharing as tshare
from repro_torch.core import topology as ttop

ATOL = 1e-6
N, P = 8, 1003


def _topo(n=N):
    g = jtop.Graph.regular_circulant(n, 5)
    js = jtop.SparseTopology.from_graph(g)
    return (jtop.SparseTopology(*(jnp.asarray(a) for a in (js.nbr, js.w, js.w_self))),
            ttop.SparseTopology.from_graph(g).to("cpu"))


def _xs(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, P)).astype(np.float32)
    other = (X + rng.normal(size=(N, P)) * 0.1).astype(np.float32)
    return X, other


@pytest.mark.parametrize("selector", ["exact", "hist"])
@pytest.mark.parametrize("k", [1, 100, 1003])
def test_topk_idx_equals_jax(selector, k):
    X, other = _xs(k)
    a = np.abs(X - other)
    a[0, 10:20] = a[0, 5]  # ties: the lower index first, as lax.top_k
    got = tshare._topk_idx(torch.tensor(a), k, selector)
    want = jshare._topk_idx(jnp.asarray(a), k, selector)
    assert got.dtype == torch.int32 and got.shape == (N, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 100, 1003])
def test_hist_rows_ascend_where_k_survivors_exist(k):
    """The histogram selector's rows are strictly ascending (the payload
    merge's sorted promise) wherever k coordinates reach the threshold."""
    X, other = _xs(k + 1)
    idx = tshare._topk_idx(torch.tensor(np.abs(X - other)), k, "hist")
    assert bool((idx.diff(dim=1) > 0).all())


def test_short_hist_rows_pad_in_front_and_round_as_jax(monkeypatch):
    """A row with fewer than k survivors is padded with index 0 in front,
    so it stays sorted; its entries are the reference's (which pads after
    them), and a TopK round on such rows matches the JAX round.  Thresholds
    above the k-th magnitude force the short rows in both packages."""
    from repro.kernels import ops as jops

    X, last = _xs(12)
    a = np.abs(X - last)
    k = 100
    # row 0 keeps 37 coordinates, row 1 none, the others their usual k
    t = np.sort(a, axis=1)[:, ::-1][:, k - 1].copy()
    t[0] = np.sort(a[0])[::-1][36]
    t[1] = np.inf
    monkeypatch.setattr(tshare, "topk_threshold_rows", lambda x, kk: torch.tensor(t))
    monkeypatch.setattr(jops, "topk_threshold_rows", lambda x, kk: jnp.asarray(t))
    got = tshare._topk_idx(torch.tensor(a), k, "hist").numpy()
    want = np.asarray(jshare._topk_idx(jnp.asarray(a), k, "hist"))
    assert (np.diff(got, axis=1) >= 0).all()
    assert (got[0, :k - 37] == 0).all() and (got[1] == 0).all()
    np.testing.assert_array_equal(np.sort(got, axis=1), np.sort(want, axis=1))
    jW, tW = _topo()
    # the padded entries carry one value: the merge is the same bits with
    # the reference's order of entries
    Xt = torch.tensor(X)
    merged = [tmix.mix_payload(tW, torch.tensor(i), Xt.gather(1, torch.tensor(i).long()), Xt,
                               exact_values=False) for i in (got, want)]
    assert torch.equal(*merged)
    # column 0 takes up to k padded corrections per slot, summed in another
    # order by the reference: rtol 1e-6 beside the usual atol
    for quantize in (None, "int8"):
        kw = dict(budget=k / P, quantize=quantize, selector="hist")
        jX2, jst, _ = jshare.TopKSharing(**kw).round(
            jnp.asarray(X), jW, {"last_shared": jnp.asarray(last)}, None, 5.0)
        tX2, tst, _ = tshare.TopKSharing(**kw).round(
            torch.tensor(X), tW, {"last_shared": torch.tensor(last)}, degree=5.0)
        np.testing.assert_allclose(tX2.numpy(), np.asarray(jX2), rtol=1e-6, atol=ATOL)
        np.testing.assert_allclose(tst["last_shared"].numpy(), np.asarray(jst["last_shared"]),
                                   rtol=0, atol=ATOL)


def test_auto_selector_is_exact_on_the_cpu():
    a = np.abs(_xs(3)[0])
    torch.testing.assert_close(tshare._topk_idx(torch.tensor(a), 50, "auto"),
                               tshare._topk_idx(torch.tensor(a), 50, "exact"))
    with pytest.raises(ValueError, match="unknown selector"):
        tshare._topk_idx(torch.tensor(a), 5, "nope")


@pytest.mark.parametrize("selector", ["exact", "hist"])
@pytest.mark.parametrize("payload", [True, False])
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_topk_round_matches_jax(selector, payload, quantize):
    jW, tW = _topo()
    X, last = _xs(4 * (selector == "hist") + 2 * payload + (quantize is not None))
    kw = dict(budget=0.1, payload=payload, quantize=quantize, selector=selector)
    jX2, jst, jb = jshare.TopKSharing(**kw).round(
        jnp.asarray(X), jW, {"last_shared": jnp.asarray(last)}, None, 5.0)
    # torch.tensor copies: the port updates its state in place
    tX2, tst, tb = tshare.TopKSharing(**kw).round(
        torch.tensor(X), tW, {"last_shared": torch.tensor(last)}, degree=5.0)
    np.testing.assert_allclose(tX2.numpy(), np.asarray(jX2), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tst["last_shared"].numpy(), np.asarray(jst["last_shared"]),
                               rtol=0, atol=ATOL)
    assert tb == float(jb) == 5.0 * 100 * (4 + (1 if quantize else 4)) + 5.0 * (4 if quantize else 0)


@pytest.mark.parametrize("selector", ["exact", "hist"])
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_choco_round_matches_jax(selector, quantize):
    jW, tW = _topo()
    X, xhat = _xs(7)
    kw = dict(budget=0.1, selector=selector, quantize=quantize, gamma=0.3)
    jX2, jst, jb = jshare.ChocoSGD(**kw).round(jnp.asarray(X), jW, {"xhat": jnp.asarray(xhat)},
                                               None, 5.0)
    tX2, tst, tb = tshare.ChocoSGD(**kw).round(torch.tensor(X), tW, {"xhat": torch.tensor(xhat)},
                                               degree=5.0)
    np.testing.assert_allclose(tX2.numpy(), np.asarray(jX2), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tst["xhat"].numpy(), np.asarray(jst["xhat"]), rtol=0, atol=ATOL)
    assert tb == float(jb)


def test_rounds_on_a_dense_W_match_jax():
    g = jtop.Graph.fully_connected(N)
    W = g.metropolis_hastings().astype(np.float32)
    X, last = _xs(9)
    for cls, state in ((jshare.TopKSharing, "last_shared"), (jshare.ChocoSGD, "xhat")):
        tcls = getattr(tshare, cls.__name__)
        jX2, _, _ = cls(budget=0.2).round(jnp.asarray(X), jnp.asarray(W),
                                          {state: jnp.asarray(last)}, None, 7.0)
        tX2, _, _ = tcls(budget=0.2).round(torch.tensor(X), torch.tensor(W),
                                           {state: torch.tensor(last)}, degree=7.0)
        np.testing.assert_allclose(tX2.numpy(), np.asarray(jX2), rtol=0, atol=ATOL)


def test_init_state_is_a_copy():
    X = torch.randn(4, 30)
    st = tshare.TopKSharing(budget=0.1).init_state(X)
    X.add_(1.0)  # local SGD updates X in place
    assert not torch.equal(st["last_shared"], X)
    assert not tshare.ChocoSGD(budget=0.1).init_state(X)["xhat"].any()


@pytest.mark.parametrize("name,kw", [
    ("topk", {}), ("topk", dict(payload=False, quantize="int8")), ("choco", dict(gamma=0.5)),
    ("topk", dict(budget=0.25)),
])
def test_wire_metrics_match_jax(name, kw):
    j = jshare.make_sharing(name, **kw)
    t = tshare.make_sharing(name, **kw)
    assert t.wire_dtype(torch.float32) == str(np.dtype(j.wire_dtype(jnp.float32)))
    assert t.stage_bytes_per_round(1024, 579_594) == j.stage_bytes_per_round(1024, 579_594)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_sparse_aggregate_matches_jax():
    jW, tW = _topo()
    X, _ = _xs(5)
    M = (np.random.default_rng(5).uniform(size=X.shape) < 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tshare.sparse_aggregate(torch.tensor(X), tW, torch.tensor(M)).numpy(),
        np.asarray(jshare.sparse_aggregate(jnp.asarray(X), jW, jnp.asarray(M))),
        rtol=0, atol=ATOL)


@pytest.mark.parametrize("name,kw", [
    ("randomk", {}), ("random", dict(sampler="strided")), ("quant", {}), ("int8", {}),
    ("choco", dict(compressor="randk")),
])
def test_strategies_that_draw_random_numbers_are_not_ported(name, kw):
    """These strategies are ported now (their rounds are held against the
    JAX package in ``test_torch_randomk.py``): each name builds the JAX
    package's strategy with the same fields."""
    t, j = tshare.make_sharing(name, **kw), jshare.make_sharing(name, **kw)
    assert type(t).__name__ == type(j).__name__
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("name,kw", [
    ("full", dict(budget=0.1)), ("quant", dict(budget=0.1)), ("full", dict(payload=True)),
    ("topk", dict(nope=1)), ("nope", {}),
])
def test_invalid_kwargs_raise_as_in_jax(name, kw):
    with pytest.raises(ValueError):
        jshare.make_sharing(name, **kw)
    with pytest.raises(ValueError):
        tshare.make_sharing(name, **kw)


@pytest.mark.parametrize("over", [
    dict(sharing="topk"), dict(sharing="topk", payload="off", payload_quant=True),
    dict(sharing="choco", choco_gamma=0.5, payload_quant=True), dict(sharing="TopK", budget=0.3),
])
def test_engine_builds_the_jax_engines_strategy(over):
    from repro.core import DLConfig as JDLConfig

    dl = tengine.DLConfig(**over).validate()
    JDLConfig(**over).validate()
    t = tengine.make_strategy(dl)
    kw = {"gamma": dl.choco_gamma} if dl.sharing.startswith("choco") else {}
    kw.update(budget=dl.budget, payload=dl.payload != "off")
    if dl.payload_quant:
        kw["quantize"] = "int8"
    j = jshare.make_sharing(dl.sharing, **kw)
    assert type(t).__name__ == type(j).__name__
    assert dataclasses.asdict(t) == dataclasses.asdict(j)

