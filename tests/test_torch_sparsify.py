"""Port parity: the histogram top-k threshold (``kernels/sparsify.py``)
against the JAX package's Pallas kernels (in interpret mode, as the JAX
package's own tests run them on the CPU) and its ``kernels/ref.py``
oracles.

Tolerances: counts and the edge picks bitwise, given the same edges
(passed in from numpy).  Thresholds from the whole two-pass procedure
agree with JAX's ``topk_threshold_rows`` to within one ulp of log(lo) in
relative terms, plus 8 ulp: the edges are exp(log(lo)·(1-s) + log(hi)·s),
the last bit of ``log`` and ``exp`` differs between XLA and torch, and exp
turns an absolute error of its argument into a relative error of the edge
(measured: up to 8 ulp, 5.4e-7 relative, at |log(lo)| < 16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sparsify as jsp
from repro_torch.kernels import sparsify as tsp


def _rows(n, p, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, p)).astype(np.float32) * rng.uniform(
        1e-3, 10.0, size=(n, 1)).astype(np.float32)


def _log_edges(x, nbins=128):
    a = np.abs(x)
    hi = a.max(1, keepdims=True)
    lo = np.maximum(hi * np.float32(1e-7), np.float32(1e-30))
    span = np.linspace(0.0, 1.0, nbins, dtype=np.float32)[None]
    return np.exp(np.log(lo) * (1 - span) + np.log(hi) * span).astype(np.float32)


@pytest.mark.parametrize("N,P,E", [(4, 1000, 128), (3, 65536 + 5, 48), (5, 37, 1)])
def test_histogram_rows_counts_bitwise(N, P, E):
    x = _rows(N, P, N * P)
    edges = _log_edges(x, E) if E > 1 else np.full((N, 1), 0.5, np.float32)
    got = tsp.abs_histogram_rows(torch.tensor(x), torch.tensor(edges))
    assert got.dtype == torch.int32 and got.shape == (N, E + 1)
    assert (got.sum(1) == P).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.abs_histogram_rows_ref(jnp.asarray(x), jnp.asarray(edges))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.abs_histogram_rows(jnp.asarray(x), jnp.asarray(edges))))


def test_non_monotone_edges_and_nan_count_by_compare():
    """A row whose fine edges step down by an ulp, a row with an edge out
    of order, and a NaN magnitude (it compares false: bucket 0)."""
    x = _rows(3, 500, 5)
    x[2, 7] = np.nan
    edges = np.sort(np.abs(_rows(3, 16, 6)), axis=1)
    edges[0, 5] = np.nextafter(edges[0, 4], np.float32(0))  # one ulp below its left edge
    edges[1, [3, 9]] = edges[1, [9, 3]]
    want = np.asarray(jref.abs_histogram_rows_ref(jnp.asarray(x), jnp.asarray(edges)))
    got = tsp.abs_histogram_rows(torch.tensor(x), torch.tensor(edges))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[2, 0]) >= 1


@pytest.mark.parametrize("M", [1000, 65536 + 7])
def test_flat_histogram_is_the_one_row_form(M):
    x = _rows(1, M, M)[0]
    edges = _log_edges(x[None], 128)[0]
    got = tsp.abs_histogram(torch.tensor(x), torch.tensor(edges))
    assert got.shape == (129,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.abs_histogram_ref(jnp.asarray(x), jnp.asarray(edges))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.abs_histogram(jnp.asarray(x), jnp.asarray(edges))))


@pytest.mark.parametrize("nbins", [128, 7, 2, 1])
def test_span_is_jnp_linspace_bitwise(nbins):
    np.testing.assert_array_equal(tsp._span(nbins, "cpu").numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, nbins)))


@pytest.mark.parametrize("k", [1, 30, 500, 5000])
def test_edge_pick_bitwise_given_the_same_edges(k):
    x = _rows(4, 5000, k)
    edges = _log_edges(x)
    edges[3] = 0.0  # no edge keeps k: t = 0
    x[3] = 0.0
    t, t_hi = tsp._pick_edge_rows(torch.tensor(x), k, torch.tensor(edges))
    jt, jt_hi = jsp._pick_edge_rows(jnp.abs(jnp.asarray(x)), k, jnp.asarray(edges), True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(jt_hi))


@pytest.mark.parametrize("N,P,k", [(6, 20_000, 200), (6, 20_000, 2000), (4, 1000, 1), (3, 300, 300)])
def test_threshold_rows_match_jax(N, P, k):
    x = _rows(N, P, k + P)
    got = tsp.topk_threshold_rows(torch.tensor(x), k)
    want = np.asarray(jops.topk_threshold_rows(jnp.asarray(x), k))
    assert got.dtype == torch.float32 and got.shape == (N,)
    lo = np.maximum(np.abs(x).max(1) * np.float32(1e-7), np.float32(1e-30))
    rtol = np.spacing(np.abs(np.log(lo))) + 8 * 2.0 ** -24
    assert (np.abs(got.numpy().astype(np.float64) - want) <= rtol * want).all()
    nsel = (np.abs(x) >= got.numpy()[:, None]).sum(1)
    assert (nsel >= k).all() and (nsel <= int(k * 1.35) + 8).all(), nsel


def test_threshold_of_zero_rows_is_zero():
    assert not tsp.topk_threshold_rows(torch.zeros((3, 256)), 4).any()


def test_cpu_tensor_takes_the_twin_and_leaves_the_counter():
    before = tsp.abs_histogram_rows.launches
    tsp.topk_threshold_rows(torch.randn(2, 300), 30)
    assert tsp.abs_histogram_rows.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tsp.abs_histogram_rows(torch.ones((2, 4), device="meta"), torch.ones((2, 3), device="meta"))


@pytest.mark.parametrize("M", [1, 1000, 65536 + 7])
def test_threshold_mask_bitwise_on_shared_thresholds(M):
    """Values and mask equal the Pallas kernel's (interpret mode) and the
    oracle's for the same threshold; a NaN is dropped."""
    x = _rows(1, M, M + 1)[0]
    if M > 2:
        x[M // 2] = np.nan
    for t in (0.0, float(np.median(np.abs(x[~np.isnan(x)]))), 1e30):
        vals, mask = tsp.threshold_mask(torch.tensor(x), t)
        assert vals.dtype == torch.float32 and mask.dtype == torch.bool
        for want in (jops.threshold_mask, jref.threshold_mask_ref):
            wv, wm = want(jnp.asarray(x), np.float32(t))
            np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))
            np.testing.assert_array_equal(mask.numpy(), np.asarray(wm))


@pytest.mark.parametrize("M,k", [(20_000, 200), (5000, 1), (70_001, 7000)])
def test_topk_mask_approx_matches_jax(M, k):
    """The one-vector threshold agrees with JAX's to the tolerance of the
    rows form (module docstring); values and mask are bitwise JAX's
    threshold_mask on the port's threshold, and keep at least k."""
    x = _rows(1, M, k)[0]
    vals, mask, t = tsp.topk_mask_approx(torch.tensor(x), k)
    _, _, jt = jops.topk_mask_approx(jnp.asarray(x), k)
    lo = max(np.abs(x).max() * np.float32(1e-7), np.float32(1e-30))
    rtol = np.spacing(np.abs(np.log(lo))) + 8 * 2.0 ** -24
    assert t.shape == () and abs(float(t) - float(jt)) <= rtol * float(jt)
    wv, wm = jops.threshold_mask(jnp.asarray(x), t.numpy())
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wm))
    assert int(mask.sum()) >= k


def test_threshold_mask_cpu_takes_the_twin():
    before = tsp.threshold_mask.launches
    tsp.topk_mask_approx(torch.randn(300), 30)
    assert tsp.threshold_mask.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tsp.threshold_mask(torch.ones(4, device="meta"), 0.5)
