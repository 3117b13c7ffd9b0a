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
import re
from pathlib import Path

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


def _mask_edge_case(case):
    """(x, t) of an edge case of the mask: signed zeros, infinities, NaN."""
    x = _rows(1, 64, 5)[0]
    x[:6] = [-0.0, 0.0, np.inf, -np.inf, np.nan, 1.0]
    return {
        "signed_zero_at_t0": (x, 0.0),
        "inf_at_finite_t": (x, 0.5),
        "t_inf": (x, np.inf),
        "t_nan": (x, np.nan),
        "tiny_1": (x[:1], 0.0),
        "tiny_2": (x[2:4], 1e30),
        "tiny_3": (x[:3], -1.0),
        "tiny_5": (x[:5], 0.0),
        "slice_at_1": (x[1:], 0.0),
    }[case]


@pytest.mark.parametrize("case", ["signed_zero_at_t0", "inf_at_finite_t", "t_inf", "t_nan",
                                  "tiny_1", "tiny_2", "tiny_3", "tiny_5", "slice_at_1"])
def test_threshold_mask_edge_cases_bitwise(case):
    """The twin's values equal the Pallas kernel's and the oracle's bit for
    bit (int32 views: a kept -0.0 stays -0.0, a NaN is dropped as +0.0, a
    NaN threshold drops everything), and so do the masks; the slice starts
    4 bytes past its tensor's storage, as ``x[1:]`` does on the card."""
    xn, t = _mask_edge_case(case)
    base = torch.tensor(np.concatenate([[np.float32(7.0)], xn]).astype(np.float32))
    x = base[1:]  # a view at a 4-byte offset
    vals, mask = tsp.threshold_mask(x, t)
    for want in (jops.threshold_mask, jref.threshold_mask_ref):
        wv, wm = want(jnp.asarray(xn), np.float32(t))
        np.testing.assert_array_equal(vals.numpy().view(np.int32), np.asarray(wv).view(np.int32))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(wm))
    if case == "signed_zero_at_t0":
        assert vals[0].numpy().view(np.int32) == np.float32(-0.0).view(np.int32) and mask[0]
    if case == "t_nan":
        assert not mask.any() and not vals.numpy().view(np.int32).any()


# --- the CUDA kernel's index arithmetic (csrc/sparsify.cu), modelled in
# plain torch: the kernel itself runs only on the card
# (tests/test_torch_kernels_gpu.py)

def _cu_const(name, source="sparsify"):
    src = (Path(tsp.__file__).parent / "csrc" / f"{source}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _bits(v):
    return v.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _start(a, e, mode):
    """start<kLogStep> / start<kLinearStep>: the bucket a middle magnitude's
    search starts from, in [1, E-1], non-decreasing in a.  Log: the float
    bits interpolated, 1 + umulhi(bits(a) - bits(e0), (E-1) 2^32 / (bits(eL)
    - bits(e0))); linear: fma(a - e0, (E-1) / (eL - e0), 1) truncated."""
    E = e.numel()
    if mode == "log":
        scale = ((E - 1) << 32) // int(_bits(e[-1]) - _bits(e[0]))
        assert scale < 1 << 19
        d = (_bits(a) - int(_bits(e[0]))) & 0xFFFFFFFF
        return torch.clamp_max(1 + ((d * scale) >> 32), E - 1)
    with np.errstate(divide="ignore", over="ignore"):
        inv = np.float32(E - 1) / (np.float32(e[-1]) - np.float32(e[0]))
    x = (a - e[0]).double() * float(inv) + 1.0   # one rounding to fp32, as the fma
    t = torch.nan_to_num(x.float(), nan=1.0).clamp(1.0, float(E - 1))
    return t.to(torch.int64)


def _kernel_mode(e):
    """The block's mode for a row of edges e (E,) fp32: "log"/"linear" where
    the start lands within one bucket of every magnitude's bucket (checked
    at both ends of each bucket's interval), "search" for other
    non-decreasing edges, "compare_all" for the rest."""
    E = e.numel()
    if not bool((e[1:] >= e[:-1]).all()):
        return "compare_all"
    if E < 2:
        return "search"
    normal = float(np.finfo(np.float32).tiny)
    mode = "log" if bool(e[0] >= normal) and bool(e[-1] > 2 * e[0]) else "linear"
    b = torch.arange(1, E)
    lo = torch.clamp_min(e[:-1], 0.0)
    held = e[1:] > lo
    hi = (_bits(e[1:]) - 1).to(torch.int32).view(torch.float32)
    ok = (_start(lo, e, mode) >= b - 1) & (_start(hi, e, mode) <= b + 1)
    return mode if bool(ok[held].all()) else "search"


def _kernel_buckets(a, e, start=None):
    """The kernel's bucket of each magnitude a (M,) fp32 against one row's
    edges e (E,) fp32: a < e[0] (or NaN) is 0, a >= e[E-1] is E, a middle
    one steps once down and once up from its start (``start`` replaces
    the kernel's, for a test of the step alone), or is found by a binary
    search; edges not non-decreasing count the compare over every edge."""
    mode = _kernel_mode(e)
    if mode == "compare_all":
        return (a[:, None] >= e[None, :]).sum(1), mode
    E = e.numel()
    inf = torch.tensor(float("inf"))
    e0, eL = (e[0], e[-1]) if E else (inf, inf)
    lo, hi = ~(a >= e0), a >= eL
    b = torch.where(hi & ~lo, E, 0)
    mid = ~lo & ~hi
    am = a[mid]
    if mode == "search":
        b[mid] = torch.searchsorted(e, am, right=True)
        return b, mode
    bm = _start(am, e, mode) if start is None else start
    bm = bm - (am < e[bm - 1]).long()
    b[mid] = bm + (am >= e[bm]).long()
    return b, mode


def _edge_cases(p, seed):
    """Magnitudes of every kind: normal, zeros, denormals, inf, NaN."""
    x = torch.tensor(_rows(1, p, seed)[0])
    x[:8] = torch.tensor([0.0, -0.0, 1e-45, -3e-39, float("inf"), float("-inf"),
                          float("nan"), 1e-38])
    return x.abs()


def _fine_edges(x, k):
    """The second pass's linear edges, as topk_threshold_rows builds them."""
    a = torch.tensor(x)
    span = tsp._span(tsp.NBINS, "cpu")[None, :]
    t0, t0_hi = tsp._pick_edge_rows(a, k, torch.tensor(_log_edges(x)))
    return t0[:, None] * (1.0 - span) + torch.maximum(t0_hi, t0 + 1e-30)[:, None] * span


def _ulp_edges(base, n=128):
    """n edges, each one ulp above the last."""
    bits = torch.full((n,), base, dtype=torch.float32).view(torch.int32)
    return (bits + torch.arange(n, dtype=torch.int32)).view(torch.float32)


def _one_row_edges(kind):
    x = _rows(2, 20_000, 12)
    log_e = torch.tensor(_log_edges(x)[0])
    if kind == "nonmono":
        log_e[40] = log_e[39] * 0.999
    if kind == "nan_edge":
        log_e[3] = float("nan")
    return {
        "log": log_e, "nonmono": log_e, "nan_edge": log_e,
        "linear": _fine_edges(x, 2000)[0], "ulp": _ulp_edges(0.5),
        "E0": torch.zeros(0), "E1": torch.tensor([0.7]), "E2": torch.tensor([1e-3, 2.0]),
        "flat": torch.full((16,), 0.5), "zero_lo": torch.linspace(0.0, 1e-30, 128),
        "negative": torch.linspace(-1.0, 3.0, 128), "denormal": _ulp_edges(1e-44, 64),
        "clustered": torch.cat([torch.linspace(1.0, 1.001, 100), torch.linspace(2.0, 3.0, 28)]),
    }[kind].to(torch.float32).contiguous()


@pytest.mark.parametrize("kind,mode", [
    ("log", "log"), ("linear", "linear"), ("ulp", "linear"), ("nonmono", "compare_all"),
    ("nan_edge", "compare_all"), ("E0", "search"), ("E1", "search"), ("E2", "log"),
    ("flat", "linear"), ("zero_lo", "linear"), ("negative", "linear"), ("denormal", "search"),
    ("clustered", "search"),
])
def test_kernel_bucket_rule_is_the_compare_count(kind, mode):
    """The kernel's rule gives #{e : a >= e[e]} for every magnitude (zeros,
    denormals, inf, NaN among them), whatever the edges: one step each way
    from the start where it is checked within one bucket, a binary search
    where it is not."""
    e = _one_row_edges(kind)
    a = _edge_cases(20_000, 11)
    if e.numel():  # the edges themselves and their neighbours
        below = torch.nextafter(e, torch.zeros_like(e))
        a = torch.cat([a, e.abs(), below.abs(), torch.nextafter(e, e + 1).abs()])
    want = (a[:, None] >= e[None, :]).sum(1)
    got, got_mode = _kernel_buckets(a, e)
    assert got_mode == mode
    assert torch.equal(got, want)
    hist = torch.bincount(got, minlength=e.numel() + 1)
    assert torch.equal(hist.to(torch.int32), tsp.abs_histogram_rows_ref(a[None], e[None])[0])


@pytest.mark.parametrize("kind", ["log", "linear", "ulp", "E2", "flat"])
def test_one_step_each_way_is_exact_from_within_one_bucket(kind):
    """The branch-free step: from any start within one bucket of the right
    one (and in [1, E-1]), one compare down and one up land on it."""
    e = _one_row_edges(kind)
    a = _edge_cases(20_000, 13)
    a = torch.cat([a, e, torch.nextafter(e, torch.zeros_like(e))])
    want = (a[:, None] >= e[None, :]).sum(1)
    mid = (a >= e[0]) & ~(a >= e[-1])
    g = torch.Generator().manual_seed(3)
    start = (want[mid] + torch.randint(-1, 2, (int(mid.sum()),), generator=g)).clamp(1, e.numel() - 1)
    got, _ = _kernel_buckets(a, e, start)
    assert torch.equal(got, want)


@pytest.mark.parametrize("pass_", ["coarse", "fine"])
def test_the_paths_edges_take_the_one_step_rule(pass_):
    """Both passes of the top-k threshold, on data like the path's, run
    the branch-free rule (log start on the coarse edges, linear on the
    fine ones), not the binary search."""
    x = _rows(8, 50_000, 21)
    edges = torch.tensor(_log_edges(x)) if pass_ == "coarse" else _fine_edges(x, 5000)
    for r in range(8):
        e = edges[r].contiguous()
        a = torch.tensor(x[r]).abs()
        got, mode = _kernel_buckets(a, e)
        assert mode == ("log" if pass_ == "coarse" else "linear")
        assert torch.equal(got, (a[:, None] >= e[None, :]).sum(1))


def _hist_block_columns(p, mis, J):
    """Columns each of a row's J blocks counts (csrc/sparsify.cu): a peel
    up to the first (4 kVec)-byte boundary (the row starts ``mis`` floats
    past one), vectors [V j / J, V (j+1) / J) of kVec floats, the tail."""
    vec = _cu_const("kVec")
    h = min((vec - mis % vec) % vec, p)
    V = (p - h) // vec
    tail = h + V * vec
    out = []
    for j in range(J):
        cols = [np.arange(h + (V * j // J) * vec, h + (V * (j + 1) // J) * vec)]
        if j == 0:
            cols.append(np.arange(h))
        if j == J - 1:
            cols.append(np.arange(tail, p))
        out.append(np.concatenate(cols))
    return out


def _hist_blocks_per_row(n, p, sms=132):
    """blocks_per_row of csrc/sparsify.cu."""
    want = _cu_const("kWaves") * (2048 // _cu_const("kThreads")) * sms
    by_row = -(-(p // _cu_const("kVec")) // _cu_const("kMinVecs"))
    return max(1, min(-(-want // n), by_row))


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 7, 1001, 4096, 65537, 579_594])
def test_kernel_grid_counts_every_column_once(p):
    for n in (1, 3, 16, 1024):
        J = _hist_blocks_per_row(n, p)
        for mis in range(4):
            cols = np.concatenate(_hist_block_columns(p, mis, J))
            np.testing.assert_array_equal(np.sort(cols), np.arange(p))
        for J2 in (1, 2, 7, 64, 283):  # any J, not only the one chosen
            cols = np.concatenate(_hist_block_columns(p, 1, J2))
            np.testing.assert_array_equal(np.sort(cols), np.arange(p))


def test_kernel_grid_fills_the_card():
    """At the path's shape the grid runs a few blocks per row; the flat
    N=1 form runs hundreds of blocks, where one block per 8192 columns
    ran 71."""
    assert _hist_blocks_per_row(1024, 579_594) * 1024 >= 4 * 132
    assert 200 <= _hist_blocks_per_row(1, 579_594) <= 2000


def _mask_plan(M, x_off=0, sms=132, waves=None):
    """threshold_mask_f32's plan (csrc/sparsify.cu) for x starting x_off
    floats past a 16-byte boundary (the values and the mask are the
    wrapper's own, aligned allocations): the V 4-element chunks from
    element 0, the first tail element, the grid (at most ``waves`` grids of
    resident blocks, the source's kMaskWaves unless given), and whether the
    chunks load x as 16-byte vectors."""
    vec, T, K = _cu_const("kVec"), _cu_const("kThreads"), _cu_const("kMaskVecs")
    V = M // vec
    blocks = max(-(-V // (T * K)), 1)
    blocks = min(blocks, (waves or _cu_const("kMaskWaves")) * (2048 // T) * sms)
    return {"V": V, "tail": V * vec, "blocks": blocks, "vec_x": x_off % vec == 0}


def _mask_elements(M, plan):
    """Every element the kernel's threads take, in one array: each thread's
    chunks base + u kThreads (u < kMaskVecs) of each block step, then the
    tail, one element a thread from the first thread of the grid."""
    vec, T, K = _cu_const("kVec"), _cu_const("kThreads"), _cu_const("kMaskVecs")
    V, tail, B = plan["V"], plan["tail"], plan["blocks"]
    first = (np.arange(B)[:, None] * T * K + np.arange(T)[None, :]).ravel()
    chunks = []
    for j in range(-(-V // (B * T * K)) + 1):
        base = first + j * B * T * K
        for u in range(K):
            c = base + u * T
            chunks.append(c[(base < V) & (c < V)])
    c = np.concatenate(chunks)
    body = (vec * c[:, None] + np.arange(vec)[None, :]).ravel()
    i = tail + np.arange(B * T)
    return np.concatenate([body, i[i < M]])


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8, 9, 1003, 65_543, 579_593, 579_594])
def test_mask_plan_takes_every_element_once(M):
    """The chunks and the tail cover [0, M) exactly once at every phase of
    x, on the source's grid and on grids capped low enough that the loop
    strides; x loads as vectors exactly where it is 16-byte aligned."""
    for x_off in range(4):
        for sms, waves in ((132, None), (1, 1), (3, 1)):
            plan = _mask_plan(M, x_off, sms=sms, waves=waves)
            got = _mask_elements(M, plan)
            np.testing.assert_array_equal(np.bincount(got, minlength=M), np.ones(M, np.int64))
        assert M - plan["tail"] < 4 and plan["blocks"] >= 1
        assert plan["vec_x"] == (x_off == 0)


@pytest.mark.parametrize("waves", [None, 1, 4])
def test_mask_plan_covers_the_whole_state(waves):
    """At the whole state (1024 nodes' P) the block steps cover the V
    chunks once, on the source's grid (one block step a block) and on grids
    of a few waves that stride: each residue r of the grid step is one
    (block, u, thread) start, and r < V takes ceil((V - r) / step) chunks
    (arithmetic only)."""
    T, K = _cu_const("kThreads"), _cu_const("kMaskVecs")
    M = 1024 * 579_594
    plan = _mask_plan(M, waves=waves)
    assert (plan["tail"], plan["vec_x"]) == (M - M % 4, True)
    B, V = plan["blocks"], plan["V"]
    step = B * T * K
    if waves is None:  # one step: the last block starts below V, its end reaches V
        assert (B - 1) * T * K < V <= step
        return
    assert B == waves * (2048 // T) * 132
    r = (np.arange(B)[:, None, None] * T * K + np.arange(K)[None, :, None] * T
         + np.arange(T)[None, None, :]).ravel()
    np.testing.assert_array_equal(np.sort(r), np.arange(step))
    assert int(np.maximum(0, -(-(V - r) // step)).sum()) == V


@pytest.mark.parametrize("M", [1, 1003, 579_594, 1024 * 579_594])
def test_mask_grid_stays_within_its_waves(M):
    """The grid never passes kMaskWaves waves of resident blocks (8 of 256
    threads an SM) on any SM count, and takes every chunk in one block step
    up to that cap: one node's P and the whole state on 132 SMs."""
    T, K = _cu_const("kThreads"), _cu_const("kMaskVecs")
    cap = _cu_const("kMaskWaves") * (2048 // T)
    for sms in (1, 66, 132):
        plan = _mask_plan(M, sms=sms)
        assert 1 <= plan["blocks"] <= cap * sms
    plan = _mask_plan(M)
    assert plan["blocks"] * T * K >= plan["V"]
