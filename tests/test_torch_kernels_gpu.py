"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card.  Marked ``gpu``: each test skips inside its body where no card is
present.  This file imports no JAX, so it also runs on a machine with the
card and without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: the gather merge fp32 1e-5 and bf16 1e-2 (both accumulate in
fp32; the kernel uses fused multiply-adds, the twin separate ones); int8
codes, scales and histogram counts bitwise (a NaN row included); the payload merge bitwise
where indices are distinct within each payload row (the twin adds in the kernel's order and
rounds as it does), on sorted and on unsorted rows, and two of its launches bitwise equal; the secure masks bitwise (x = 0, one key, sign +1)
and masked messages within 1e-6 (the kernels round as the twins do, with
no fused multiply-add, so they are expected bitwise); the threshold mask
bitwise; the sliding-window attention fp32 1e-4 and bf16 1e-2 (fp32
softmax in both, other summation orders; the bf16 route rounds P to bf16
before P·V and its outputs may part by one rounding); the SSD chunk step 1e-4 (fp32 sums of up to 256 terms in
another order).
"""
import pytest
import torch

from repro_torch import prng
from repro_torch.core import secure as tsecure
from repro_torch.core import sharing as tshare
from repro_torch.core import topology as ttop
from repro_torch.kernels import gossip_mix as gm
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import scatter_gossip as sg
from repro_torch.kernels import secure_mask as sm
from repro_torch.kernels import sparsify as tsp
from repro_torch.kernels import ssd_chunk as tssd
from repro_torch.kernels import swa_attention as tswa


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,P,padded,vec", [
    ("float32", 579_594, True, 4), ("float32", 1031, False, 1),
    ("bfloat16", 1_000_003, True, 8), ("bfloat16", 4098, False, 2),
])
def test_kernel_matches_twin_on_gpu(dtype, P, padded, vec):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(P)
    rows, w = ttop.SparseTopology.regular_circulant(64, 5).to(dev).merge_tables()
    dt = getattr(torch, dtype)
    per = 16 // torch.empty((), dtype=dt).element_size()
    ld = -(-P // per) * per if padded else P  # row stride; padded: 16-byte rows
    X = torch.empty((64, ld), dtype=dt, device=dev)[:, :P]
    X.copy_(torch.randn((64, P), generator=g, device=dev))
    out = torch.empty((64, ld), dtype=dt, device=dev)[:, :P] if padded else None
    assert gm._vec_width(X, X if out is None else out) == vec
    before = gm.gossip_mix_rows.launches
    got = gm.gossip_mix_rows(X, rows, w, out=out)
    torch.cuda.synchronize()
    assert gm.gossip_mix_rows.launches == before + 1
    want = gm.gossip_mix_rows_ref(X, rows, w)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    x1, w1 = torch.randn((6, P), device=dev), torch.rand(6, device=dev)
    torch.testing.assert_close(
        gm.gossip_mix(x1, w1),
        gm.gossip_mix_rows_ref(x1, torch.arange(6, dtype=torch.int32, device=dev)[None],
                               w1[None])[0],
        rtol=1e-5, atol=1e-5,
    )
    with pytest.raises(TypeError):
        gm.gossip_mix_rows(X.double(), rows, w)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 2, 1024])
@pytest.mark.parametrize("K", [1, 6, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_identity_and_explicit_rows_on_gpu(N, K, dtype):
    """Each grid size (N = 1 and 2 shrink the column tile) and slot count
    (the paths' K = 6, and K = 1 and 9 about it), on identity rows (no
    index tensor) and on explicit rows; identity rows equal explicit
    arange rows bitwise."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(N * 10 + K)
    P = 579_594 if N < 1024 else 4099
    dt = getattr(torch, dtype)
    X = torch.randn((N * K, P), generator=g, device=dev).to(dt)
    w = torch.rand((N, K), generator=g, device=dev)
    rows = torch.randint(0, N * K, (N, K), generator=g, device=dev, dtype=torch.int32)
    arange = torch.arange(N * K, dtype=torch.int32, device=dev).view(N, K)
    tol = TOL[dtype]
    for r in (None, rows):
        before = gm.gossip_mix_rows.launches
        got = gm.gossip_mix_rows(X, r, w)
        torch.cuda.synchronize()
        assert gm.gossip_mix_rows.launches == before + 1
        torch.testing.assert_close(got.float(), gm.gossip_mix_rows_ref(X, r, w).float(),
                                   rtol=tol, atol=tol)
    assert torch.equal(gm.gossip_mix_rows(X, None, w), gm.gossip_mix_rows(X, arange, w))
    if N == 1:
        assert torch.equal(gm.gossip_mix(X, w[0]), gm.gossip_mix_rows(X, arange, w)[0])
    else:
        assert torch.equal(gm.gossip_mix_nodes(X.view(N, K, P), w),
                           gm.gossip_mix_rows(X, arange, w))


@pytest.mark.gpu
@pytest.mark.parametrize("R,C,noisy", [(64, 57_959, False), (37, 1001, True), (3, 5, False)])
def test_codec_bitwise_twin_on_gpu(R, C, noisy):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(C)
    x = torch.randn((R, C), generator=g, device=dev) * torch.rand((R, 1), generator=g, device=dev)
    x[R - 1, C // 2] = float("nan")  # the last row's scale is NaN, its codes 0
    noise = torch.rand((R, C), generator=g, device=dev) if noisy else None
    before = (tq.quantize.launches, tq.dequantize.launches)
    codes, scale = tq.quantize(x, noise)
    out = tq.dequantize(codes, scale)
    torch.cuda.synchronize()
    assert (tq.quantize.launches, tq.dequantize.launches) == (before[0] + 1, before[1] + 1)
    want_c, want_s = tq.quantize_ref(x, noise)
    assert torch.equal(codes, want_c)
    torch.testing.assert_close(scale, want_s, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(scale[R - 1]).all() and not codes[R - 1].any()
    torch.testing.assert_close(out, tq.dequantize_ref(codes, scale), rtol=0, atol=0,
                               equal_nan=True)
    assert torch.isnan(out[R - 1]).all() and torch.isfinite(out[:R - 1]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("N,P,E", [(16, 579_594, 128), (5, 1001, 7), (3, 40, 1)])
def test_histogram_bitwise_twin_on_gpu(N, P, E):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(P)
    x = torch.randn((N, P), generator=g, device=dev)
    x[0, 3] = float("nan")
    edges = torch.sort(torch.rand((N, E), generator=g, device=dev) * 3, dim=1).values
    if E > 2:  # one row not monotone: the linear count
        edges[1, 1] = torch.nextafter(edges[1, 0], torch.zeros((), device=dev))
    before = tsp.abs_histogram_rows.launches
    got = tsp.abs_histogram_rows(x, edges)
    torch.cuda.synchronize()
    assert tsp.abs_histogram_rows.launches == before + 1
    assert torch.equal(got, tsp.abs_histogram_rows_ref(x, edges))
    assert (got.sum(1) == P).all()


@pytest.mark.gpu
@pytest.mark.parametrize("sorted_idx", [False, True])
@pytest.mark.parametrize("N,P,k,include_self", [(64, 579_594, 57_959, True), (33, 1003, 100, False)])
def test_payload_merge_twin_and_determinism_on_gpu(N, P, k, include_self, sorted_idx):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(N)
    X = torch.randn((N, P), generator=g, device=dev)
    idx = torch.rand((N, P), generator=g, device=dev).argsort(1)[:, :k].to(torch.int32).contiguous()
    val = torch.randn((N, k), generator=g, device=dev)
    if sorted_idx:
        idx, val = sg.sort_payload_rows(idx, val)
    rows, w = ttop.SparseTopology.regular_circulant(N, 6 if N % 2 == 0 else 4).to(dev).merge_tables(
        include_self=include_self)
    before = sg.payload_mix_rows.launches
    a = sg.payload_mix_rows(X, idx, val, rows, w, sorted_idx=sorted_idx)
    b = sg.payload_mix_rows(X, idx, val, rows, w, sorted_idx=sorted_idx)
    torch.cuda.synchronize()
    assert sg.payload_mix_rows.launches == before + 2
    assert torch.equal(a, b)
    assert torch.equal(a, sg.payload_mix_rows_ref(X, idx, val, rows, w))


@pytest.mark.gpu
@pytest.mark.parametrize("sorted_idx", [False, True])
def test_payload_merge_sums_duplicates_and_drops_out_of_range_on_gpu(sorted_idx):
    """Duplicate indices within one slot still sum; indices below 0 or at
    P and beyond are dropped; a sorted row keeps them at its ends."""
    dev = _card()
    P = 10_000
    X = torch.zeros((1, P), device=dev)
    idx = torch.tensor([[-5, 3, 3, 9_999, 7, 3, P, P + 7]], dtype=torch.int32, device=dev)
    val = torch.tensor([[1.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0]], device=dev)
    if sorted_idx:
        idx, val = sg.sort_payload_rows(idx, val)
    rows = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    w = torch.full((1, 1), 0.5, device=dev)
    out = sg.payload_mix_rows(X, idx, val, rows, w, sorted_idx=sorted_idx)
    torch.cuda.synchronize()
    assert float(out[0, 3]) == 0.5 * (1.0 + 2.0 + 16.0)
    assert float(out[0, 7]) == 4.0 and float(out[0, 9_999]) == 2.0
    assert float(out.abs().sum()) == 9.5 + 4.0 + 2.0


@pytest.mark.gpu
def test_payload_merge_many_slots_on_gpu():
    """More slots than a block holds ranges for at once (a star-like
    receiver of 150 payloads) go in groups, in order: bitwise the twin."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(150)
    N, R, S, P, k = 6, 40, 150, 5000, 300
    X = torch.randn((N, P), generator=g, device=dev)
    idx = torch.rand((R, P), generator=g, device=dev).argsort(1)[:, :k].to(torch.int32)
    val = torch.randn((R, k), generator=g, device=dev)
    rows = torch.randint(0, R, (N, S), generator=g, device=dev, dtype=torch.int32)
    w = torch.rand((N, S), generator=g, device=dev) / S
    got = sg.payload_mix_rows(X, idx, val, rows, w)
    torch.cuda.synchronize()
    assert torch.equal(got, sg.payload_mix_rows_ref(X, idx, val, rows, w))


@pytest.mark.gpu
def test_payload_merge_tile_edges_on_gpu():
    """Payload indices on both sides of every column-tile edge, and at the
    last column of a ragged last tile, land once each."""
    dev = _card()
    T = sg.load_library("scatter_gossip").payload_mix_rows_tile_cols()
    P = 3 * T + 5
    cols = sorted({c for e in (T, 2 * T, 3 * T) for c in (e - 1, e, e + 1)} | {0, P - 1})
    g = torch.Generator(device=dev).manual_seed(9)
    X = torch.randn((4, P), generator=g, device=dev)
    idx = torch.tensor([cols] * 4, dtype=torch.int32, device=dev)
    val = torch.randn((4, len(cols)), generator=g, device=dev)
    rows = torch.tensor([[1, 2], [2, 3], [3, 0], [0, 1]], dtype=torch.int32, device=dev)
    w = torch.rand((4, 2), generator=g, device=dev)
    got = sg.payload_mix_rows(X, idx, val, rows, w, sorted_idx=True)
    want = sg.payload_mix_rows_ref(X, idx, val, rows, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    untouched = torch.ones(P, dtype=torch.bool, device=dev)
    untouched[torch.tensor(cols, device=dev)] = False
    assert torch.equal(got[:, untouched], X[:, untouched])


def _hist_twice(x, edges):
    """Two launches of the histogram: the same bits, one count each."""
    before = tsp.abs_histogram_rows.launches
    a = tsp.abs_histogram_rows(x, edges)
    b = tsp.abs_histogram_rows(x, edges)
    torch.cuda.synchronize()
    assert tsp.abs_histogram_rows.launches == before + 2
    assert torch.equal(a, b)
    return a


def _fine_edges(a, k):
    """The top-k threshold's second-pass edges: linear inside the coarse
    bin that its first pass picks (sparsify.topk_threshold_rows)."""
    hi = a.abs().amax(1)
    lo = torch.clamp_min(hi * 1e-7, 1e-30)
    span = tsp._span(tsp.NBINS, a.device)[None, :]
    coarse = tsp._exp(tsp._log(lo)[:, None] * (1.0 - span)
                      + tsp._log(torch.clamp_min(hi, 1e-30))[:, None] * span)
    t0, t0_hi = tsp._pick_edge_rows(a, k, coarse)
    fine = t0[:, None] * (1.0 - span) + torch.maximum(t0_hi, t0 + 1e-30)[:, None] * span
    return coarse.contiguous(), fine.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("pass_", ["coarse", "fine"])
def test_histogram_both_topk_passes_bitwise_on_gpu(pass_):
    """Both passes of the top-k threshold at the path's row length, on the
    edges the path builds from the data: most of the fine pass's magnitudes
    fall in bucket 0."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(17)
    n, p = 16, 579_594
    x = torch.randn((n, p), generator=g, device=dev) * torch.rand((n, 1), generator=g, device=dev)
    coarse, fine = _fine_edges(x, p // 10)
    edges = coarse if pass_ == "coarse" else fine
    got = _hist_twice(x, edges)
    assert torch.equal(got, tsp.abs_histogram_rows_ref(x, edges))
    assert (got.sum(1) == p).all()
    if pass_ == "fine":
        assert (got[:, 0] > p // 2).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flat", "all_low", "all_high", "odd_slice", "slice3",
                                  "nonmono_nan", "E1", "E0", "search"])
def test_histogram_edge_shapes_bitwise_on_gpu(case):
    """The flat N=1 form at P=579,594; rows entirely below e[0] or at and
    above e[E-1]; odd P on column-slice views whose rows start off a
    16-byte boundary; a non-monotone row with a NaN; E=1 and E=0; rows
    whose interpolated start misses by more than a bucket (edges clustered
    at one end, ulp-spaced denormal edges): the binary search."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(23)
    base = torch.randn((6, 100_003), generator=g, device=dev)
    edges = torch.sort(torch.rand((6, 128), generator=g, device=dev) * 2 + 0.01, dim=1).values
    x = base
    if case == "flat":
        x1 = torch.randn(579_594, generator=g, device=dev)
        e1 = _fine_edges(x1[None], 57_959)[1][0]
        before = tsp.abs_histogram_rows.launches
        got = tsp.abs_histogram(x1, e1)
        torch.cuda.synchronize()
        assert tsp.abs_histogram_rows.launches == before + 1
        assert torch.equal(got, tsp.abs_histogram_rows_ref(x1[None], e1[None])[0])
        return
    if case == "all_low":
        x = base * 1e-3
        edges = edges + 1.0
    elif case == "all_high":
        x = base.abs() + 5.0
    elif case == "odd_slice":
        x = base[:, 1:]            # P = 100,002, rows 4 bytes past 16-byte boundaries
    elif case == "slice3":
        x = base[1:, 3:50_000]     # odd P, odd row offsets
        edges = edges[1:].contiguous()
    elif case == "nonmono_nan":
        x = base.clone()
        x[2, 5], x[4, 77] = float("nan"), float("nan")
        edges = edges.clone()
        edges[2, 60] = torch.nextafter(edges[2, 59], torch.zeros((), device=dev))
        edges[3, [10, 90]] = edges[3, [90, 10]]
    elif case == "E1":
        edges = edges[:, 64:65].contiguous()
    elif case == "E0":
        edges = edges[:, :0].contiguous()
    elif case == "search":
        x = base * 2.0
        edges = edges.clone()
        edges[:3] = torch.cat([torch.linspace(1.0, 1.001, 100, device=dev),
                               torch.linspace(2.0, 3.0, 28, device=dev)])
        edges[3] = (torch.full((128,), 1e-44, device=dev).view(torch.int32)
                    + torch.arange(128, dtype=torch.int32, device=dev)).view(torch.float32)
        x[3, :1000] = edges[3, torch.arange(1000, device=dev) % 128]
    got = _hist_twice(x, edges)
    assert torch.equal(got, tsp.abs_histogram_rows_ref(x, edges))
    assert (got.sum(1) == x.shape[1]).all()
    if case == "all_low":
        assert (got[:, 0] == x.shape[1]).all()
    if case == "all_high":
        assert (got[:, -1] == x.shape[1]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("R,C", [(1, 1), (4, 5), (1, 1001), (33, 1001), (16, 57_959),
                                 (1, 57_959), (3, 200_003)])
@pytest.mark.parametrize("noisy", [False, True])
def test_quantize_cluster_bitwise_twin_on_gpu(R, C, noisy):
    """Codes and scales bitwise the twin's at C from 1 to a row longer than
    a cluster's registers hold (200,003 > 65,536), a NaN row among them;
    two launches the same bits, one count each."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(R * C)
    x = torch.randn((R, C), generator=g, device=dev) * torch.rand((R, 1), generator=g, device=dev)
    if R > 1:
        x[R // 2, C // 3] = float("nan")
    noise = torch.rand((R, C), generator=g, device=dev) if noisy else None
    before = tq.quantize.launches
    c1, s1 = tq.quantize(x, noise)
    c2, s2 = tq.quantize(x, noise)
    torch.cuda.synchronize()
    assert tq.quantize.launches == before + 2
    assert torch.equal(c1, c2) and torch.equal(s1.view(torch.int32), s2.view(torch.int32))
    want_c, want_s = tq.quantize_ref(x, noise)
    assert torch.equal(c1, want_c)
    torch.testing.assert_close(s1, want_s, rtol=0, atol=0, equal_nan=True)
    if R > 1:
        assert torch.isnan(s1[R // 2]).all() and not c1[R // 2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("noisy", [False, True])
def test_quantize_unaligned_views_bitwise_twin_on_gpu(noisy):
    """Column-slice views whose x, noise and codes rows reach their 16- and
    4-byte boundaries after different peels take the single-column path."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((9, 57_962), generator=g, device=dev)[:, 1:-2]
    noise = torch.rand((9, 57_961), generator=g, device=dev)[:, 2:] if noisy else None
    codes, scale = tq.quantize(x, noise)
    torch.cuda.synchronize()
    want_c, want_s = tq.quantize_ref(x, noise)
    assert torch.equal(codes, want_c) and torch.equal(scale, want_s)


@pytest.mark.gpu
def test_hist_selection_on_gpu_keeps_k_largest_by_threshold():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn((16, 20_000), generator=g, device=dev).abs()
    k = 2000
    idx = tshare._topk_idx(a, k, "auto")  # resolves to the histogram on the card
    t = tsp.topk_threshold_rows(a, k)
    kept = a.gather(1, idx.long())
    assert (kept >= t[:, None]).all()
    assert (idx.diff(dim=1) > 0).all()  # the first k survivors, in index order
    torch.testing.assert_close(idx.cpu(), tshare._topk_idx(a.cpu(), k, "hist"), rtol=0, atol=0)


def _words(g, shape, dev):
    return torch.randint(0, 1 << 32, shape + (2,), generator=g, device=dev, dtype=torch.int64)


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,M", [(7, 1, 1), (5, 1, 1000), (3, 1, 70_001), (2, 1, 4_097)])
def test_keyed_mask_bitwise_on_gpu(B, K, M):
    """x = 0, one key, sign +1: the kernel writes the mask itself, bitwise
    the counter-layout bits mapped by the twin, odd and even M."""
    dev = _card()
    keys = _words(torch.Generator(device=dev).manual_seed(M), (B, K), dev)
    before = sm.secure_mask_apply_rows_keyed.launches
    got = sm.secure_mask_apply_rows_keyed(torch.zeros((B, M), device=dev), None, keys,
                                          torch.ones((B, K), device=dev), 0.7)
    torch.cuda.synchronize()
    assert sm.secure_mask_apply_rows_keyed.launches == before + 1
    want = sm.mask_bits_to_uniform(prng.counter_bits(keys[:, 0, 0:1], keys[:, 0, 1:2], M), 0.7)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("R,B,K,M", [(64, 320, 5, 579_594), (9, 37, 6, 1_003), (4, 5, 3, 2)])
def test_keyed_kernel_matches_twin_on_gpu(R, B, K, M):
    """Rows read by index (ragged B and M), zero signs skipped, and the
    in-place form (out=x, rows=None), where every fourth message has no
    nonzero sign and is left as it is."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(B)
    x = torch.randn((R, M), generator=g, device=dev)
    rows = torch.randint(0, R, (B,), generator=g, device=dev, dtype=torch.int32)
    keys = _words(g, (B, K), dev)
    signs = torch.randint(-1, 2, (B, K), generator=g, device=dev).float()
    signs[::4] = 0.0
    got = sm.secure_mask_apply_rows_keyed(x, rows, keys, signs, 1.0)
    want = sm.secure_mask_apply_rows_keyed_ref(x, rows, keys, signs, 1.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    back = sm.secure_mask_apply_rows_keyed(got, None, keys, -signs, 1.0, out=got)
    torch.cuda.synchronize()
    assert back is got
    torch.testing.assert_close(got, x[rows.long()], rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,M", [(64, 5, 579_594), (37, 4, 1_001)])
def test_staged_kernel_matches_twin_on_gpu(B, K, M):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(M)
    x = torch.randn((B, M), generator=g, device=dev)
    bits = torch.randint(-(1 << 31), 1 << 31, (B, K, M), generator=g, device=dev,
                         dtype=torch.int32)
    signs = torch.randint(-1, 2, (B, K), generator=g, device=dev).float()
    before = sm.secure_mask_apply_rows.launches
    got = sm.secure_mask_apply_nodes(x, bits, signs, 0.9)
    torch.cuda.synchronize()
    assert sm.secure_mask_apply_rows.launches == before + 1
    torch.testing.assert_close(got, sm.secure_mask_apply_rows_ref(x, None, bits, signs, 0.9),
                               rtol=0, atol=1e-6)
    flat = sm.secure_mask_apply(x[0], bits[0], signs[0], 0.9)
    torch.testing.assert_close(flat, got[0], rtol=0, atol=0)


@pytest.mark.gpu
def test_secure_round_on_gpu_launches_the_keyed_kernel_and_cancels():
    """The card's secure round with recovery: two keyed launches and one
    gather merge, the churn-reweighted plain aggregate on the live nodes,
    the CPU's round."""
    dev = _card()
    n, p = 24, 3_001
    graph = ttop.Graph.regular_circulant(n, 4)
    topo = ttop.SparseTopology.from_graph(graph)
    act = (torch.arange(n) % 5 != 2).float()
    X = torch.randn((n, p), generator=torch.Generator().manual_seed(0))
    s = tsecure.SecureAggregation(graph.adj, recovery=True)
    key = prng.key(5)
    Wm = tshare.participation_reweight_sparse(topo.to(dev), act.to(dev))
    before = (sm.secure_mask_apply_rows_keyed.launches, gm.gossip_mix_rows.launches)
    got, _, _ = s.round(X.to(dev), Wm, (), key, 4.0, rnd=3, act=act.to(dev))
    torch.cuda.synchronize()
    assert (sm.secure_mask_apply_rows_keyed.launches,
            gm.gossip_mix_rows.launches) == (before[0] + 2, before[1] + 1)
    live = act > 0
    plain = gm.gossip_mix_rows(X.to(dev), *Wm.merge_tables())
    torch.testing.assert_close(got[live.to(dev)], plain[live.to(dev)], rtol=0, atol=1e-5)
    cpu, _, _ = s.round(X, tshare.participation_reweight_sparse(topo.to("cpu"), act), (), key,
                        4.0, rnd=3, act=act)
    torch.testing.assert_close(got.cpu(), cpu, rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [579_594, 1, 1_000_003])
def test_threshold_mask_bitwise_on_gpu(M):
    dev = _card()
    x = torch.randn(M, generator=torch.Generator(device=dev).manual_seed(M), device=dev)
    k = max(1, M // 10)
    t = tsp.topk_threshold(x, k)
    x[M // 2] = float("nan")  # dropped by the mask
    before = tsp.threshold_mask.launches
    vals, mask = tsp.threshold_mask(x, t)
    torch.cuda.synchronize()
    assert tsp.threshold_mask.launches == before + 1
    wv, wm = tsp.threshold_mask_ref(x, t)
    assert torch.equal(mask, wm) and torch.equal(vals, wv) and not mask[M // 2]
    y = torch.randn(M, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    _, m2, t2 = tsp.topk_mask_approx(y, k)
    assert int(m2.sum()) >= k and torch.equal(t2, tsp.topk_threshold(y, k))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,Hkv,D,window,dtype", [
    (8, 4096, 9, 3, 64, 4096, "bfloat16"),   # the SmolLM-135M prefill
    (1, 8192, 9, 3, 64, 4096, "bfloat16"),   # the window cuts
    (2, 2048, 9, 3, 64, 1024, "float32"),
    (3, 200, 6, 2, 40, 100, "float32"),      # ragged S, head dim and window
    (2, 256, 2, 1, 128, 128, "bfloat16"),
])
def test_swa_kernel_matches_twin_on_gpu(B, S, H, Hkv, D, window, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(S + D)
    dt = getattr(torch, dtype)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
    kv = torch.randn((2, B, S, Hkv, D), generator=g, device=dev).to(dt)
    before = tswa.swa_attention_gqa.launches
    got = tswa.swa_attention_gqa(q, kv[0], kv[1], window)
    torch.cuda.synchronize()
    assert tswa.swa_attention_gqa.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), tswa.swa_attention_gqa_ref(q, kv[0], kv[1], window)
                               .float(), rtol=tol, atol=tol)


def _swa_mma_check(q, k, v, window):
    """One launch of the bf16 route, against the fp32-math twin at 1e-2."""
    assert tswa._route(q.dtype, q.shape[3]) == "mma"
    before = tswa.swa_attention_gqa.launches
    got = tswa.swa_attention_gqa(q, k, v, window)
    torch.cuda.synchronize()
    assert tswa.swa_attention_gqa.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), tswa.swa_attention_gqa_ref(q, k, v, window).float(),
                               rtol=1e-2, atol=1e-2)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 63, 200, 4096])
@pytest.mark.parametrize("window", [1, 63, 64, 65, "S"])
def test_swa_mma_route_matches_twin_on_gpu(S, window):
    """The tensor-core route at ragged S, windows about one key tile, every
    padded head dim (40 pads to 64) and G = H / Hkv of 1, 3 and 4."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(S)
    w = S if window == "S" else window
    B, Hkv = (1, 1) if S == 4096 else (2, 2)
    for D in (32, 40, 64, 128):
        for G in (1, 3, 4):
            q = torch.randn((B, S, G * Hkv, D), generator=g, device=dev).bfloat16()
            kv = torch.randn((2, B, S, Hkv, D), generator=g, device=dev).bfloat16()
            _swa_mma_check(q, kv[0], kv[1], w)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
def test_swa_mma_route_reads_fused_projection_views_on_gpu(offset):
    """q, k and v as strided views of one fused (B, S, (H + 2 Hkv) D)
    projection, as a fused QKV product gives them: 16-byte aligned rows
    (cp.async) and, one element off, unaligned ones (plain loads); each
    equals the kernel on contiguous copies, bitwise."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(19 + offset)
    B, S, H, Hkv, D = 2, 300, 9, 3, 64
    qkv = torch.randn((B, S, offset + (H + 2 * Hkv) * D), generator=g, device=dev).bfloat16()
    q = qkv[..., offset:offset + H * D].unflatten(-1, (H, D))
    k = qkv[..., offset + H * D:offset + (H + Hkv) * D].unflatten(-1, (Hkv, D))
    v = qkv[..., offset + (H + Hkv) * D:].unflatten(-1, (Hkv, D))
    got = _swa_mma_check(q, k, v, 128)
    assert torch.equal(got, tswa.swa_attention_gqa(q.contiguous(), k.contiguous(),
                                                   v.contiguous(), 128))


@pytest.mark.gpu
def test_swa_mma_window_edge_is_strict_on_gpu():
    """Key i - window is out in bf16 too: one large value at key 10 reaches
    row 10 + W - 1 and not row 10 + W."""
    dev = _card()
    S, D, W = 256, 64, 128
    q = torch.zeros((1, S, 1, D), device=dev, dtype=torch.bfloat16)
    k = torch.zeros_like(q)
    v = torch.zeros_like(q)
    v[0, 10] = 1000.0
    out = _swa_mma_check(q, k, v, W)
    assert float(out[0, 10 + W - 1].float().abs().max()) > 0
    assert float(out[0, 10 + W].float().abs().max()) == 0


@pytest.mark.gpu
def test_swa_merged_heads_form_on_gpu():
    """The reference's (BH, S, D) signature equals the GQA form on the
    repeated heads."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = torch.randn((3, 6, 384, 64), generator=g, device=dev)
    got = tswa.swa_attention(q, k, v, 128)
    heads = lambda t: t.transpose(0, 1)[None]  # (BH, S, D) -> (1, S, BH, D)
    want = tswa.swa_attention_gqa(heads(q), heads(k), heads(v), 128)
    torch.testing.assert_close(got, want[0].transpose(0, 1), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("G,L,H,P,N,strided", [
    (32, 256, 32, 64, 128, False),   # the Mamba2-370M forward
    (3, 16, 2, 8, 8, False),         # the smoke chunk
    # ragged, inputs read through unaligned row strides, steep decay (exp
    # above the diagonal would overflow); then two head groups, two column
    # passes over P and two chunks of N; then 16-byte copies of ragged rows
    (4, 100, 3, 40, 50, True),
    (2, 256, 11, 100, 200, True),
    (2, 193, 9, 128, 64, False),
])
def test_ssd_kernel_matches_twin_on_gpu(G, L, H, P, N, strided):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(L * N)
    xdt = (torch.randn((G, L, H, P + (3 if strided else 0)), generator=g, device=dev) * 0.2)[..., :P]
    bc = torch.randn((G, L, 2 * N + (3 if strided else 0)), generator=g, device=dev) * 0.4
    Bc, Cc = bc[..., :N], bc[..., N:2 * N]
    if not strided:
        Bc, Cc = Bc.contiguous(), Cc.contiguous()
    rate = 10.0 if strided else 0.1
    cum = -torch.cumsum(torch.rand((G, L, H), generator=g, device=dev) * rate, dim=1)
    before = tssd.ssd_chunk.launches
    got = tssd.ssd_chunk(xdt, Bc, Cc, cum)
    torch.cuda.synchronize()
    assert tssd.ssd_chunk.launches == before + 1
    for a, b in zip(got, tssd.ssd_chunk_ref(xdt, Bc, Cc, cum)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_model_routes_launch_the_kernels_on_gpu():
    """attn_apply under attn_impl="pallas_swa" (S and window multiples of
    128) launches the attention kernel once, and not at S = 200; ssm_apply
    under ssm_impl="pallas" launches the SSD kernel once; each agrees with
    its plain route on the card."""
    from repro_torch.models import attention as tattn
    from repro_torch.models import ssm as tssm
    from repro_torch.models.config import ModelConfig

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(11)
    cfg = ModelConfig(family="dense", d_model=192, n_heads=6, n_kv_heads=2, d_ff=256,
                      vocab=64, sliding_window=128, attn_impl="pallas_swa")
    p = tattn.attn_init(g, cfg)
    for S, want in ((256, 1), (200, 0)):
        x = torch.randn((2, S, 192), generator=g, device=dev)
        pos = torch.arange(S, device=dev)[None].expand(2, S)
        before = tswa.swa_attention_gqa.launches
        got, _ = tattn.attn_apply(p, cfg, x, pos)
        torch.cuda.synchronize()
        assert tswa.swa_attention_gqa.launches == before + want
        plain, _ = tattn.attn_apply(p, cfg.replace(attn_impl="naive"), x, pos)
        torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    scfg = ModelConfig(family="ssm", d_model=128, ssm_state=32, ssm_headdim=32, ssm_chunk=64,
                       ssm_impl="pallas")
    sp = tssm.ssm_init(g, scfg)
    x = torch.randn((2, 256, 128), generator=g, device=dev)
    before = tssd.ssd_chunk.launches
    got = tssm.ssm_apply(sp, scfg, x)
    torch.cuda.synchronize()
    assert tssd.ssd_chunk.launches == before + 1
    torch.testing.assert_close(got, tssm.ssm_apply(sp, scfg.replace(ssm_impl="jnp"), x),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(4, (1 << 24) + 3), (1024, 70_001), (3, 1)])
def test_uniform_draw_on_gpu_equals_the_cpu_draw(n, p):
    """``prng.uniform`` of an (N, 1) key table on the card, bitwise its CPU
    draw: (4, 2^24 + 3) crosses the card's lane group of 2^26 lanes within
    a row (the CPU's groups fall elsewhere), (1024, 70,001) splits the
    groups by rows."""
    dev = _card()
    k = prng.fold_in(prng.key(17), 5)
    ids = torch.arange(n)[:, None]
    got = prng.uniform(prng.fold_in(k, ids.to(dev)), (p,))
    want = prng.uniform(prng.fold_in(k, ids), (p,))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert torch.equal(got.cpu(), want)
    assert torch.equal(prng.bits(prng.fold_in(k, ids.to(dev)), (p,)).cpu(),
                       prng.bits(prng.fold_in(k, ids), (p,)))


@pytest.mark.gpu
def test_quantize_noise_from_the_prng_on_gpu():
    """Stochastic rounding with per-node keys (``QuantizedSharing``'s draw)
    on the card: codes and scales bitwise the twin fed the same uniforms,
    and bitwise the whole CPU path."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((64, 20_011), generator=g, device=dev)
    keys = tshare._node_keys(prng.fold_in(prng.key(17), 2), 64, dev)
    noise = prng.uniform(keys, (20_011,))
    before = tq.quantize.launches
    codes, scale = tshare.quantize_int8(x, keys)
    assert tq.quantize.launches == before + 1
    wc, ws = tq.quantize_ref(x, noise)
    assert torch.equal(codes, wc) and torch.equal(scale, ws)
    cc, cs = tshare.quantize_int8(x.cpu(), tshare._node_keys(prng.fold_in(prng.key(17), 2), 64,
                                                            "cpu"))
    assert torch.equal(codes.cpu(), cc) and torch.equal(scale.cpu(), cs)


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["uniform", "strided"])
def test_payload_merge_on_random_k_rows_on_gpu(sampler):
    """The random-k payloads as ``RandomKSharing`` builds them (uniform: the
    rows sorted after the stable top-k of the uniforms; strided: rebuilt
    i·stride + phase rows), merged with ``sorted_idx=True``: bitwise the
    twin, and the uniform indices bitwise the CPU's."""
    dev = _card()
    n, p, k = 64, 20_011, 2001
    g = torch.Generator(device=dev).manual_seed(9)
    X = torch.randn((n, p), generator=g, device=dev)
    key = prng.fold_in(prng.key(17), 3)
    if sampler == "uniform":
        idx = tshare._randk_idx(key, (n, p), k, dev)
        assert torch.equal(idx.cpu(), tshare._randk_idx(key, (n, p), k, "cpu"))
    else:
        stride = -(-p // k)
        X = torch.nn.functional.pad(X, (0, k * stride - p))
        phase = tshare._strided_phase(key, n, stride, dev)
        idx = (torch.arange(k, dtype=torch.int32, device=dev)[None] * stride + phase[:, None])
    assert bool((idx[:, 1:] > idx[:, :-1]).all())
    val = X.gather(1, idx.long())
    rows, w = ttop.SparseTopology.regular_circulant(n, 5).to(dev).merge_tables(include_self=False)
    before = sg.payload_mix_rows.launches
    got = sg.payload_mix_rows(X, idx, val, rows, w, sorted_idx=True)
    assert sg.payload_mix_rows.launches == before + 1
    assert torch.equal(got, sg.payload_mix_rows_ref(X, idx, val, rows, w))


def _quickstart_engine(device, init=None, **knobs):
    """The quickstart configuration at N=16, GN-LeNet width 8, 2 rounds,
    LAN model, with ``knobs`` (``faults`` a FaultPlan keyword dict)."""
    from repro_torch import DLConfig, FaultPlan, RoundEngine
    from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
    from repro_torch.models.cnn import cnn_init
    from repro_torch.optim import make_optimizer
    from repro_torch.quickstart import acc_fn, loss_fn

    if "faults" in knobs:
        knobs = {**knobs, "faults": FaultPlan(**knobs["faults"])}
    ds = make_dataset("cifar10", n_train=2048, n_test=128)
    parts = sharding_partition(ds.train_y, 16, 2, seed=0)
    dl = DLConfig(n_nodes=16, topology="regular", degree=5, local_steps=2, batch_size=8,
                  rounds=2, chunk_rounds=2, eval_every=1, network="lan", **knobs)
    return RoundEngine(dl, lambda g: cnn_init(g, width=8), loss_fn, acc_fn,
                       make_optimizer("sgd", 0.05),
                       NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0),
                       init_params=init, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("knobs,launches", [
    (dict(participation=0.9, faults=dict(msg_loss=0.2, latency_spike_prob=0.2,
                                          corrupt_prob=0.2, crashes=((5, 0, 1),), seed=1)),
     {"gossip_mix_rows": 2}),
    (dict(sharing="topk", budget=0.1, payload_quant=True, participation=0.7),
     {"abs_histogram_rows": 4, "quantize": 2, "dequantize": 2, "payload_mix_rows": 2}),
], ids=["faults", "churn-topk"])
def test_fault_and_churn_engines_on_gpu_match_the_cpu(knobs, launches):
    """The faults engine (one merge per round on the loss-reweighted table)
    and TopK int8 under churn on the card against the CPU from the same
    parameters: equal fault counters and bytes, parameters within 1e-4
    (TopK: a coordinate at the threshold could part the two, so its run
    uses the histogram selector on both and a 1e-4 bound holds at this
    size), and the launches the path makes."""
    from repro_torch.core.faults import STAT_KEYS
    from repro_torch.utils.pytree import tree_map

    dev = _card()
    gpu = _quickstart_engine(dev, **knobs)
    cpu = _quickstart_engine("cpu", init=tree_map(lambda a: a.cpu().clone(), gpu.params), **knobs)
    if "sharing" in knobs:
        import dataclasses

        for e in (gpu, cpu):
            e.sharing = e.steps.sharing = dataclasses.replace(e.sharing, selector="hist")
    wrappers = {"gossip_mix_rows": gm.gossip_mix_rows, "abs_histogram_rows": tsp.abs_histogram_rows,
                "quantize": tq.quantize, "dequantize": tq.dequantize,
                "payload_mix_rows": sg.payload_mix_rows}
    before = {k: f.launches for k, f in wrappers.items()}
    gpu.run(log=False)
    torch.cuda.synchronize()
    assert {k: f.launches - before[k] for k, f in wrappers.items()} == {
        **{k: 0 for k in wrappers}, **launches}
    cpu.run(log=False)
    assert gpu.scheduler._fault_totals == cpu.scheduler._fault_totals
    assert [{k: h.get(k) for k in STAT_KEYS} for h in gpu.history] == [
        {k: h.get(k) for k in STAT_KEYS} for h in cpu.history]
    assert gpu.bytes_sent == cpu.bytes_sent
    torch.testing.assert_close(gpu.X.cpu(), cpu.X, rtol=0, atol=1e-4)
    if "faults" in knobs:
        t = gpu.scheduler._fault_totals
        assert t["faults_injected"] == t["faults_detected"] + t["faults_survived"]
        assert t["faults_detected"] == t["faults_recovered"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,p", [(100_000, 8192, 306), (4096, 256, 579_594)])
def test_cohort_merge_through_the_gather_merge_on_gpu(n, c, p):
    """The async cohort path's neighbourhood merge: rows ``[cids | nbr]``
    of the (N, P) population, (C, 1+D) weights, one kernel launch, against
    the plain twin on the card."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(n)
    X = torch.randn((n, p), generator=g, device=dev)
    topo = ttop.SparseTopology.regular_circulant(n, 4).to(dev)
    cids = torch.sort(torch.randperm(n, generator=g, device=dev)[:c]).values
    rows = torch.cat([cids[:, None], topo.nbr[cids].long()], 1).to(torch.int32).contiguous()
    w = torch.cat([topo.w_self[cids, None], topo.w[cids]], 1).contiguous()
    before = gm.gossip_mix_rows.launches
    out = gm.gossip_mix_rows(X, rows, w)
    assert gm.gossip_mix_rows.launches == before + 1
    torch.testing.assert_close(out, gm.gossip_mix_rows_ref(X, rows, w), rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_int8_cold_rows_on_gpu_equal_the_cpu_codes():
    """The cold-row codec through the quantize and dequantize kernels:
    codes, scales and decoded rows bitwise those of the CPU twins, and a
    decoded row re-encodes to its own codes."""
    from repro_torch.core import compression as tcomp

    dev = _card()
    g = torch.Generator().manual_seed(1)
    tree = {"w1": torch.randn((4096, 16, 16), generator=g) * 3,
            "b1": torch.randn((4096, 16), generator=g), "t": torch.arange(4096, dtype=torch.int32)}
    tree["b1"][7] = 0.0
    cpu = tcomp.encode_cold(tree, "int8")
    before = (tq.quantize.launches, tq.dequantize.launches)
    gpu = tcomp.encode_cold({k: v.to(dev) for k, v in tree.items()}, "int8")
    for k in ("w1", "b1"):
        assert torch.equal(gpu[k].q.cpu(), cpu[k].q) and torch.equal(gpu[k].s.cpu(), cpu[k].s)
    dec = tcomp.decode_cold(gpu, "int8")
    assert (tq.quantize.launches - before[0], tq.dequantize.launches - before[1]) == (2, 2)
    ref = tcomp.decode_cold(cpu, "int8")
    for k in tree:
        assert torch.equal(dec[k].cpu(), ref[k])
    again = tcomp.encode_cold(dec, "int8")
    assert torch.equal(again["w1"].q, gpu["w1"].q)


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,seg", [(1 << 20, 8192, 11), (4096, 256, 4)])
def test_stable_tie_selection_on_gpu_equals_the_cpu(n, c, seg):
    """Flat and hierarchical cohort selection over clocks with ties by the
    thousand (``lax.top_k``'s lowest-id tie order through stable sorts):
    the card picks the CPU's cohort, padding slots included, and hier
    picks flat's members."""
    import types

    from repro_torch.core.scheduler import AsyncScheduler

    dev = _card()
    g = torch.Generator().manual_seed(n)
    t = (torch.randint(0, 64, (n,), generator=g).to(torch.float32) * 1e-3 + 1.0)

    def sched(device):
        s = types.SimpleNamespace(_cohort_c=c, _seg=seg, _n_seg=-(-n // seg),
                                  _seg_k=max(c, 2 * (-(-c // seg)), 8),
                                  eng=types.SimpleNamespace(dl=types.SimpleNamespace(
                                      async_slice_s=2e-3, n_nodes=n)))
        s._select_flat = lambda *a, **k: AsyncScheduler._select_flat(s, *a, **k)
        s._select_segments = lambda *a: AsyncScheduler._select_segments(s, *a)
        s._seg_min = AsyncScheduler._build_seg_min(s, t.to(device))
        return s

    out = {}
    for device in ("cpu", dev):
        s = sched(device)
        flat = AsyncScheduler._select_flat(s, t.to(device))
        hier = AsyncScheduler._select_hier(s, t.to(device), s._seg_min)
        out[str(device)] = [v.cpu() for v in flat + hier[:4]]
        # the selected members, occupancy and overflow agree (capacity
        # padding slots, cmask 0, may name other rows: they are no-ops)
        assert torch.equal(flat[0][flat[1] > 0], hier[0][hier[1] > 0])
        assert torch.equal(flat[2], hier[2]) and torch.equal(flat[3], hier[3])
    for a, b in zip(out["cpu"], out[str(dev)]):
        assert torch.equal(a, b)
    assert 0 < int(out["cpu"][2]) <= c


@pytest.mark.gpu
@pytest.mark.parametrize("sharing", ["full", "randomk-int8"])
def test_process_workers_launch_their_kernels_on_the_card(sharing):
    """``ProcessRunner`` with 2 worker processes on the card (N=8, the MLP
    of the runtime tests, 3 rounds): each worker reports the card, its
    merge (and codec) launches per round past warm-up, and the run equals
    the same run's workers on the CPU within 1e-4, with equal bytes."""
    _card()
    import numpy as np

    from repro_torch.core import DLConfig, RoundEngine
    from repro_torch.runtime import ProcessRunner, build_workload

    wl = {"dataset": "cifar10", "model": "mlp", "width": 1, "n_train": 256, "n_test": 64,
          "lr": 0.05}
    kw = dict(sharing="randomk", budget=0.25, payload_quant=True) if sharing != "full" else {}
    cfg = dict(n_nodes=8, topology="regular", degree=3, rounds=3, eval_every=2, seed=2, **kw)
    f, loss, acc, opt, batcher = build_workload(wl, DLConfig(**cfg))
    init = RoundEngine(DLConfig(**cfg), f, loss, acc, opt, batcher, device="cpu").params
    runs = {}
    for dev in ("cuda", "cpu"):
        r = ProcessRunner(DLConfig(**cfg, backend="processes"), wl, workers=2, device=dev,
                          init_params=init, watchdog_s=300.0, join_timeout_s=300.0)
        r.run(log=False)
        runs[dev] = r
    card, cpu = runs["cuda"], runs["cpu"]
    assert {res["device"] for res in card.worker_results.values()} == {"cuda"}
    if sharing == "full":
        assert card.launches == {"gossip_mix_rows": 6, "payload_mix_rows": 0, "quantize": 0,
                                 "dequantize": 0}
    else:
        assert card.launches["payload_mix_rows"] == card.launches["quantize"] == 6
        assert card.launches["dequantize"] == 6 + 2 * 3  # own + one frame per worker
    assert card.bytes_sent == cpu.bytes_sent
    np.testing.assert_allclose(card.final_X, cpu.final_X, rtol=0, atol=1e-4)
