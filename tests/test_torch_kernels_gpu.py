"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card.  Marked ``gpu``: each test skips inside its body where no card is
present.  This file imports no JAX, so it also runs on a machine with the
card and without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: the gather merge fp32 1e-5 and bf16 1e-2 (both accumulate in
fp32; the kernel uses fused multiply-adds, the twin separate ones); int8
codes, scales and histogram counts bitwise (a NaN row included); the payload merge 1e-5 (the
twin adds in the kernel's order, through another scatter), and two of its
launches bitwise equal.
"""
import pytest
import torch

from repro_torch.core import sharing as tshare
from repro_torch.core import topology as ttop
from repro_torch.kernels import gossip_mix as gm
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import scatter_gossip as sg
from repro_torch.kernels import sparsify as tsp


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
@pytest.mark.parametrize("N,P,k,include_self", [(64, 579_594, 57_959, True), (33, 1003, 100, False)])
def test_payload_merge_twin_and_determinism_on_gpu(N, P, k, include_self):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(N)
    X = torch.randn((N, P), generator=g, device=dev)
    idx = torch.rand((N, P), generator=g, device=dev).argsort(1)[:, :k].to(torch.int32).contiguous()
    val = torch.randn((N, k), generator=g, device=dev)
    rows, w = ttop.SparseTopology.regular_circulant(N, 6 if N % 2 == 0 else 4).to(dev).merge_tables(
        include_self=include_self)
    before = sg.payload_mix_rows.launches
    a = sg.payload_mix_rows(X, idx, val, rows, w)
    b = sg.payload_mix_rows(X, idx, val, rows, w)
    torch.cuda.synchronize()
    assert sg.payload_mix_rows.launches == before + 2
    assert torch.equal(a, b)
    torch.testing.assert_close(a, sg.payload_mix_rows_ref(X, idx, val, rows, w),
                               rtol=1e-5, atol=1e-5)


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
