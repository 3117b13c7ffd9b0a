"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card.  Marked ``gpu``: each test skips inside its body where no card is
present.  This file imports no JAX, so it also runs on a machine with the
card and without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: fp32 1e-5 and bf16 1e-2 (both accumulate in fp32; the kernel
uses fused multiply-adds, the twin separate ones).
"""
import pytest
import torch

from repro_torch.core import topology as ttop
from repro_torch.kernels import gossip_mix as gm

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,P,padded,vec", [
    ("float32", 579_594, True, 4), ("float32", 1031, False, 1),
    ("bfloat16", 1_000_003, True, 8), ("bfloat16", 4098, False, 2),
])
def test_kernel_matches_twin_on_gpu(dtype, P, padded, vec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
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
