"""Port parity: the sliding-window attention twin (what a CPU tensor gets
from ``repro_torch.kernels.swa_attention``) against the JAX package's
``ref.swa_attention_ref`` and its Pallas kernel (``ops.swa_attention``, in
interpret mode on the CPU), on the same numpy inputs.  Tolerances as the
reference's own kernel tests: fp32 rtol 3e-4 / atol 3e-5 (fp32 softmax,
another summation order), bf16 3e-2 (outputs rounded to bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import swa_attention as tswa


def _qkv(BH, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(BH, S, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("S,W,D", [(256, 128, 32), (512, 256, 64), (384, 128, 64)])
def test_twin_matches_reference_and_pallas(S, W, D):
    q, k, v = _qkv(2, S, D, S + W)
    got = tswa.swa_attention(*map(torch.as_tensor, (q, k, v)), W).numpy()
    for b in range(2):
        want = np.asarray(ref.swa_attention_ref(jnp.asarray(q[b]), jnp.asarray(k[b]),
                                                jnp.asarray(v[b]), W))
        np.testing.assert_allclose(got[b], want, rtol=3e-4, atol=3e-5)
    pallas = np.asarray(ops.swa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), W))
    np.testing.assert_allclose(got, pallas, rtol=3e-4, atol=3e-5)


def test_bf16():
    q, k, v = (a.astype(jnp.bfloat16) for a in map(jnp.asarray, _qkv(1, 256, 32, 0)))
    tq, tk, tv = (torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16) for a in (q, k, v))
    got = tswa.swa_attention(tq, tk, tv, 128)
    assert got.dtype == torch.bfloat16
    want = np.asarray(ref.swa_attention_ref(q[0], k[0], v[0], 128), np.float32)
    np.testing.assert_allclose(got[0].float().numpy(), want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("H,Hkv", [(6, 2), (9, 3), (4, 4)])
def test_gqa_form_equals_repeated_kv(H, Hkv):
    """Query head h reads KV head h // G: the same as the reference's
    repeated-KV (BH, S, D) route (models/attention.py, pallas_swa)."""
    rng = np.random.default_rng(H)
    B, S, D, W = 2, 256, 32, 128
    q = torch.as_tensor(rng.normal(size=(B, S, H, D)).astype(np.float32))
    k, v = (torch.as_tensor(rng.normal(size=(B, S, Hkv, D)).astype(np.float32)) for _ in range(2))
    got = tswa.swa_attention_gqa(q, k, v, W)
    G = H // Hkv
    merged = lambda t: t.permute(0, 2, 1, 3).reshape(B * H, S, D)
    rep = lambda t: merged(t.repeat_interleave(G, dim=2))  # jnp.repeat(k, G, axis=2)
    want = tswa.swa_attention(merged(q), rep(k), rep(v), W)
    torch.testing.assert_close(got, want.reshape(B, H, S, D).permute(0, 2, 1, 3),
                               rtol=1e-6, atol=1e-6)


def test_window_edge_is_strict():
    """Key i - window is out: with one large value there, row i ignores it."""
    S, D, W = 256, 8, 128
    q = torch.zeros((1, S, D))
    k = torch.zeros((1, S, D))
    v = torch.zeros((1, S, D))
    v[0, 10] = 1000.0
    out = tswa.swa_attention(q, k, v, W)
    assert float(out[0, 10 + W - 1].abs().max()) > 0   # key 10 in the window of row 137
    assert float(out[0, 10 + W].abs().max()) == 0       # not in row 138's


@pytest.mark.parametrize("D", [8, 40, 64, 128])
def test_route_by_dtype(D):
    """bf16 goes to the tensor-core kernel, fp32 to the fp32 one, at every
    head dim the kernels take; nothing else has a route."""
    assert tswa._route(torch.bfloat16, D) == "mma"
    assert tswa._route(torch.float32, D) == "simt"
    with pytest.raises(TypeError):
        tswa._route(torch.float16, D)
    with pytest.raises(ValueError):
        tswa._route(torch.bfloat16, D + 128)


@pytest.mark.parametrize("S,W,D", [(256, 128, 64), (384, 128, 32)])
def test_twin_rounding_p_to_bf16_stays_within_reference_tolerance(S, W, D):
    """The tensor-core route's rounding point, P in bf16 before P·V: the
    twin's softmax weights rounded so stay within the reference's own bf16
    tolerance of ``ref.swa_attention_ref`` on bf16 inputs."""
    q, k, v = (a.astype(jnp.bfloat16) for a in map(jnp.asarray, _qkv(1, S, D, S + D)))
    tq, tk, tv = (torch.as_tensor(np.asarray(a, np.float32)) for a in (q, k, v))
    pos = torch.arange(S)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
    s = torch.where(band, tq[0] @ tk[0].T / D ** 0.5, torch.tensor(tswa.NEG_INF))
    p = torch.softmax(s, dim=-1)
    got = (p.to(torch.bfloat16).float() @ tv[0]).to(torch.bfloat16)
    plain = tswa.swa_attention_gqa_ref(*(a.to(torch.bfloat16)[:, :, None] for a in (tq, tk, tv)),
                                       W)[0, :, 0]
    assert not torch.equal(got, plain)  # rounding P moves the output
    want = np.asarray(ref.swa_attention_ref(q[0], k[0], v[0], W), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)
