"""Port parity: the SSD intra-chunk twin (what a CPU tensor gets from
``repro_torch.kernels.ssd_chunk``) against the JAX package's
``ref.ssd_chunk_ref`` and its Pallas kernel (``ops.ssd_chunk``, in
interpret mode on the CPU), and ``ssd_scan`` against the sequential
recurrence.  Tolerances as the reference's own kernel tests (rtol 3e-4,
atol 2e-5 for the chunk step: fp32, another summation order; rtol 3e-3,
atol 1e-4 for the scan against a float64 recurrence)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as tssd


def _inputs(G, L, H, P, N, seed, lead=()):
    rng = np.random.default_rng(seed)
    xdt = (rng.normal(size=(*lead, G, L, H, P)) * 0.2).astype(np.float32)
    Bc = (rng.normal(size=(*lead, G, L, N)) * 0.4).astype(np.float32)
    Cc = (rng.normal(size=(*lead, G, L, N)) * 0.4).astype(np.float32)
    cum = -np.cumsum(rng.uniform(size=(*lead, G, L, H)) * 0.1, axis=-2).astype(np.float32)
    return xdt, Bc, Cc, cum


@pytest.mark.parametrize("L,N,P,H", [(32, 16, 16, 2), (64, 32, 32, 4), (128, 64, 64, 2)])
def test_twin_matches_reference_and_pallas(L, N, P, H):
    arrs = _inputs(2, L, H, P, N, L * N)
    got = [t.numpy() for t in tssd.ssd_chunk(*map(torch.as_tensor, arrs))]
    for g in range(2):
        want = ref.ssd_chunk_ref(*(jnp.asarray(a[g]) for a in arrs))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[g], np.asarray(b), rtol=3e-4, atol=2e-5)
    pallas = ops.ssd_chunk(*map(jnp.asarray, arrs))
    for a, b in zip(got, pallas):
        np.testing.assert_allclose(a, np.asarray(b), rtol=3e-4, atol=2e-5)


def test_ssd_scan_equals_sequential_recurrence():
    B, nc, L, H, P, N = 1, 3, 16, 2, 8, 8
    xdt, Bc, Cc, cum = _inputs(nc, L, H, P, N, 0, lead=(B,))
    got = tssd.ssd_scan(*map(torch.as_tensor, (xdt, Bc, Cc, cum))).numpy()
    np.testing.assert_allclose(got, np.asarray(ops.ssd_scan(*map(jnp.asarray, (xdt, Bc, Cc, cum)))),
                               rtol=3e-4, atol=2e-5)
    S = nc * L
    xf, Bf, Cf = xdt.reshape(B, S, H, P), Bc.reshape(B, S, N), Cc.reshape(B, S, N)
    dA = np.diff(cum, axis=2, prepend=np.zeros((B, nc, 1, H))).reshape(B, S, H)
    h = np.zeros((B, H, N, P))
    ys = []
    for t in range(S):
        h = h * np.exp(dA[:, t])[:, :, None, None] + np.einsum("bn,bhp->bhnp", Bf[:, t], xf[:, t])
        ys.append(np.einsum("bn,bhnp->bhp", Cf[:, t], h))
    np.testing.assert_allclose(got, np.stack(ys, 1).reshape(B, nc, L, H, P), rtol=3e-3, atol=1e-4)


def test_steep_decay_gives_no_nan():
    """Above the diagonal cum_i - cum_j is large and positive: exp overflows
    there, and the twin, as the reference, selects it away."""
    xdt, Bc, Cc, cum = _inputs(2, 64, 2, 8, 8, 5)
    cum = cum * 1000.0
    y, st, dec = tssd.ssd_chunk(*map(torch.as_tensor, (xdt, Bc, Cc, cum)))
    assert all(bool(torch.isfinite(t).all()) for t in (y, st, dec))
    want = ref.ssd_chunk_ref(*(jnp.asarray(a[0]) for a in (xdt, Bc, Cc, cum)))
    np.testing.assert_allclose(y[0].numpy(), np.asarray(want[0]), rtol=3e-4, atol=2e-5)


def _tf32(x, mode):
    """x rounded to TF32 (10 mantissa bits): 'truncate' clears the low 13
    bits, as the tensor core reads an fp32 register; 'round' rounds to
    nearest, ties away from zero, as the kernel's ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    if mode == "round":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _mm3(a, b, mode):
    """a @ b as the kernel's 3xTF32 takes it: each fp32 operand split as
    hi + lo, both TF32, and lo·hi + hi·lo + hi·hi summed (the products of
    two TF32 values are exact; the sums here in float64)."""
    ah, bh = _tf32(a, mode), _tf32(b, mode)
    al, bl = _tf32(a - ah, mode), _tf32(b - bh, mode)
    d = lambda u, v: u.double() @ v.double()
    return (d(al, bh) + d(ah, bl) + d(ah, bh)).float()


@pytest.mark.parametrize("mode", ["round", "truncate"])
def test_three_tf32_products_keep_fp32_accuracy(mode):
    """The kernel's split at the Mamba2-370M chunk (L 256, N 128, P 64):
    C·Bᵀ, S·xdt and the state product from three TF32 products each are
    within 1e-5 of the fp32 twin, relative to each output's scale, where a
    single TF32 product of C·Bᵀ is not within 1e-4."""
    L, N, P = 256, 128, 64
    xdt, Bc, Cc, cum = map(torch.as_tensor, _inputs(1, L, 1, P, N, 16))
    xdt, Bc, Cc, cum = xdt[0, :, 0], Bc[0], Cc[0], cum[0, :, 0]
    cb = _mm3(Cc, Bc.T, mode)
    want_cb = Cc @ Bc.T
    assert float((cb - want_cb).abs().max()) <= 1e-5 * float(want_cb.abs().max())
    # one TF32 product alone would miss the 1e-4 gate of the kernel checks
    one = _tf32(Cc, mode).double() @ _tf32(Bc.T, mode).double()
    assert float((one.float() - want_cb).abs().max()) > 1e-4 * float(want_cb.abs().max())
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    S = torch.where(tri, cb * torch.exp(cum[:, None] - cum[None, :]), torch.zeros(()))
    y = _mm3(S, xdt, mode)
    w = torch.exp(cum[-1] - cum)
    st = _mm3((Bc * w[:, None]).T, xdt, mode)
    want_y, want_st, _ = tssd.ssd_chunk_ref(xdt[None, :, None], Bc[None], Cc[None],
                                            cum[None, :, None])
    for got, want in ((y, want_y[0, :, 0]), (st, want_st[0, 0])):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
