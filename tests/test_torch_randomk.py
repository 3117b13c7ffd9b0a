"""Port parity: the strategies that draw random numbers (random-k with the
uniform and the strided sampler, quantized full sharing with stochastic
rounding or not, CHOCO-SGD with the random-k compressor) and the strided
payload merge, against the JAX package.

Tolerances: indices, phases, codes, scales and bytes bitwise; one share
step from the same inputs within 1e-6 (fp32 summation order); whole
engine runs as ``_torch_engine_parity`` says.  Random-k picks its
coordinates from keys, not from X, so its whole trajectory is continuous
and compared after every eval; quantized sharing's floor(x/scale + u)
is not, so its run is compared share step by share step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)

from _torch_engine_parity import (
    WHOLE,
    assert_run_metrics_match,
    assert_whole_run_tracks,
    jax_run,
    torch_run,
)
from repro.core import mixing as jmix
from repro.core import sharing as jshare
from repro.core.topology import Graph as JGraph
from repro.core.topology import SparseTopology as JSparse
from repro_torch import prng
from repro_torch.core import mixing as tmix
from repro_torch.core import sharing as tshare
from repro_torch.core.topology import SparseTopology

N, P = 8, 20_011
ATOL = 1e-6


def _tables(n=N, d=5):
    st = JSparse.from_graph(JGraph.regular_circulant(n, d))
    jW = JSparse(jnp.asarray(st.nbr), jnp.asarray(st.w), jnp.asarray(st.w_self))
    return jW, SparseTopology(st.nbr, st.w, st.w_self).to("cpu")


def _keys(seed=17, rnd=3):
    return (jax.random.fold_in(jax.random.key(seed), rnd),
            prng.fold_in(prng.key(seed), rnd))


def _x(seed=0, n=N, p=P):
    return np.random.default_rng(seed).normal(size=(n, p)).astype(np.float32)


def _tied_k(u_row, lo=1000, hi=4000):
    """A k whose k-th and (k+1)-th largest values of ``u_row`` are equal."""
    s = np.sort(u_row)[::-1]
    for j in range(lo, hi):
        if s[j - 1] == s[j]:
            return j
    raise AssertionError("no tie in range")


def test_randk_indices_bitwise_with_ties_across_the_kth_value():
    """The top-k set of 23-bit uniforms, ties broken toward the lower index
    as ``lax.top_k`` breaks them, at a k where the k-th value is tied with
    the (k+1)-th: the set is the reference's, each row sorted."""
    jk, tk = _keys()
    u = tshare._randk_uniforms(tk, (N, P), "cpu").numpy()
    k = _tied_k(u[0])
    want = np.sort(np.asarray(jshare._randk_idx(jk, (N, P), k)), 1)
    got = tshare._randk_idx(tk, (N, P), k, "cpu").numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    kth = np.sort(u[0])[::-1][k - 1]
    tied = np.nonzero(u[0] == kth)[0]
    assert len(tied) >= 2 and np.isin(tied, got[0]).any() and not np.isin(tied, got[0]).all()
    # the lower index of the tied pair is the one kept
    assert tied.min() in got[0] and tied.max() not in got[0]


def test_strided_phase_bitwise():
    jk, tk = _keys(5, 9)
    for stride in (1, 7, 11, 256, 70_000):
        want = np.asarray(jshare._strided_phase(jk, N, stride))
        got = tshare._strided_phase(tk, N, stride, "cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


ROUNDS = [
    ("randomk", {}), ("randomk", dict(sampler="strided")),
    ("randomk", dict(quantize="int8")), ("randomk", dict(sampler="strided", quantize="int8")),
    ("randomk", dict(payload=False)), ("randomk", dict(sampler="strided", payload=False)),
    ("quant", {}), ("quant", dict(stochastic=False)),
    ("choco", dict(compressor="randk")), ("choco", dict(compressor="randk", quantize="int8")),
]


@pytest.mark.parametrize("name,kw", ROUNDS)
def test_round_matches_jax(name, kw):
    """One share step from the same X and state: X' and state within 1e-6,
    bytes, wire dtype and staged bytes equal."""
    jW, tW = _tables()
    jk, tk = _keys()
    X = _x(1)
    j, t = jshare.make_sharing(name, **kw), tshare.make_sharing(name, **kw)
    if name == "choco":
        xhat = _x(2) * 0.5
        jst, tst = {"xhat": jnp.asarray(xhat)}, {"xhat": torch.tensor(xhat)}
    else:
        jst, tst = j.init_state(jnp.asarray(X)), t.init_state(torch.tensor(X))
    jX2, jst2, jb = jax.jit(lambda X, s: j.round(X, jW, s, jk, 5.0, 3))(jnp.asarray(X), jst)
    tX2, tst2, tb = t.round(torch.tensor(X), tW, tst, tk, 5.0, 3)
    np.testing.assert_allclose(tX2.numpy(), np.asarray(jX2), atol=ATOL, rtol=0)
    for key in tst2:
        np.testing.assert_allclose(tst2[key].numpy(), np.asarray(jst2[key]), atol=ATOL, rtol=0)
    assert np.float32(tb) == np.float32(jb)
    assert t.wire_dtype(torch.float32) == str(np.dtype(j.wire_dtype(jnp.float32)))
    assert int(t.stage_bytes_per_round(N, P)) == int(j.stage_bytes_per_round(N, P))


def test_stochastic_quant_round_draws_per_node_noise():
    """Stochastic and nearest rounding give other codes; node keys differ
    per node (no row reuses another's noise)."""
    jW, tW = _tables()
    _, tk = _keys()
    X = np.tile(_x(3, 1), (N, 1))
    a = tshare.make_sharing("quant").round(torch.tensor(X), tW, (), tk, 5.0)[0]
    b = tshare.make_sharing("quant", stochastic=False).round(torch.tensor(X), tW, (), tk, 5.0)[0]
    assert not torch.equal(a, b)
    codes, _ = tshare.quantize_int8(torch.tensor(X), tshare._node_keys(tk, N, "cpu"))
    assert not torch.equal(codes[0], codes[1])


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("dense", [False, True])
def test_mix_payload_strided_matches_jax(exact, dense):
    """The strided merge through the payload-merge kernel's twin on the
    rebuilt index rows, within 1e-6 of the reference's cell-view update."""
    jW, tW = _tables()
    if dense:
        Wd = JGraph.regular_circulant(N, 5).metropolis_hastings().astype(np.float32)
        jW, tW = jnp.asarray(Wd), torch.tensor(Wd)
    k, stride = 1819, 11
    X = _x(4, N, k * stride)
    phase = np.random.default_rng(5).integers(0, stride, N).astype(np.int32)
    idx = np.arange(k)[None, :] * stride + phase[:, None]
    val = np.take_along_axis(X, idx, 1)
    if not exact:
        val = val + np.float32(0.01)
    want = jmix.mix_payload_strided(jW, jnp.asarray(phase), jnp.asarray(val), jnp.asarray(X),
                                    exact_values=exact)
    got = tmix.mix_payload_strided(tW, torch.tensor(phase), torch.tensor(val), torch.tensor(X),
                                   exact_values=exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


RUNS = {
    "uniform": dict(sharing="randomk"),
    "strided": dict(sharing="randomk", randk_sampler="strided"),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def randk_run(request):
    cfg = {**WHOLE, **RUNS[request.param]}
    return cfg, jax_run(cfg)


def test_randomk_engine_tracks_jax_over_the_whole_run(randk_run):
    cfg, want = randk_run
    eng, snaps = torch_run(cfg, want["init"])
    assert_whole_run_tracks(eng, snaps, want)
    assert_run_metrics_match(eng, want)


@pytest.fixture(scope="module")
def quant_run():
    # two rounds: each share step is replayed on its own
    cfg = {**WHOLE, "sharing": "quant", "rounds": 2, "eval_every": 1}
    return cfg, jax_run(cfg)


def test_quant_engine_share_steps_match_jax_round_by_round(quant_run):
    """Quantized sharing with stochastic rounding, N=8 degree 5, 2 rounds:
    the run's bytes and simulated time equal JAX's, and each round's share
    step, fed the JAX engine's X, operand and key, gives its X' within
    1e-6."""
    cfg, want = quant_run
    eng, _ = torch_run(cfg, want["init"])
    assert_run_metrics_match(eng, want)
    assert len(want["steps"]) == cfg["rounds"]
    for X, W, kd, degree, rnd, _, jX2, jbytes in want["steps"]:
        Wt = SparseTopology(W.nbr, W.w, W.w_self).to("cpu")
        X2, _, nbytes = eng.sharing.round(torch.tensor(X), Wt, (), (int(kd[0]), int(kd[1])),
                                          float(degree), int(rnd))
        np.testing.assert_allclose(X2.numpy(), jX2, atol=ATOL, rtol=0)
        assert np.float32(nbytes) == jbytes
