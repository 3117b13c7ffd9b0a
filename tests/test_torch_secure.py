"""Port parity: secure aggregation (``core/secure.py``) and its mask
kernels' plain twins (``kernels/secure_mask.py``) against the JAX
package: its Pallas kernels in interpret mode, its ``kernels/ref.py``
oracles, its ``SecureAggregation`` and its RoundEngine.

Tolerances: masks bitwise (the same bits, the same fp32 mapping); a masked
message within 1e-6 (sums of a few uniform masks in another order); a
secure round within 1e-6 of JAX's and within 1e-5 of the plain aggregate
it must equal once the masks cancel (the masks are of order 1 and cancel
only up to fp32 rounding); bytes equal; the engine runs as
``_torch_engine_parity`` says.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)

from _hypothesis_compat import given, settings, st
from _torch_engine_parity import (
    REPLAY,
    WHOLE,
    assert_run_metrics_match,
    assert_whole_run_tracks,
    jax_run,
    torch_run,
)
from repro.core import secure as jsecure
from repro.core.sharing import participation_reweight as jreweight
from repro.core.sharing import participation_reweight_sparse as jreweight_sparse
from repro.core.topology import Graph as JGraph
from repro.core.topology import SparseTopology as JSparse
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import prng
from repro_torch.core import secure as tsecure
from repro_torch.core import sharing as tsharing
from repro_torch.core.mixing import apply_W
from repro_torch.core.topology import SparseTopology
from repro_torch.kernels import secure_mask as sm


def _keys(rng, shape):
    return rng.integers(0, 1 << 32, size=shape + (2,), dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy -> torch, uint32 words widened to int64."""
    a = np.asarray(a)
    return torch.tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


# ---------------------------------------------------------------------------
# the mask kernels' twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 2, 127, 4097])
def test_keyed_mask_bitwise(M):
    """x = 0, one key, sign +1: the twin's output is the mask itself,
    bitwise ref.mask_bits_to_uniform(counter_bits_ref) and the keyed
    Pallas kernel's."""
    keys = _keys(np.random.default_rng(M), (3, 1))
    x, signs = np.zeros((3, M), np.float32), np.ones((3, 1), np.float32)
    got = sm.secure_mask_apply_nodes_keyed(torch.zeros(3, M), _t(keys), torch.ones(3, 1), 0.7)
    for b in range(3):
        bits = jref.counter_bits_ref(keys[b, 0, 0], keys[b, 0, 1], jnp.arange(M), M)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(jref.mask_bits_to_uniform(bits, 0.7)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.secure_mask_apply_nodes_keyed(
        jnp.asarray(x), jnp.asarray(keys), jnp.asarray(signs), 0.7)))


@pytest.mark.parametrize("B,K,M,bound", [(3, 4, 333, 0.9), (5, 2, 70_001, 1.3), (2, 5, 128, 1.0)])
def test_keyed_twin_matches_jax(B, K, M, bound):
    rng = np.random.default_rng(B * K * M)
    x = rng.normal(size=(B, M)).astype(np.float32)
    keys = _keys(rng, (B, K))
    signs = rng.choice([-1.0, 0.0, 1.0], (B, K)).astype(np.float32)
    got = sm.secure_mask_apply_nodes_keyed(torch.tensor(x), _t(keys), torch.tensor(signs), bound)
    for want in (jref.secure_mask_apply_nodes_keyed_ref, jops.secure_mask_apply_nodes_keyed):
        w = np.asarray(want(jnp.asarray(x), jnp.asarray(keys), jnp.asarray(signs), bound))
        np.testing.assert_allclose(got.numpy(), w, atol=1e-6, rtol=0)


def test_rows_form_reads_by_index_and_writes_in_place():
    """The kernel form reads base rows of x by index; with rows=None and
    out=x it overwrites x with the same result."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(4, 301)).astype(np.float32))
    rows = torch.tensor([2, 0, 2, 3, 1], dtype=torch.int32)
    keys = _t(_keys(rng, (5, 3)))
    signs = torch.tensor(rng.choice([-1.0, 0.0, 1.0], (5, 3)).astype(np.float32))
    got = sm.secure_mask_apply_rows_keyed(x, rows, keys, signs, 1.0)
    want = sm.secure_mask_apply_nodes_keyed(x[rows.long()], keys, signs, 1.0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    y = x[rows.long()].clone()
    back = sm.secure_mask_apply_rows_keyed(y, None, keys, signs, 1.0, out=y)
    assert back is y
    np.testing.assert_array_equal(y.numpy(), want.numpy())


@pytest.mark.parametrize("B,K,M", [(3, 4, 333), (2, 3, 4096)])
def test_staged_twin_matches_jax_and_the_keyed_form(B, K, M):
    rng = np.random.default_rng(M)
    x = rng.normal(size=(B, M)).astype(np.float32)
    keys = _keys(rng, (B, K))
    signs = rng.choice([-1.0, 0.0, 1.0], (B, K)).astype(np.float32)
    bits = np.stack([np.stack([np.asarray(jref.counter_bits_ref(
        keys[b, k, 0], keys[b, k, 1], jnp.arange(M), M)) for k in range(K)]) for b in range(B)])
    got = sm.secure_mask_apply_nodes(torch.tensor(x), torch.tensor(bits), torch.tensor(signs), 0.9)
    want = jops.secure_mask_apply_nodes(jnp.asarray(x), jnp.asarray(bits), jnp.asarray(signs), 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    keyed = sm.secure_mask_apply_nodes_keyed(torch.tensor(x), _t(keys), torch.tensor(signs), 0.9)
    np.testing.assert_array_equal(got.numpy(), keyed.numpy())
    flat = sm.secure_mask_apply(torch.tensor(x[0]), torch.tensor(bits[0]), torch.tensor(signs[0]), 0.9)
    want1 = jops.secure_mask_apply(jnp.asarray(x[0]), jnp.asarray(bits[0]), jnp.asarray(signs[0]), 0.9)
    np.testing.assert_allclose(flat.numpy(), np.asarray(want1), atol=1e-6, rtol=0)


def test_cpu_tensor_takes_the_twin_and_leaves_the_counter():
    before = (sm.secure_mask_apply_rows_keyed.launches, sm.secure_mask_apply_rows.launches)
    sm.secure_mask_apply_nodes_keyed(torch.zeros(2, 9), torch.zeros(2, 1, 2, dtype=torch.int64),
                                     torch.ones(2, 1))
    sm.secure_mask_apply_nodes(torch.zeros(2, 9), torch.zeros(2, 1, 9, dtype=torch.int32),
                               torch.ones(2, 1))
    assert (sm.secure_mask_apply_rows_keyed.launches, sm.secure_mask_apply_rows.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        sm.secure_mask_apply_rows_keyed(torch.ones((2, 4), device="meta"), None,
                                        torch.ones((2, 1, 2), device="meta"),
                                        torch.ones((2, 1), device="meta"))


@pytest.mark.parametrize("M", [1, 3, 1001])
def test_flat_staged_form_matches_jax_at_odd_widths(M):
    """The flat (M,) form at widths the staged kernel handles by its peel
    and tail alone (1, 3) and at an odd M: within 1e-6 of the reference's
    Pallas kernel in interpret mode, and bitwise row 0 of the stacked form."""
    rng = np.random.default_rng(M + 5)
    x = rng.normal(size=(2, M)).astype(np.float32)
    bits = rng.integers(0, 2**32, size=(2, 5, M), dtype=np.uint64).astype(np.uint32)
    signs = np.array([[1, 0, -1, 1, -1], [0, 0, 1, 0, 0]], np.float32)
    flat = sm.secure_mask_apply(torch.tensor(x[0]), torch.tensor(bits[0].view(np.int32)),
                                torch.tensor(signs[0]), 0.9)
    want = jops.secure_mask_apply(jnp.asarray(x[0]), jnp.asarray(bits[0]),
                                  jnp.asarray(signs[0]), 0.9)
    np.testing.assert_allclose(flat.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    stacked = sm.secure_mask_apply_nodes(torch.tensor(x), torch.tensor(bits.view(np.int32)),
                                         torch.tensor(signs), 0.9)
    np.testing.assert_array_equal(flat.numpy(), stacked[0].numpy())


# --- the staged kernel's partition (csrc/secure_mask.cu secure_mask_bits_kernel),
# modelled in plain Python: the kernel itself runs only on the card
# (tests/test_torch_kernels_gpu.py)

def _cu_const(name):
    src = (Path(sm.__file__).parent / "csrc" / "secure_mask.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _staged_chunks(B, M, sms=132):
    """staged_grid of csrc/secure_mask.cu: column chunks per message."""
    by_row = max(1, -(-(M // _cu_const("kStagePos")) // _cu_const("kStageThreads")))
    want = _cu_const("kStageWaves") * (2048 // _cu_const("kStageThreads")) * sms
    return min(max(min(by_row, -(-want // B)), 1), 65535)


def _staged_cover(B, M, K, xa, ba, oa, ldx, ldo):
    """Times each (message, position) is summed by the staged kernel's
    grid and warp steps, and the access width W the host picks for word
    addresses xa, ba, oa (x, bits, out) and row strides ldx, ldo: lane l
    of a step takes the W-word accesses at l * W + a * 32 (a a multiple
    of W under kStagePos), the peel and the tail one position to a
    thread.  Asserts every access of x, of each slot's bit row and of out
    is aligned."""
    pos, threads = _cu_const("kStagePos"), _cu_const("kStageThreads")

    def same_peel(w):
        m = w - 1
        return (w <= pos and (xa - ba) & m == 0 and (xa - oa) & m == 0 and ldx & m == 0
                and M & m == 0 and ldo & m == 0)

    W = 4 if same_peel(4) else 2 if same_peel(2) else 1
    warps = _staged_chunks(B, M) * threads // 32
    step = 32 * pos
    seen = np.zeros((B, M), np.int64)
    for b in range(B):
        xr = xa + b * ldx
        h = min(0 if W == 1 else (W - xr % W) % W, M)
        steps = (M - h) // step
        tail = h + steps * step
        for e in range(h + (M - tail)):
            seen[b, e if e < h else tail + (e - h)] += 1
        for warp in range(warps):
            for w in range(warp, steps, warps):
                for lane in range(32):
                    for a in range(0, pos, W):
                        m = h + w * step + lane * W + a * 32
                        assert (xr + m) % W == 0 and (oa + b * ldo + m) % W == 0
                        assert all((ba + (b * K + k) * M + m) % W == 0 for k in range(K))
                        seen[b, m:m + W] += 1
    return seen, W


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 1001, 1002, 4096, 70_002])
@pytest.mark.parametrize("B,addr,W_mod4", [(1, (0, 0, 0), {0: 4, 2: 2}), (3, (0, 0, 0), {0: 4, 2: 2}),
                                           (1, (1, 1, 1), {0: 4, 2: 2}), (2, (2, 0, 2), {0: 2, 2: 2}),
                                           (1, (1, 0, 0), {})])
def test_staged_kernel_sums_each_position_once(M, B, addr, W_mod4):
    """Every (message, position) is summed exactly once at widths from 1 to
    past a block's steps, with 16-, 8- and 4-byte accesses (M = 2 mod 4
    leaves the slot rows 8-byte aligned), peeled or not."""
    seen, W = _staged_cover(B, M, 5, *addr, M, M)
    np.testing.assert_array_equal(seen, np.ones((B, M), np.int64))
    assert W == W_mod4.get(M % 4, 1)


def test_staged_grid_is_sized_by_the_card():
    """At B = 1 and the main path's M the grid takes every block a row has
    work for (one step a thread, all resident at once); at B = 1024 it
    holds kStageWaves waves of resident blocks and strides over the rest."""
    M, pos, threads = 579_594, _cu_const("kStagePos"), _cu_const("kStageThreads")
    by_row = -(-(M // pos) // threads)
    waves = _cu_const("kStageWaves") * (2048 // threads) * 132
    assert _staged_chunks(1, M) == by_row and by_row * threads * pos >= M
    assert _staged_chunks(1024, M) == -(-waves // 1024) and 1024 * _staged_chunks(1024, M) >= waves
    assert _staged_chunks(1 << 20, M) == 1


# ---------------------------------------------------------------------------
# SecureAggregation.round
# ---------------------------------------------------------------------------

def _setup(n, degree, p, seed):
    g = JGraph.regular_circulant(n, degree)
    X = np.random.default_rng(seed).normal(size=(n, p)).astype(np.float32)
    W = g.metropolis_hastings().astype(np.float32)
    return g, X, W


def _act(n, seed):
    """A churn mask with at least one down and one live node."""
    rng = np.random.default_rng(seed)
    act = (rng.random(n) > 0.4).astype(np.float32)
    act[rng.integers(n)] = 0.0
    act[rng.integers(n)] = 1.0
    return act


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("churn", [False, True])
@settings(max_examples=3, deadline=None)
@given(st.integers(0, 10_000))
def test_round_matches_jax(sparse, churn, seed):
    """The port's secure round within 1e-6 of JAX's, on dense and sparse W,
    with and without the recovery pass, the round key folded from seeds
    and rounds drawn across the word range; bytes equal."""
    g, X, W = _setup(10, 4, 96, seed)
    act = _act(10, seed) if churn else None
    rnd = seed % 13
    jkey = jax.random.fold_in(jax.random.key(seed), rnd)
    tkey = prng.fold_in(prng.key(seed), rnd)
    js = jsecure.SecureAggregation(g.adj, recovery=churn)
    ts = tsecure.SecureAggregation(g.adj, recovery=churn)
    if sparse:
        jst = JSparse.from_graph(g)
        jW = JSparse(jnp.asarray(jst.nbr), jnp.asarray(jst.w), jnp.asarray(jst.w_self))
        tW = SparseTopology(jst.nbr, jst.w, jst.w_self).to("cpu")
    else:
        jW, tW = jnp.asarray(W), torch.tensor(W)
    degree, jkw, tkw = 4.0, {}, {}
    if churn:
        jW, jdeg = (jreweight_sparse if sparse else jreweight)(jW, jnp.asarray(act))
        tW = (tsharing.participation_reweight_sparse if sparse
              else tsharing.participation_reweight)(tW, torch.tensor(act))
        degree = np.float32(jdeg)
        jkw, tkw = {"act": jnp.asarray(act)}, {"act": torch.tensor(act)}
    jX2, _, jb = js.round(jnp.asarray(X), jW, (), jkey, degree, rnd, **jkw)
    tX2, _, tb = ts.round(torch.tensor(X), tW, (), tkey, degree, rnd, **tkw)
    np.testing.assert_allclose(tX2.numpy(), np.asarray(jX2), atol=1e-6, rtol=0)
    if churn:  # an fp32 degree: the bytes as the engine's compiled round computes them
        jb = jax.jit(lambda d: d * 96 * 4 * (1.0 + jsecure.METADATA_OVERHEAD))(jdeg)
    assert np.float32(tb) == np.float32(jb)


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 10_000))
def test_masks_cancel(seed):
    """With recovery the masked aggregate equals the churn-reweighted plain
    aggregate (the port's own apply_W) on the live nodes; without churn it
    equals the plain aggregate everywhere."""
    g, X, W = _setup(12, 4, 64, seed)
    act = _act(12, seed)
    s = tsecure.SecureAggregation(g.adj, recovery=True)
    Xt, key = torch.tensor(X), prng.key(seed)
    Wm = tsharing.participation_reweight(torch.tensor(W), torch.tensor(act))
    got, _, _ = s.round(Xt, Wm, (), key, 4.0, rnd=seed % 7, act=torch.tensor(act))
    live = act > 0
    np.testing.assert_allclose(got.numpy()[live], apply_W(Wm, Xt).numpy()[live], atol=1e-5, rtol=0)
    plain = tsecure.SecureAggregation(g.adj)
    topo = SparseTopology.from_graph(JGraph.regular_circulant(12, 4)).to("cpu")
    got, _, _ = plain.round(Xt, topo, (), key, 4.0, rnd=1)
    np.testing.assert_allclose(got.numpy(), apply_W(topo, Xt).numpy(), atol=1e-5, rtol=0)


def test_reference_schedule_agrees_and_messages_are_masked():
    """round_reference (the dict of messages) equals the vectorized round
    (same bits: the masks are bitwise equal, sums in another order); every
    message differs from the plain parameters by a mask of order 1."""
    g, X, W = _setup(6, 4, 40, 0)
    s = tsecure.SecureAggregation(g.adj)
    Xt, key = torch.tensor(X), prng.key(11)
    ref, _, nb_ref = s.round_reference(Xt, torch.tensor(W), (), key, 4.0, rnd=3)
    got, _, nb = s.round(Xt, torch.tensor(W), (), key, 4.0, rnd=3)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    assert nb == nb_ref == 4.0 * 40 * 4 * 1.03
    msgs = s.messages(Xt, key, 3)
    assert len(msgs) == 6 * 4
    for (i, r), m in msgs.items():
        assert (m - Xt[i]).abs().mean() > 0.1


def test_strategy_metadata_matches_jax():
    g = JGraph.regular_circulant(8, 4)
    for rec in (False, True):
        j, t = jsecure.SecureAggregation(g.adj, recovery=rec), tsecure.SecureAggregation(g.adj, recovery=rec)
        assert t.needs_act == j.needs_act == rec
        assert t.stage_bytes_per_round(8, 128) == j.stage_bytes_per_round(8, 128)
        assert t.wire_dtype(torch.float32) == str(j.wire_dtype(np.float32))
        np.testing.assert_array_equal(t._nbr, j._nbr)
    assert (tsecure.METADATA_OVERHEAD, tsecure.SEED_SHARE_BYTES) == (
        jsecure.METADATA_OVERHEAD, jsecure.SEED_SHARE_BYTES)


@pytest.mark.parametrize("deg", [4.0, 3.5, np.float32(2.9230769), np.float32(3.25)])
def test_wire_bytes_as_the_reference_computes_them(deg):
    """A Python float degree multiplies in float64 on the host, an fp32
    degree as XLA compiles the reference's expression."""
    want = jax.jit(lambda d: d * 69_000 * 4 * (1.0 + jsecure.METADATA_OVERHEAD))(
        jnp.float32(deg)) if isinstance(deg, np.float32) else deg * 69_000 * 4 * 1.03
    assert float(np.float32(tsecure.wire_bytes(deg, 69_000, 4))) == float(np.float32(want))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

SECURE = {
    "secure": dict(secure=True),
    "secure-churn-recovery": dict(secure=True, participation=0.75, secure_recovery=True),
}


@pytest.fixture(scope="module", params=sorted(SECURE))
def secure_runs(request):
    over = SECURE[request.param]
    return over, jax_run({**WHOLE, **over}), jax_run({**REPLAY, **over})


def test_engine_tracks_jax_over_the_whole_run(secure_runs):
    over, want, _ = secure_runs
    eng, snaps = torch_run({**WHOLE, **over}, want["init"])
    assert_whole_run_tracks(eng, snaps, want)
    assert_run_metrics_match(eng, want)


def test_engine_share_steps_match_jax_round_by_round(secure_runs):
    """N=16, degree 4: the run's bytes, time and fault counters equal JAX's;
    each round's key words are JAX's, and the port's secure round from the
    JAX engine's inputs gives its output within 1e-6."""
    over, _, want = secure_runs
    cfg = {**REPLAY, **over}
    eng, _ = torch_run(cfg, want["init"])
    assert_run_metrics_match(eng, want)
    assert len(want["steps"]) == cfg["rounds"]
    if over.get("participation", 1.0) < 1.0:
        assert "recovery_bytes" in eng.history[-1]
        masks = eng.scheduler.participation_mask(0, cfg["rounds"])
    for X, W, key, degree, rnd, act, jX2, jbytes in want["steps"]:
        k = prng.fold_in(prng.key(0 + 17), int(rnd))  # the engine's key chain, seed 0
        np.testing.assert_array_equal(prng.key_data(k), key)
        tW = SparseTopology(W.nbr, W.w, W.w_self).to("cpu")
        kw = {}
        if act is not None:
            np.testing.assert_array_equal(act, masks[int(rnd)])
            kw["act"] = torch.tensor(act)
            degree = np.float32(degree)
        else:
            degree = float(degree)
        X2, _, nbytes = eng.sharing.round(torch.tensor(X), tW, (), k, degree, int(rnd), **kw)
        np.testing.assert_allclose(X2.numpy(), jX2, atol=1e-6, rtol=0)
        assert float(np.float32(nbytes)) == float(jbytes)
