"""Port parity: the fault module (``core/faults.py``) and the edge
reweights of ``core/sharing.py`` against the JAX package, from numpy
inputs and seeds, and ``DLConfig.validate`` on fault plans.

Tolerances: plans accepted and rejected alike; crash masks, fault draws
(sparse and dense forms, at thresholds between adjacent fp32 values),
corruption bit patterns, non-finite detection, reweighted tables and the
re-admission round trip bitwise; the simulated round time under latency
spikes within rtol 1e-6 (fp32 on both sides, another operation order).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import DLConfig as JDLConfig
from repro.core import FaultPlan as JFaultPlan
from repro.core import faults as jfaults
from repro.core import steps as jsteps
from repro.core.network import paper_testbed as jtestbed
from repro.core.sharing import edge_reweight as jedge_reweight
from repro.core.sharing import edge_reweight_sparse as jedge_reweight_sparse
from repro.core.topology import Graph as JGraph
from repro.core.topology import SparseTopology as JSparse
from repro_torch import DLConfig, FaultPlan, prng
from repro_torch.core import faults as tfaults
from repro_torch.core import sharing as tsharing
from repro_torch.core import steps as tsteps
from repro_torch.core.network import paper_testbed
from repro_torch.core.topology import SparseTopology

BAD_PLANS = [
    dict(msg_loss=1.0),
    dict(msg_loss=-0.1),
    dict(latency_spike_prob=1.0),
    dict(latency_spike_factor=0.0),
    dict(corrupt_prob=1.5),
    dict(corrupt_mode="zap"),
    dict(retry_backoff_s=-1e-3),
    dict(retry_backoff_cap=-1),
    dict(crashes=((0, 2),)),
    dict(crashes=((-1, 2, 5),)),
    dict(crashes=((0, -2, 5),)),
    dict(crashes=((0, 5, 5),)),
    dict(crashes=((0, 5, 2),)),
]


@pytest.mark.parametrize("kw", BAD_PLANS, ids=lambda kw: f"{next(iter(kw))}={next(iter(kw.values()))}")
def test_bad_plans_rejected_as_the_reference_rejects_them(kw):
    with pytest.raises(ValueError, match="invalid FaultPlan"):
        JFaultPlan(**kw).validate()
    with pytest.raises(ValueError, match="invalid FaultPlan"):
        FaultPlan(**kw).validate()


def test_good_plan_and_axis_flags_match():
    kw = dict(msg_loss=0.5, latency_spike_prob=0.1, corrupt_prob=0.01,
              crashes=((0, 2, 5), (3, 1, -1)))
    p = FaultPlan(**kw)
    assert p.validate() is p
    for kw in ({}, dict(msg_loss=0.1), dict(latency_spike_prob=0.1), dict(corrupt_prob=0.1),
               dict(crashes=((0, 1, 2),))):
        j, t = JFaultPlan(**kw), FaultPlan(**kw)
        assert (t.edge_faults, t.any_faults) == (j.edge_faults, j.any_faults)
    assert [f.name for f in __import__("dataclasses").fields(FaultPlan)] == [
        f.name for f in __import__("dataclasses").fields(JFaultPlan)]
    assert tfaults.STAT_KEYS == jfaults.STAT_KEYS
    assert tfaults.zero_stats() == {k: 0.0 for k in jfaults.STAT_KEYS}


# DLConfig combinations with a fault plan: (knobs, faults kwargs); n_nodes 12
REJECTED = {
    "bad plan": ({}, dict(msg_loss=1.0)),
    "crash node out of range": ({}, dict(crashes=((12, 1, 3),))),
    "chunk_rounds 0": (dict(chunk_rounds=0), dict(msg_loss=0.1)),
    "secure with msg_loss": (dict(secure=True, secure_recovery=True), dict(msg_loss=0.1)),
    "secure crashes without recovery": (dict(secure=True), dict(crashes=((1, 1, 3),))),
    "cohort path": (dict(cohort_capacity=4, semantics="async"), dict(msg_loss=0.1)),
}
ACCEPTED = {
    "local semantics": (dict(semantics="local"), dict(msg_loss=0.1)),
    "async semantics": (dict(semantics="async"), dict(msg_loss=0.1)),
    "loss, spikes, corruption, crashes": (dict(participation=0.9), dict(
        msg_loss=0.1, latency_spike_prob=0.05, corrupt_prob=0.05, crashes=((3, 2, 5),))),
    "dense mixing": (dict(mixing="dense"), dict(msg_loss=0.2)),
    "secure with recovery": (dict(secure=True, secure_recovery=True), dict(
        crashes=((1, 1, 3),), latency_spike_prob=0.1, corrupt_prob=0.1)),
    **{f"churn {s}": (dict(sharing=s, participation=0.7, payload_quant=s == "topk"),
                      dict(msg_loss=0.1)) for s in ("topk", "choco", "randomk", "quant")},
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_dlconfig_rejects_what_the_reference_rejects(name):
    knobs, plan = REJECTED[name]
    with pytest.raises(ValueError):
        JDLConfig(n_nodes=12, faults=JFaultPlan(**plan), **knobs).validate()
    with pytest.raises(ValueError):
        DLConfig(n_nodes=12, faults=FaultPlan(**plan), **knobs).validate()


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_dlconfig_accepts_what_the_reference_accepts(name):
    knobs, plan = ACCEPTED[name]
    JDLConfig(n_nodes=12, faults=JFaultPlan(**plan), **knobs).validate()
    DLConfig(n_nodes=12, faults=FaultPlan(**plan), **knobs).validate()


@pytest.mark.parametrize("knobs,item", [(dict(shard_devices=2), 6)])
def test_unported_fault_paths_raise_not_implemented(knobs, item):
    """Faults under node sharding (ROADMAP Queue 1 item 6, ported): both
    packages refuse them with ``ValueError`` (faults are single-host)."""
    for cfg, plan in ((JDLConfig, JFaultPlan), (DLConfig, FaultPlan)):
        with pytest.raises(ValueError, match="single-host"):
            cfg(n_nodes=12, faults=plan(msg_loss=0.1), **knobs).validate()


PLAN = dict(crashes=((3, 2, 5), (7, 4, -1), (0, 0, 1)))


def test_crash_mask_bitwise_and_chunk_slice_invariant():
    want = jfaults.crash_mask(JFaultPlan(**PLAN), 8, 0, 9)
    got = tfaults.crash_mask(FaultPlan(**PLAN), 8, 0, 9)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 3], [1, 1, 0, 0, 0, 1, 1, 1, 1])
    parts = np.vstack([tfaults.crash_mask(FaultPlan(**PLAN), 8, s, r)
                       for s, r in ((0, 3), (3, 1), (4, 5))])
    np.testing.assert_array_equal(parts, got)


def test_fault_key_words_equal():
    for seed, eng_seed in ((0, 0), (7, 3), (123, 99)):
        want = np.asarray(jax.random.key_data(jfaults.fault_key(JFaultPlan(seed=seed), eng_seed)))
        np.testing.assert_array_equal(prng.key_data(tfaults.fault_key(FaultPlan(seed=seed),
                                                                      eng_seed)), want)


@pytest.mark.parametrize("d", [4, 13], ids=["slots", "dense"])
@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2**16), st.integers(0, 50), st.sampled_from([0.05, 0.3, 0.7]))
def test_edge_draws_and_corruption_mask_bitwise(d, seed, rnd, p):
    kw = dict(msg_loss=p, latency_spike_prob=1 - p, corrupt_prob=p / 2, seed=seed)
    jkey = jfaults.fault_key(JFaultPlan(**kw), 5)
    tkey = tfaults.fault_key(FaultPlan(**kw), 5)
    jl, js = jfaults.edge_draws(jkey, rnd, jnp.arange(13), d, JFaultPlan(**kw))
    tl, ts = tfaults.edge_draws(tkey, rnd, torch.arange(13), d, FaultPlan(**kw))
    assert tl.dtype == torch.float32 and tl.shape == (13, d)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tfaults.corruption_mask(tkey, rnd, torch.arange(13), FaultPlan(**kw)).numpy(),
        np.asarray(jfaults.corruption_mask(jkey, rnd, jnp.arange(13), JFaultPlan(**kw))))
    # a row subset draws the full draw's rows
    rows = [2, 9, 11]
    sub, _ = tfaults.edge_draws(tkey, rnd, torch.tensor(rows), d, FaultPlan(**kw))
    np.testing.assert_array_equal(sub.numpy(), tl.numpy()[rows])


def test_thresholds_between_adjacent_fp32_values_compare_in_fp32():
    """A threshold a quarter ulp above a drawn uniform rounds to it in fp32:
    the reference compares against the fp32 value, so that message stays
    live (u >= t) and does not spike (u < t is false)."""
    key = tfaults.fault_key(FaultPlan(seed=1), 0)
    u = prng.uniform(tfaults._row_keys(key, tfaults._TAG_EDGE, 4, torch.arange(6)), (5,))
    us = prng.uniform(tfaults._row_keys(key, tfaults._TAG_SPIKE, 4, torch.arange(6)), (5,))
    for uu, field in ((u, "msg_loss"), (us, "latency_spike_prob")):
        u0 = float(uu[2, 3])
        t = u0 + float(np.spacing(np.float32(u0))) / 4
        assert np.float32(t) == np.float32(u0) and t > u0
        kw = {field: t, "seed": 1}
        jl, js = jfaults.edge_draws(jfaults.fault_key(JFaultPlan(**kw), 0), 4, jnp.arange(6), 5,
                                    JFaultPlan(**kw))
        tl, ts = tfaults.edge_draws(key, 4, torch.arange(6), 5, FaultPlan(**kw))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        got = (tl if field == "msg_loss" else 1.0 - ts)[2, 3]
        assert got == 1.0


@pytest.mark.parametrize("mode", ["nan", "bitflip"])
def test_corrupt_rows_bit_patterns_and_detection(mode):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(6, 9)).astype(np.float32)
    X[0, :3] = [0.0, -0.0, np.inf]
    cmask = np.array([1, 0, 1, 0, 0, 1], np.float32)
    want = np.asarray(jfaults.corrupt_rows(jnp.asarray(X), jnp.asarray(cmask), mode))
    got = tfaults.corrupt_rows_(torch.tensor(X), torch.tensor(cmask), mode).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(tfaults.nonfinite_rows(torch.tensor(got)).numpy(), cmask)
    np.testing.assert_array_equal(
        tfaults.nonfinite_rows(torch.tensor(got)).numpy(),
        np.asarray(jfaults.nonfinite_rows(jnp.asarray(want))))


def test_retry_backoff_delay_both_forms():
    r = np.arange(10, dtype=np.float32)
    want = np.asarray(jfaults.retry_backoff_delay(jnp.asarray(r), 1e-3, 6))
    np.testing.assert_array_equal(tfaults.retry_backoff_delay(torch.tensor(r), 1e-3, 6).numpy(),
                                  want)
    assert [tfaults.retry_backoff_delay(k, 1e-3, 6) for k in range(10)] == [
        jfaults.retry_backoff_delay(k, 1e-3, 6) for k in range(10)]


def _tables(n=12, d=4):
    st = JSparse.regular_circulant(n, d)
    jt = JSparse(jnp.asarray(st.nbr), jnp.asarray(st.w), jnp.asarray(st.w_self))
    return st, jt, SparseTopology(st.nbr, st.w, st.w_self).to("cpu")


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_edge_reweights_bitwise_and_rows_stochastic(seed):
    rng = np.random.default_rng(seed)
    st_, jt, tt = _tables()
    live = (rng.random(st_.w.shape) > rng.random()).astype(np.float32)
    jw = jedge_reweight_sparse(jt, jnp.asarray(live))
    tw = tsharing.edge_reweight_sparse(tt, torch.tensor(live))
    np.testing.assert_array_equal(tw.w.numpy(), np.asarray(jw.w))
    np.testing.assert_array_equal(tw.w_self.numpy(), np.asarray(jw.w_self))
    # a new object whose merge tables carry the new weights; the input's
    # cached tables are untouched
    rows, ws = tw.merge_tables()
    np.testing.assert_array_equal(ws.numpy()[:, 1:], np.asarray(jw.w))
    np.testing.assert_array_equal(tt.merge_tables()[1].numpy()[:, 1:], st_.w)
    assert tw is not tt and rows is tt.merge_tables()[0]
    W = JGraph.regular_circulant(12, 4).metropolis_hastings().astype(np.float32)
    dlive = (rng.random((12, 12)) > rng.random()).astype(np.float32)
    jW = np.asarray(jedge_reweight(jnp.asarray(W), jnp.asarray(dlive)))
    tW = tsharing.edge_reweight(torch.tensor(W), torch.tensor(dlive)).numpy()
    np.testing.assert_array_equal(tW, jW)
    np.testing.assert_allclose(tW.sum(1), 1.0, atol=1e-6)
    off = ~np.eye(12, dtype=bool)
    assert (tW >= 0).all() and (tW[off & (dlive == 0)] == 0).all()
    np.testing.assert_allclose(tw.w_self.numpy() + tw.w.numpy().sum(1), 1.0, atol=1e-6)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10_000))
def test_edge_readmit_round_trip_returns_the_pristine_object(seed):
    rng = np.random.default_rng(seed)
    st_, _, tt = _tables()
    nbr = st_.nbr
    for dead in [set(rng.choice(12, size=rng.integers(1, 6), replace=False)) for _ in range(3)] + [set()]:
        alive = np.ones(12, np.float32)
        alive[list(dead)] = 0.0
        eff = tsharing.edge_readmit_sparse(tt, alive[nbr])
        if not dead:
            assert eff is tt
            continue
        ref = tsharing.edge_reweight_sparse(tt, torch.tensor(alive[nbr]))
        np.testing.assert_array_equal(eff.w.numpy(), ref.w.numpy())
        np.testing.assert_array_equal(eff.w_self.numpy(), ref.w_self.numpy())
        kept = (alive[nbr] > 0) & (st_.w > 0)
        np.testing.assert_array_equal(eff.w.numpy()[kept], st_.w[kept])


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("parallel", [False, True], ids=["serial", "nic"])
def test_round_time_with_latency_spikes_matches(dense, parallel):
    n = 12
    st_, jt, tt = _tables(n)
    lat, gp = paper_testbed(n).matrices()
    jlat, jgp = jtestbed(n).matrices()
    ct = np.linspace(0.01, 0.05, n).astype(np.float32)
    plan = dict(latency_spike_prob=0.4, latency_spike_factor=7.0, seed=2)
    d = n if dense else st_.nbr.shape[1]
    _, spike = jfaults.edge_draws(jfaults.fault_key(JFaultPlan(**plan), 0), 3, jnp.arange(n),
                                  d, JFaultPlan(**plan))
    mult = 1.0 + np.asarray(spike) * (7.0 - 1.0)
    act = (np.arange(n) % 5 != 2).astype(np.float32)
    W = JGraph.regular_circulant(n, 4).metropolis_hastings().astype(np.float32)
    jW = jnp.asarray(W) if dense else jt
    tW = torch.tensor(W) if dense else tt
    js = types.SimpleNamespace(lat=jnp.asarray(jlat), goodput=jnp.asarray(jgp),
                               compute_node=jnp.asarray(ct), parallel_sends=parallel)
    want = float(jsteps.RoundSteps.round_time(js, jW, jnp.asarray(act), jnp.float32(4e6), 3.5,
                                              lat_mult=jnp.asarray(mult)))
    ts = types.SimpleNamespace(lat=torch.tensor(lat), goodput=torch.tensor(gp),
                               compute_node=torch.tensor(ct), parallel_sends=parallel)
    got = float(tsteps.RoundSteps.round_time(ts, tW, 4e6, 3.5, torch.tensor(act),
                                             torch.tensor(mult, dtype=torch.float32)))
    plain = float(tsteps.RoundSteps.round_time(ts, tW, 4e6, 3.5, torch.tensor(act)))
    assert got == pytest.approx(want, rel=1e-6) and got > plain
