"""The local and async schedulers of the port against the JAX package's.

Whole runs of both engines on the JAX fault tests' regression model
(``_torch_engine_parity`` ``model="tiny"``: 12 nodes, a 4-regular overlay,
the LAN model, 8 rounds in chunks of 4) from the same initial parameters:
``semantics="local"`` and ``"async"`` with both gossip forms, under
stragglers, iid and machine churn, the dynamic overlay, dense mixing and a
FaultPlan.  Parameters agree within 1e-5 after every eval; ``sim_time_s``
and the vclock values within rtol 1e-6; bytes, events, fired counts,
staleness and the fault counters are equal.  Then the reference's own
oracles on the port alone (local == sync trajectories, homogeneous async
== sync) and accept/reject parity of ``DLConfig.validate`` for every
semantics knob.
"""
import numpy as np
import pytest
import torch

from _torch_engine_parity import TINY, jax_run, torch_engine, torch_run
from repro.core import DLConfig as JDLConfig
from repro.core import FaultPlan as JFaultPlan
from repro_torch import DLConfig, FaultPlan

ST = dict(straggler_frac=0.25, straggler_factor=4.0)
PLAN = dict(msg_loss=0.2, latency_spike_prob=0.2, latency_spike_factor=5.0, corrupt_prob=0.2,
            seed=1)
PAIRWISE = dict(semantics="async", async_gossip="pairwise")

CASES = {
    "local stragglers": dict(semantics="local", **ST),
    "local churn": dict(semantics="local", participation=0.7, **ST),
    "local machines": dict(semantics="local", participation=0.7, churn_machines=3, **ST),
    "local dynamic": dict(semantics="local", topology="dynamic", **ST),
    "local no network": dict(semantics="local", network="none", **ST),
    "local faults": dict(semantics="local", faults=dict(PLAN, crashes=((3, 1, 3),))),
    "async stragglers": dict(semantics="async", **ST),
    "async churn": dict(semantics="async", participation=0.7, **ST),
    "async machines": dict(semantics="async", participation=0.7, churn_machines=3, **ST),
    "async dynamic": dict(semantics="async", topology="dynamic", participation=0.8, **ST),
    "async dense": dict(semantics="async", mixing="dense", participation=0.8, **ST),
    "async no network": dict(semantics="async", network="none", **ST),
    "async faults": dict(semantics="async", faults=dict(PLAN, crashes=((3, 1, 3),)), **ST),
    "async node keying": dict(semantics="async", batch_keying="node", async_slice_s=0.005, **ST),
    "pairwise stragglers": dict(PAIRWISE, **ST),
    "pairwise churn": dict(PAIRWISE, participation=0.8, **ST),
    "pairwise dynamic": dict(PAIRWISE, topology="dynamic", **ST),
    "pairwise faults": dict(PAIRWISE, faults=PLAN, participation=0.9, **ST),
}


def _assert_run_matches(eng, snaps, want):
    assert len(snaps) == len(want["snaps"]) == 3  # rounds 0, 4 and 7
    for got, ref in zip(snaps, want["snaps"]):
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert eng.bytes_sent == want["bytes_sent"] > 0
    assert eng.sim_time_s == pytest.approx(want["sim_time_s"], rel=1e-6)
    assert eng.sim_time_s > 0
    for h, jh in zip(eng.history, want["history"]):
        assert h.keys() == jh.keys()
        for k in jh:
            if k == "sim_time_s" or k.startswith("vclock"):
                assert h[k] == pytest.approx(jh[k], rel=1e-6), k
            elif k not in ("wall_s", "acc_mean", "acc_std"):
                assert h[k] == jh[k], k
    assert eng.scheduler._fault_totals == want["totals"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_scheduler_run_matches_jax(name):
    cfg = dict(TINY, **CASES[name])
    want = jax_run(cfg, model="tiny")
    eng, snaps = torch_run(cfg, want["init"], model="tiny")
    _assert_run_matches(eng, snaps, want)
    last = eng.history[-1]
    assert last["semantics"] == cfg["semantics"]
    if "faults" in cfg:
        assert last["faults_injected"] > 0
        assert last["faults_injected"] == last["faults_detected"] + last["faults_survived"]
        # the guard recovers every detection; a lost pairwise exchange is
        # detected and counts as recovered at the node's next success
        assert last["faults_recovered"] <= last["faults_detected"]
        if cfg.get("async_gossip") != "pairwise":
            assert last["faults_detected"] == last["faults_recovered"]
    if cfg["semantics"] == "async":
        assert 0 < last["events_total"] <= 12 * 8


def _tiny(**kw):
    return torch_engine(dict(TINY, **kw), None, model="tiny")


def test_local_trajectories_equal_sync_and_its_clock_is_bounded():
    """The reference's oracle: local semantics keeps sync's trajectory
    bitwise; with one straggler on a ring, the largest clock is at most
    sync's sum of round maxima and the median node finishes far sooner."""
    kw = dict(topology="ring", n_nodes=32, rounds=6, eval_every=5, straggler_factor=10.0,
              straggler_frac=0.03, compute_time_s=0.05)
    sync, local = _tiny(**kw), _tiny(semantics="local", **kw)
    sync.run(log=False)
    local.run(log=False)
    np.testing.assert_array_equal(sync.X.numpy(), local.X.numpy())
    assert local.bytes_sent == sync.bytes_sent
    assert local.sim_time_s <= sync.sim_time_s * (1 + 1e-6)
    rec = local.history[-1]
    assert rec["vclock_median_s"] < 0.5 * sync.sim_time_s
    assert rec["vclock_max_s"] == pytest.approx(local.sim_time_s)


def test_local_clock_runs_on_compute_time_without_a_network():
    e = _tiny(semantics="local", network="none", rounds=6, eval_every=5, compute_time_s=0.1,
              straggler_factor=10.0, straggler_frac=0.1)
    e.run(log=False)
    assert e.sim_time_s == pytest.approx(6 * 1.0, rel=1e-5)
    assert e.history[-1]["vclock_min_s"] >= 6 * 0.1 - 1e-6


def test_homogeneous_async_reduces_to_sync():
    """Homogeneous compute times and full participation: every event
    cohort is one synchronous round."""
    kw = dict(network="none", compute_time_s=0.1, seed=4)
    sync, asyn = _tiny(**kw), _tiny(semantics="async", **kw)
    sync.run(log=False)
    asyn.run(log=False)
    np.testing.assert_allclose(sync.X.numpy(), asyn.X.numpy(), rtol=1e-6, atol=1e-7)
    assert asyn.bytes_sent == pytest.approx(sync.bytes_sent, rel=1e-5)
    rec = asyn.history[-1]
    assert rec["events_min"] == rec["events_max"] == 8
    assert rec["staleness_mean"] == 0.0


def test_pairwise_partners_are_valid_neighbours():
    from repro_torch import prng
    from repro_torch.core.mixing import gossip_pair_avg
    from repro_torch.core.topology import SparseTopology

    topo = SparseTopology.regular_circulant(12, 4).to("cpu")
    X = torch.arange(12 * 3, dtype=torch.float32).reshape(12, 3)
    fire = torch.tensor([1.0, 0.0] * 6)
    X2, partner, ok = gossip_pair_avg(topo, X, prng.key(3), fire=fire)
    nbr = topo.nbr.long()
    for i in range(12):
        if ok[i]:
            assert int(partner[i]) in nbr[i].tolist()
            torch.testing.assert_close(X2[i], 0.5 * (X[i] + X[partner[i]]), rtol=0, atol=0)
        else:
            assert int(partner[i]) == i and torch.equal(X2[i], X[i])
    assert torch.equal(ok, fire)


# accept/reject parity of DLConfig.validate over the semantics knobs (the
# sharding rules are held to the reference in test_torch_shard_engine.py;
# backend='processes' in test_torch_runtime.py)
ACCEPT = {
    "local": dict(semantics="local"),
    "local dense": dict(semantics="local", topology="fully"),
    "local topk": dict(semantics="local", sharing="topk"),
    "local secure": dict(semantics="local", secure=True),
    "async": dict(semantics="async"),
    "async pairwise": dict(semantics="async", async_gossip="pairwise"),
    "async dense": dict(semantics="async", topology="fully"),
    "async slice": dict(semantics="async", async_slice_s=0.5),
    "async churn": dict(semantics="async", participation=0.5, churn_machines=2),
    "node keying": dict(batch_keying="node"),
    "node keying local": dict(batch_keying="node", semantics="local"),
    "cohort": dict(semantics="async", cohort_capacity=4, batch_keying="node"),
    "cohort hier": dict(semantics="async", cohort_capacity=4, batch_keying="node",
                        selection="hier", segment_size=3),
    "cohort int8": dict(semantics="async", cohort_capacity=4, batch_keying="node",
                        cold_dtype="int8"),
    "cohort bf16 pairwise": dict(semantics="async", cohort_capacity=16, batch_keying="node",
                                 cold_dtype="bf16", async_gossip="pairwise"),
    "async spread": dict(semantics="async", compute_time_s=0.1, compute_spread=2.0),
}
REJECT = {
    "unknown semantics": dict(semantics="eventual"),
    "unknown gossip": dict(semantics="async", async_gossip="ring"),
    "local legacy": dict(semantics="local", chunk_rounds=0),
    "async legacy": dict(semantics="async", chunk_rounds=0),
    "async secure": dict(semantics="async", secure=True),
    "async topk": dict(semantics="async", sharing="topk"),
    "async quant": dict(semantics="async", sharing="quant"),
    "pairwise dense": dict(semantics="async", async_gossip="pairwise", mixing="dense"),
    "pairwise star": dict(semantics="async", async_gossip="pairwise", topology="star"),
    "negative slice": dict(semantics="async", async_slice_s=-1.0),
    "cohort sync": dict(cohort_capacity=4, batch_keying="node"),
    "cohort local": dict(semantics="local", cohort_capacity=4, batch_keying="node"),
    "cohort stream": dict(semantics="async", cohort_capacity=4),
    "cohort too big": dict(semantics="async", cohort_capacity=17, batch_keying="node"),
    "cohort negative": dict(cohort_capacity=-1),
    "cohort dense": dict(semantics="async", cohort_capacity=4, batch_keying="node",
                         mixing="dense"),
    "cohort fully": dict(semantics="async", cohort_capacity=4, batch_keying="node",
                         topology="fully"),
    "unknown keying": dict(batch_keying="round"),
    "node keying legacy": dict(batch_keying="node", chunk_rounds=0),
    "unknown selection": dict(semantics="async", cohort_capacity=4, batch_keying="node",
                              selection="tree"),
    "hier without cohort": dict(selection="hier"),
    "segment without cohort": dict(segment_size=4),
    "negative segment": dict(semantics="async", cohort_capacity=4, batch_keying="node",
                             segment_size=-1),
    "unknown cold": dict(semantics="async", cohort_capacity=4, batch_keying="node",
                         cold_dtype="fp8"),
    "cold without cohort": dict(cold_dtype="bf16"),
    "spread without compute": dict(semantics="async", compute_spread=1.0),
}
FAULTS_REJECT = {
    "cohort faults": (dict(semantics="async", cohort_capacity=4, batch_keying="node"),
                      dict(msg_loss=0.1)),
    "local faults legacy": (dict(semantics="local", chunk_rounds=0), dict(corrupt_prob=0.1)),
}
FAULTS_ACCEPT = {
    "local faults": (dict(semantics="local"), dict(msg_loss=0.1, crashes=((1, 0, 2),))),
    "async faults": (dict(semantics="async"), dict(msg_loss=0.1, corrupt_prob=0.1)),
    "pairwise faults": (dict(semantics="async", async_gossip="pairwise"),
                        dict(msg_loss=0.1, latency_spike_prob=0.1)),
}


@pytest.mark.parametrize("name", sorted(ACCEPT))
def test_validate_accepts_what_the_reference_accepts(name):
    JDLConfig(**ACCEPT[name]).validate()
    DLConfig(**ACCEPT[name]).validate()


@pytest.mark.parametrize("name", sorted(REJECT))
def test_validate_rejects_what_the_reference_rejects(name):
    with pytest.raises(ValueError):
        JDLConfig(**REJECT[name]).validate()
    with pytest.raises(ValueError):
        DLConfig(**REJECT[name]).validate()


@pytest.mark.parametrize("name", sorted(FAULTS_ACCEPT))
def test_validate_accepts_the_reference_fault_paths(name):
    knobs, plan = FAULTS_ACCEPT[name]
    JDLConfig(faults=JFaultPlan(**plan), **knobs).validate()
    DLConfig(faults=FaultPlan(**plan), **knobs).validate()


@pytest.mark.parametrize("name", sorted(FAULTS_REJECT))
def test_validate_rejects_the_reference_fault_paths(name):
    knobs, plan = FAULTS_REJECT[name]
    with pytest.raises(ValueError):
        JDLConfig(faults=JFaultPlan(**plan), **knobs).validate()
    with pytest.raises(ValueError):
        DLConfig(faults=FaultPlan(**plan), **knobs).validate()


def test_engine_rejects_pairwise_and_cohort_on_dense_mixing():
    """A graph that resolves to dense mixing (a complete regular graph)
    passes ``validate`` but the engine refuses pairwise gossip and the
    cohort path on it, as the reference's engine does."""
    for kw in (dict(PAIRWISE), dict(semantics="async", cohort_capacity=4,
                                    batch_keying="node")):
        with pytest.raises(ValueError, match="dense mixing"):
            _tiny(n_nodes=6, degree=5, **kw)
