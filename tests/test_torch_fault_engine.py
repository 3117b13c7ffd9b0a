"""Port parity: whole engine runs with fault injection against the JAX
RoundEngine, on the JAX fault tests' 8-parameter regression model
(``_torch_engine_parity`` ``model="tiny"``: 12 nodes of degree 4, LAN
model, 8 rounds in chunks of 4): message loss on the sparse and on the
dense mixing operand, crash windows with churn, corruption in both modes
with the rollback guard, latency spikes, and secure aggregation with
crash windows, seed recovery, spikes and corruption.

Tolerances: parameters within 1e-4 after every eval, bytes equal,
``sim_time_s`` within rtol 1e-6, the six fault counters and the history
keys equal (``_torch_engine_parity.assert_run_metrics_match``).
"""
import numpy as np
import pytest

from _torch_engine_parity import (
    TINY,
    assert_run_metrics_match,
    jax_run,
    torch_run,
)
from repro_torch.core.faults import STAT_KEYS

CASES = {
    "loss-sparse": dict(faults=dict(msg_loss=0.3, seed=1)),
    "loss-dense": dict(faults=dict(msg_loss=0.3, seed=1), mixing="dense"),
    "crashes-churn": dict(faults=dict(crashes=((3, 2, 5), (7, 4, -1))), participation=0.8),
    "corrupt-nan": dict(faults=dict(corrupt_prob=0.2, corrupt_mode="nan", seed=2)),
    "corrupt-bitflip": dict(faults=dict(corrupt_prob=0.2, corrupt_mode="bitflip", seed=2)),
    "spikes": dict(faults=dict(latency_spike_prob=0.5, latency_spike_factor=10.0, seed=4)),
    "secure-crashes": dict(faults=dict(crashes=((3, 2, 5),), latency_spike_prob=0.2,
                                       corrupt_prob=0.1, seed=5),
                           secure=True, secure_recovery=True, participation=0.9),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def fault_run(request):
    cfg = {**TINY, **CASES[request.param]}
    want = jax_run(cfg, model="tiny")
    eng, snaps = torch_run(cfg, want["init"], model="tiny")
    return request.param, cfg, want, eng, snaps


def test_parameters_track_jax_after_every_eval(fault_run):
    _, _, want, eng, snaps = fault_run
    assert len(snaps) == len(want["snaps"]) == 3  # rounds 0, 4, 7
    for got, ref in zip(snaps, want["snaps"]):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert np.isfinite(eng.X.numpy()).all()


def test_bytes_time_counters_and_history_match_jax(fault_run):
    _, _, want, eng, _ = fault_run
    assert_run_metrics_match(eng, want)
    assert eng.scheduler._fault_totals == pytest.approx(want["totals"], abs=0)
    assert set(STAT_KEYS) <= set(eng.history[-1])


def test_counters_conserve_and_name_the_injected_faults(fault_run):
    name, _, _, eng, _ = fault_run
    t = eng.scheduler._fault_totals
    assert t["faults_injected"] == t["faults_detected"] + t["faults_survived"] > 0
    assert t["faults_recovered"] == t["faults_detected"]
    assert t["retry_total"] == 0
    if name.startswith("corrupt"):
        assert t["faults_detected"] == t["faults_injected"]
    elif name == "crashes-churn":  # node 3 down in rounds 2-4, node 7 from round 4
        assert t["faults_injected"] == t["faults_survived"] == 7
    elif name != "secure-crashes":
        assert t["faults_detected"] == 0
    assert (t["recovery_bytes"] > 0) == (name == "secure-crashes")


@pytest.mark.parametrize("name", ["loss-sparse", "corrupt-nan", "secure-crashes"])
def test_port_counters_and_trajectory_do_not_depend_on_the_chunking(name):
    cfg = {**TINY, **CASES[name]}
    runs = [torch_run({**cfg, "chunk_rounds": c}, None, model="tiny") for c in (1, 4)]
    (e1, s1), (e4, s4) = runs
    assert e1.scheduler._fault_totals == e4.scheduler._fault_totals
    assert e1.bytes_sent == e4.bytes_sent and e1.sim_time_s == pytest.approx(e4.sim_time_s,
                                                                            rel=1e-12)
    np.testing.assert_array_equal(s1[-1], s4[-1])
