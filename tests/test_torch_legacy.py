"""The legacy per-round dispatch (``chunk_rounds=0``) of the port.

The JAX package keeps its pre-scan round program as ``chunk_rounds=0``:
``SyncScheduler.run_legacy_round`` gathers each round's batches on the
host, makes one ``train_and_mix`` call and reads the round's metrics back
at once.  It is the oracle its scanned scheduler is held against
(``tests/test_scheduler.py`` ``SCENARIOS``).  Here, on the JAX fault
tests' regression model (``_torch_engine_parity`` ``model="tiny"``: 12
nodes, 8 rounds, the LAN model) from the same initial parameters:

* the reference's five scenarios at ``chunk_rounds=0`` in both packages:
  parameters within rtol 2e-5 / atol 1e-6, bytes and sim time within
  rel 1e-6, the history's rounds equal;
* the port's legacy run against its own chunk-1 run, bitwise (the same
  draws reach the same kernels in the same order), the dynamic overlay
  and secure aggregation with recovery under churn included;
* ``eng.chunk == 0``, the eval cadence, checkpoints, and the refusal of
  the local and async semantics.
"""
import numpy as np
import pytest
import torch

from _torch_engine_parity import TINY, jax_run, torch_engine
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)
from repro_torch import DLConfig
from repro_torch.utils import tree_map

# tests/test_scheduler.py SCENARIOS
SCENARIOS = {
    "dense": dict(topology="fully"),
    "sparse": dict(topology="regular", degree=4),
    "payload": dict(topology="regular", degree=4, sharing="randomk", budget=0.25, payload="on"),
    "secure": dict(topology="regular", degree=4, secure=True),
    "churn": dict(topology="regular", degree=4, participation=0.6),
}
# where the per-round operands differ most from a span's staging
MORE = {
    "dynamic": dict(topology="dynamic", degree=4),
    "dynamic dense churn": dict(topology="dynamic", degree=4, mixing="dense", participation=0.7),
    "secure recovery churn": dict(topology="regular", degree=4, secure=True,
                                  secure_recovery=True, participation=0.7),
    "machine churn topk": dict(topology="regular", degree=4, sharing="topk", budget=0.25,
                               participation=0.7, churn_machines=3),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_legacy_run_matches_jax_legacy(name):
    cfg = dict(TINY, chunk_rounds=0, **SCENARIOS[name])
    want = jax_run(cfg, model="tiny")
    eng = torch_engine(cfg, want["init"], model="tiny")
    eng.run(log=False)
    assert eng.chunk == 0
    np.testing.assert_allclose(eng.X.numpy(), want["X"], rtol=2e-5, atol=1e-6)
    assert eng.bytes_sent == pytest.approx(want["bytes_sent"], rel=1e-6)
    assert eng.bytes_sent > 0
    assert eng.sim_time_s == pytest.approx(want["sim_time_s"], rel=1e-6)
    assert [h["round"] for h in eng.history] == [h["round"] for h in want["history"]]
    for h, jh in zip(eng.history, want["history"]):
        assert h["bytes_per_node"] == pytest.approx(jh["bytes_per_node"], rel=1e-6)


def _runs(cfg):
    out = []
    for chunk in (0, 1):
        eng = torch_engine(dict(cfg, chunk_rounds=chunk), None, model="tiny")
        eng.run(log=False)
        out.append(eng)
    return out


def _without_wall(history):
    return [{k: v for k, v in h.items() if k != "wall_s"} for h in history]


@pytest.mark.parametrize("name", sorted(SCENARIOS) + sorted(MORE))
def test_legacy_run_is_bitwise_the_chunk_one_run(name):
    legacy, span = _runs(dict(TINY, **{**SCENARIOS, **MORE}[name]))
    assert (legacy.chunk, span.chunk) == (0, 1)
    assert torch.equal(legacy.X, span.X)
    assert legacy.bytes_sent == span.bytes_sent > 0
    assert legacy.sim_time_s == span.sim_time_s > 0
    assert _without_wall(legacy.history) == _without_wall(span.history)
    assert legacy.scheduler._fault_totals == span.scheduler._fault_totals
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             legacy.share_state, span.share_state)


def test_legacy_dispatch_runs_one_round_a_call_and_keeps_the_cadence(monkeypatch):
    """The reference's ``TestLegacyPath``: chunk 0, evals at rounds 0 and
    3 of 4 with ``eval_every=3``; every round is one legacy call."""
    eng = torch_engine(dict(TINY, chunk_rounds=0, rounds=4, eval_every=3), None, model="tiny")
    assert eng.chunk == 0
    called = []
    legacy = eng.scheduler.run_legacy_round
    monkeypatch.setattr(eng.scheduler, "run_legacy_round",
                        lambda rnd: (called.append(rnd), legacy(rnd)))
    monkeypatch.setattr(eng.scheduler, "run_span", None)
    hist = eng.run(log=False)
    assert called == [0, 1, 2, 3]
    assert [h["round"] for h in hist] == [0, 3]
    assert eng.bytes_sent > 0


def test_legacy_checkpoint_resumes_the_run(tmp_path):
    cfg = dict(TINY, chunk_rounds=0, rounds=6, eval_every=2, participation=0.7)
    whole = torch_engine(cfg, None, model="tiny")
    whole.run(log=False)
    first = torch_engine(dict(cfg, rounds=3), None, model="tiny")
    first.run(log=False)
    first.save_state(str(tmp_path))
    resumed = torch_engine(cfg, None, model="tiny")
    assert resumed.load_state(str(tmp_path)) == 3
    resumed.run(log=False)
    assert torch.equal(resumed.X, whole.X)
    assert [h["round"] for h in resumed.history] == [4, 5]  # eval_every=2 and the last


@pytest.mark.parametrize("semantics", ["local", "async"])
def test_legacy_dispatch_is_synchronous_only(semantics):
    with pytest.raises(ValueError, match="chunk_rounds > 0"):
        DLConfig(**dict(TINY, chunk_rounds=0, semantics=semantics)).validate()
    # the scheduler refuses it too, with the reference's message
    eng = torch_engine(dict(TINY, semantics=semantics), None, model="tiny")
    with pytest.raises(ValueError, match="supports semantics='sync' only"):
        eng.scheduler.run_legacy_round(0)
