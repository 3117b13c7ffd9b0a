"""Port parity: the dynamic overlay (``topology="dynamic"``, a new random
d-regular graph every round from ``PeerSampler``) through the whole
engine, against the JAX engine at N=8, degree 5: sparse tables and the
dense W stack, with full participation and under churn (participation
0.9).

Tolerances: each round's mixing operand and the churn degree bitwise;
parameters and metrics as ``_torch_engine_parity`` says.
"""
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)

from _torch_engine_parity import (
    WHOLE,
    assert_run_metrics_match,
    assert_whole_run_tracks,
    jax_run,
    torch_engine,
    torch_run,
)
from repro_torch.core.topology import SparseTopology

RUNS = {
    "sparse": dict(topology="dynamic"),
    "sparse-churn": dict(topology="dynamic", participation=0.9),
    "dense": dict(topology="dynamic", mixing="dense"),
    "dense-churn": dict(topology="dynamic", mixing="dense", participation=0.9),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def dynamic_run(request):
    cfg = {**WHOLE, **RUNS[request.param]}
    return cfg, jax_run(cfg)


def test_dynamic_engine_tracks_jax_over_the_whole_run(dynamic_run):
    cfg, want = dynamic_run
    eng, snaps = torch_run(cfg, want["init"])
    assert eng.graph is None and eng.sampler is not None
    assert_whole_run_tracks(eng, snaps, want)
    assert_run_metrics_match(eng, want)


def test_dynamic_operands_are_each_rounds_own(dynamic_run):
    """Each round's operand, as the scheduler stages it, is the JAX
    engine's operand of that round bitwise (after the churn reweight, with
    the same degree); the rounds' tables differ."""
    cfg, want = dynamic_run
    eng = torch_engine(cfg, want["init"])
    ops = eng.scheduler.stage_topology(0, cfg["rounds"])
    masks = eng.scheduler.participation_mask(0, cfg["rounds"])
    tables = []
    churn = cfg.get("participation", 1.0) < 1.0
    for X, W, kd, degree, rnd, _, jX2, jbytes in want["steps"]:
        Wr, live = ops[int(rnd)]
        a = (torch.tensor(masks[int(rnd)]), masks[int(rnd)]) if churn else None
        Wm, deg, _, _ = eng.steps.share_operands(Wr, int(rnd), a, live)
        assert np.float32(deg) == np.float32(degree)
        if isinstance(Wm, SparseTopology):
            for f in ("nbr", "w", "w_self"):
                np.testing.assert_array_equal(getattr(Wm, f).numpy(), getattr(W, f))
            tables.append(Wr.merge_tables()[0].numpy())
        else:
            np.testing.assert_array_equal(Wm.numpy(), W)
            tables.append(Wr.numpy())
        X2, _, nbytes = eng.sharing.round(torch.tensor(X), Wm, (), None, deg, int(rnd))
        np.testing.assert_allclose(X2.numpy(), jX2, atol=1e-6, rtol=0)
        assert np.float32(nbytes) == jbytes
    assert len(tables) == cfg["rounds"]
    assert not all(np.array_equal(tables[0], t) for t in tables[1:])


def test_dense_dynamic_spans_are_capped(monkeypatch):
    """The dense form stages an (R, N, N) stack per span under a byte cap:
    a cap of one round's W makes every span one round; the staged peak is
    the largest span's bytes (nbr, w and w_self for the sparse form)."""
    from repro_torch.core import engine as tengine

    monkeypatch.setattr(tengine, "_W_STACK_BYTES_CAP", 4 * 8 * 8)
    dense = torch_engine({**WHOLE, **RUNS["dense"]}, None)
    assert dense.chunk == 1 and dense.topo_stage_bytes_peak == 0
    dense.scheduler.stage_topology(0, dense.chunk)
    assert dense.topo_stage_bytes_peak == 4 * 8 * 8
    sparse = torch_engine({**WHOLE, **RUNS["sparse"]}, None)
    assert sparse.chunk == WHOLE["chunk_rounds"]
    sparse.scheduler.stage_topology(0, 2)
    assert sparse.topo_stage_bytes_peak == 2 * (8 * 5 * 4 * 2 + 8 * 4)
