"""Port parity: churn (per-round participation masks) against the JAX
package: the scheduler's masks, the sharing module's reweights, the step
layer's masked local training and seed-recovery bytes, and whole engine
runs of full sharing under machine-level churn on the sparse and the dense
mixing operand.

Tolerances: masks, reweighted operands, degrees and recovery bytes bitwise;
masked local steps within 1e-6 (one SGD step of a smooth loss); the engine
runs as ``_torch_engine_parity`` says.
"""
import types

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
from repro.core import DLConfig as JDLConfig
from repro.core import scheduler as jscheduler
from repro.core import secure as jsecure
from repro.core import steps as jsteps
from repro.core.sharing import participation_reweight as jreweight
from repro.core.sharing import participation_reweight_sparse as jreweight_sparse
from repro.core.topology import Graph as JGraph
from repro.core.topology import SparseTopology as JSparse
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import DLConfig
from repro_torch.core import scheduler as tscheduler
from repro_torch.core import secure as tsecure
from repro_torch.core import sharing as tsharing
from repro_torch.core import steps as tsteps
from repro_torch.core.topology import SparseTopology
from repro_torch.optim import make_optimizer


@pytest.mark.parametrize("machines", [0, 4, 7])
@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2**20))
def test_participation_mask_bitwise(machines, seed):
    """The splitmix64 masks equal JAX's, node- and machine-level, at
    participation rates down to where the keep-one-alive draw fires, and do
    not depend on where a chunk starts."""
    for p in (0.75, 0.3, 0.02, 1.0):
        cfg = dict(n_nodes=13, participation=p, churn_machines=machines, seed=seed)
        want = jscheduler.Scheduler.participation_mask(
            jscheduler.Scheduler(types.SimpleNamespace(dl=JDLConfig(**cfg))), 5, 9)
        sched = tscheduler.SyncScheduler(types.SimpleNamespace(dl=DLConfig(**cfg)))
        got = sched.participation_mask(5, 9)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            np.concatenate([sched.participation_mask(5, 4), sched.participation_mask(9, 5)]), got)
        assert (got.sum(1) >= 1).all()


def _graphs():
    yield JGraph.regular_circulant(16, 4)
    yield JGraph.random_regular(12, 3, 5)
    yield JGraph.star(9)


@pytest.mark.parametrize("gi", [0, 1, 2])
@settings(max_examples=4, deadline=None)
@given(st.integers(0, 10_000))
def test_reweights_bitwise_and_degree_equal(gi, seed):
    g = list(_graphs())[gi]
    n = g.n
    act = (np.random.default_rng(seed).random(n) > 0.35).astype(np.float32)
    W = g.metropolis_hastings().astype(np.float32)
    jW, jdeg = jreweight(jnp.asarray(W), jnp.asarray(act))
    tW = tsharing.participation_reweight(torch.tensor(W), torch.tensor(act))
    np.testing.assert_array_equal(tW.numpy(), np.asarray(jW))
    off = W * (1 - np.eye(n, dtype=np.float32)) > 0
    deg = tsharing.participation_deg_eff(None, off, act)
    assert isinstance(deg, np.float32) and deg == np.asarray(jdeg)
    st_ = JSparse.from_graph(g)
    jst, jdeg2 = jreweight_sparse(
        JSparse(jnp.asarray(st_.nbr), jnp.asarray(st_.w), jnp.asarray(st_.w_self)), jnp.asarray(act))
    tst = tsharing.participation_reweight_sparse(
        SparseTopology(st_.nbr, st_.w, st_.w_self).to("cpu"), torch.tensor(act))
    np.testing.assert_array_equal(tst.w.numpy(), np.asarray(jst.w))
    np.testing.assert_array_equal(tst.w_self.numpy(), np.asarray(jst.w_self))
    assert tsharing.participation_deg_eff(st_.nbr, st_.w > 0, act) == np.asarray(jdeg2) == jdeg


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000))
def test_secure_recovery_bytes_equal(seed):
    g = JGraph.random_regular(14, 4, seed % 7)
    act = (np.random.default_rng(seed).random(14) > 0.3).astype(np.float32)
    want = jsteps.RoundSteps._secure_recovery_bytes(
        types.SimpleNamespace(sharing=jsecure.SecureAggregation(g.adj)), jnp.asarray(act))
    got = tsteps.RoundSteps._secure_recovery_bytes(
        types.SimpleNamespace(sharing=tsecure.SecureAggregation(g.adj)), act)
    assert isinstance(got, np.float32) and got == np.asarray(want)


def test_masked_local_step_matches_jax():
    """A down node takes a zero update; live nodes step as without churn
    (a smooth least-squares loss, one SGD step per batch)."""
    rng = np.random.default_rng(0)
    n, d = 6, 5
    w0 = rng.normal(size=(n, d)).astype(np.float32)
    bx = rng.normal(size=(2, n, 4, d)).astype(np.float32)
    by = rng.normal(size=(2, n, 4)).astype(np.float32)
    act = np.array([1, 0, 1, 1, 0, 1], np.float32)

    def jloss(p, x, y):
        return jnp.mean((x @ p["w"] - y) ** 2)

    def tloss(p, x, y):
        return torch.mean((x @ p["w"] - y) ** 2)

    jst = jsteps.RoundSteps(jloss, jmake_optimizer("sgd", 0.1), None, None, jax.random.key(0),
                            4.0, jnp.zeros(n), False)
    jp, _ = jst.local_train({"w": jnp.asarray(w0)}, (), jnp.asarray(bx), jnp.asarray(by),
                            jnp.asarray(act))
    tst = tsteps.RoundSteps(tloss, make_optimizer("sgd", 0.1), None, None, 4.0, torch.zeros(n), False)
    tp = {"w": torch.tensor(w0)}
    tst.local_train(tp, (), torch.tensor(bx), torch.tensor(by), torch.tensor(act))
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tp["w"].numpy()[act == 0], w0[act == 0])


CHURN = {
    "sparse": dict(participation=0.75, churn_machines=4),
    "dense": dict(participation=0.75, churn_machines=4, mixing="dense"),
}


@pytest.fixture(scope="module", params=sorted(CHURN))
def churn_runs(request):
    over = CHURN[request.param]
    return over, jax_run({**WHOLE, **over}), jax_run({**REPLAY, **over})


def test_engine_tracks_jax_over_the_whole_run(churn_runs):
    over, want, _ = churn_runs
    eng, snaps = torch_run({**WHOLE, **over}, want["init"])
    assert_whole_run_tracks(eng, snaps, want)
    assert_run_metrics_match(eng, want)


def test_engine_share_steps_match_jax_round_by_round(churn_runs):
    """N=16, degree 4: the run's bytes and time equal JAX's; each round the
    port's reweight of its static operand under its own mask is the JAX
    engine's operand bitwise, with the same degree, and full sharing from
    the JAX engine's inputs gives its output within 1e-6."""
    over, _, want = churn_runs
    cfg = {**REPLAY, **over}
    eng, _ = torch_run(cfg, want["init"])
    assert_run_metrics_match(eng, want)
    masks = eng.scheduler.participation_mask(0, cfg["rounds"])
    assert len(want["steps"]) == cfg["rounds"]
    for X, W, _, degree, rnd, _, jX2, jbytes in want["steps"]:
        act = masks[int(rnd)]
        assert 0 < act.sum() < len(act)
        static = eng._mix_static
        if isinstance(static, SparseTopology):
            Wm = tsharing.participation_reweight_sparse(static, torch.tensor(act))
            np.testing.assert_array_equal(Wm.w.numpy(), W.w)
            np.testing.assert_array_equal(Wm.w_self.numpy(), W.w_self)
        else:
            Wm = tsharing.participation_reweight(static, torch.tensor(act))
            np.testing.assert_array_equal(Wm.numpy(), W)
        deg = tsharing.participation_deg_eff(*eng.steps.live_edges, act)
        assert deg == degree
        X2, _, nbytes = eng.sharing.round(torch.tensor(X), Wm, (), None, deg, int(rnd))
        np.testing.assert_allclose(X2.numpy(), jX2, atol=1e-6, rtol=0)
        assert np.float32(nbytes) == jbytes
