"""Port parity: churn (participation 0.7) with the sparsified and quantized
strategies against the JAX package: TopK with fp32 and int8 payloads,
CHOCO-SGD with the top-k and the random-k compressor, random-k and
stochastic quantized sharing.  TopK and CHOCO update their state in place,
so a down node's ``last_shared`` / x̂ must stay as it was, as the
reference's ``node_where(active, new_share, share_state)`` keeps it.

On the JAX fault tests' regression model (``_torch_engine_parity``
``model="tiny"``, 64 parameters, k = 6): each whole run is compared after
every eval, and each of the JAX engine's share steps is replayed on the
port from its inputs with the port's churn-reweighted operand and mask.

Tolerances: parameters within 1e-4 after every eval, bytes equal,
``sim_time_s`` within rtol 1e-6; replayed share steps within 1e-6 (fp32
summation order) with equal bytes; down rows' share state bitwise.
"""
import numpy as np
import pytest
import torch

from _torch_engine_parity import (
    TINY,
    assert_run_metrics_match,
    jax_run,
    torch_engine,
    torch_run,
)
from repro_torch.core import sharing as tsharing
from repro_torch.core.topology import SparseTopology

P_DIM = 64
CHURN = dict(TINY, participation=0.7)
CASES = {  # (engine knobs, strategy kwargs of both packages)
    "topk": (dict(sharing="topk", budget=0.1), None),
    "topk-int8": (dict(sharing="topk", budget=0.1, payload_quant=True), None),
    "choco": (dict(sharing="choco", budget=0.1), None),
    "choco-randk": (dict(sharing="choco", budget=0.1), {"compressor": "randk"}),
    "randomk": (dict(sharing="randomk", budget=0.1), None),
    "quant": (dict(sharing="quant"), None),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def churn_run(request):
    knobs, skw = CASES[request.param]
    cfg = {**CHURN, **knobs}
    want = jax_run(cfg, model="tiny", p_dim=P_DIM, sharing_kw=skw)
    eng, snaps = torch_run(cfg, want["init"], model="tiny", sharing_kw=skw)
    return request.param, cfg, skw, want, eng, snaps


def test_whole_run_tracks_jax(churn_run):
    _, _, _, want, eng, snaps = churn_run
    assert len(snaps) == len(want["snaps"]) == 3
    for got, ref in zip(snaps, want["snaps"]):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert_run_metrics_match(eng, want)
    for k, v in (eng.share_state or {}).items():
        np.testing.assert_allclose(v.numpy(), want["share_state"][k], atol=1e-4, rtol=0)


def test_share_steps_replay_with_the_churn_reweighted_operand(churn_run):
    """Every round's share step from the JAX engine's inputs: the port's
    reweight of its static operand under its own mask is the JAX operand
    bitwise, and the step gives the JAX step's output and its live rows'
    state within 1e-6 with equal bytes; down rows' state is bitwise what
    it was."""
    name, cfg, skw, want, _, _ = churn_run
    eng = torch_engine(cfg, want["init"], model="tiny", sharing_kw=skw)
    masks = eng.scheduler.participation_mask(0, cfg["rounds"])
    assert len(want["steps"]) == len(want["states"]) == cfg["rounds"]
    for (X, W, kd, degree, rnd, _, jX2, jbytes), (s0, js1) in zip(want["steps"], want["states"]):
        act_np = masks[int(rnd)]
        down = act_np == 0
        assert down.any() and not down.all()
        act = torch.tensor(act_np)
        Wm, deg, key, kw = eng.steps.share_operands(eng._mix_static, int(rnd), (act, act_np))
        assert isinstance(Wm, SparseTopology)
        np.testing.assert_array_equal(Wm.w.numpy(), W.w)
        np.testing.assert_array_equal(Wm.w_self.numpy(), W.w_self)
        assert deg == degree
        np.testing.assert_array_equal(np.array(key, dtype=np.uint32), kd)
        state = {k: torch.tensor(v) for k, v in s0.items()} if s0 else ()
        X2, state2, nbytes = eng.sharing.round(torch.tensor(X), Wm, state, key=key, degree=deg,
                                               rnd=int(rnd), **kw)
        np.testing.assert_allclose(X2.numpy(), jX2, atol=1e-6, rtol=0)
        assert np.float32(nbytes) == jbytes
        for k, v in (state2 or {}).items():
            # the JAX strategy updates every row; its step then keeps the
            # down rows' old state
            np.testing.assert_allclose(v.numpy()[~down], js1[k][~down], atol=1e-6, rtol=0)
            np.testing.assert_array_equal(v.numpy()[down], s0[k][down])
            assert not np.array_equal(v.numpy()[~down], s0[k][~down])


@pytest.mark.parametrize("strategy", ["topk", "choco"])
def test_down_rows_state_is_bitwise_frozen_in_the_engine(strategy):
    """A run on the port alone: after every round, the rows of the nodes
    that were down keep the state they had before it."""
    cfg = {**CHURN, **CASES[strategy][0], "chunk_rounds": 1}
    eng = torch_engine(cfg, None, model="tiny", p_dim=P_DIM)
    masks = eng.scheduler.participation_mask(0, cfg["rounds"])
    key = "last_shared" if strategy == "topk" else "xhat"
    for r in range(cfg["rounds"]):
        before = eng.share_state[key].clone()
        eng.scheduler.run_span(r, 1)
        down = masks[r] == 0
        assert down.any()
        assert torch.equal(eng.share_state[key][down], before[down])
        assert not torch.equal(eng.share_state[key][~down], before[~down])


def test_mask_argument_leaves_stateless_strategies_alone():
    """Random-k and quant keep no state: they take no mask, and the engine
    freezes their outputs' down rows."""
    for name in ("randomk", "quant"):
        assert not getattr(tsharing.make_sharing(name), "needs_act", False)
    for name in ("topk", "choco"):
        assert tsharing.make_sharing(name).needs_act
