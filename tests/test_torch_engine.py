"""Port parity for the slices as a whole: the port's RoundEngine against
the JAX package's RoundEngine on the quickstart configuration (sync, full
sharing, 5-regular overlay, GN-LeNet, plain SGD, LAN network), and on the
same configuration with compressed sharing (TopK with fp32 and int8
payloads, CHOCO-SGD), both started from the same JAX-initialised
parameters.  Both engines resolve the top-k selector 'auto' to the exact
sort on the CPU.

Tolerances: parameters after every eval within atol 1e-4 (fp32 with other
summation orders, compounded over the rounds); ``acc_mean`` within 2/64;
``bytes_sent`` equal; ``sim_time_s`` within rtol 1e-6.

The int8 payload wire is discontinuous: a value whose x/scale lies within
an fp32 rounding of a half-integer takes the next code when local training
moved it by that rounding, and the reconstructed value then moves by a
whole scale step.  Its trajectory is compared round by round instead: the
port's share step is fed the JAX engine's post-training X and strategy
state of every round and must give its post-mix X and state within atol
1e-6, as one ``round`` does in ``test_torch_sharing.py``.
"""
import dataclasses
import json
from typing import Any

import jax
import numpy as np
import pytest
import torch

from repro.core import DLConfig as JDLConfig
from repro.core import FaultPlan as JFaultPlan
from repro.core import RoundEngine as JRoundEngine
from repro.core import sharing as jsharing
from repro.data import NodeBatcher as JNodeBatcher
from repro.data import make_dataset, sharding_partition
from repro.models.api import cross_entropy as jce
from repro.models.cnn import cnn_apply as jcnn_apply
from repro.models.cnn import cnn_init as jcnn_init
from repro.optim import make_optimizer as jmake_optimizer
from repro.utils.pytree import tree_vector as jtree_vector
from repro_torch import DLConfig, FaultPlan, RoundEngine
from repro_torch.convert import params_from_jax
from repro_torch.core import topology as ttop
from repro_torch.core.engine import make_strategy
from repro_torch.data import NodeBatcher
from repro_torch.models.cnn import cnn_init
from repro_torch.optim import make_optimizer
from repro_torch.quickstart import acc_fn, loss_fn
from repro_torch.quickstart import main as quickstart_main

N, WIDTH, BATCH = 8, 8, 4
CFG = dict(n_nodes=N, topology="regular", degree=5, sharing="full", local_steps=2,
           batch_size=BATCH, rounds=4, eval_every=2, chunk_rounds=2, network="lan")


def _data():
    ds = make_dataset("cifar10", n_train=256, n_test=64)
    return ds, sharding_partition(ds.train_y, N, 2, seed=0)


@dataclasses.dataclass(frozen=True)
class _Recording:
    """A JAX strategy that also hands each round's share-step inputs and
    outputs (X, state, X', state', bytes) to ``log``, in round order."""

    inner: Any
    log: list = dataclasses.field(hash=False, compare=False)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def round(self, X, W, state, key, degree, rnd=0):
        out = self.inner.round(X, W, state, key, degree, rnd)
        jax.debug.callback(lambda *a: self.log.append(jax.tree_util.tree_map(np.asarray, a)),
                           X, state, *out, ordered=True)
        return out


def _jax_run(out, **over):
    """One JAX engine run (about 20 s here): its initial params, the flat
    params at each eval, its totals, and each round's share step."""
    ds, parts = _data()
    steps, make = [], jsharing.make_sharing
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsharing, "make_sharing", lambda *a, **kw: _Recording(make(*a, **kw), steps))
        eng = JRoundEngine(
            JDLConfig(**{**CFG, **over}, results_dir=str(out)), lambda k: jcnn_init(k, width=WIDTH),
            lambda p, x, y: jce(jcnn_apply(p, x), y),
            lambda p, x, y: (jcnn_apply(p, x).argmax(-1) == y).mean(),
            jmake_optimizer("sgd", 0.05), JNodeBatcher(ds.train_x, ds.train_y, parts, BATCH, seed=0),
        )
    init = jax.tree_util.tree_map(np.asarray, eng.params)
    snaps, record = [], eng._record

    def snap_record(rnd, *a, **kw):
        snaps.append(np.asarray(jax.vmap(jtree_vector)(eng.params)))
        record(rnd, *a, **kw)

    eng._record = snap_record
    eng.run(log=False)
    jax.effects_barrier()
    with open(out / "results.json") as f:
        results = json.load(f)
    return {"init": init, "snaps": snaps, "history": eng.history, "results": results,
            "steps": steps,
            "bytes_sent": eng.bytes_sent, "sim_time_s": eng.sim_time_s,
            "n_params": eng.n_params, "share_stage_bytes": eng.share_stage_bytes,
            "wire_dtype": eng.wire_dtype, "mix_mode": eng.mix_mode}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("jax_results"))


SPARSE = {
    "topk-fp32": dict(sharing="topk"),
    "topk-int8": dict(sharing="topk", payload_quant=True),
    "choco": dict(sharing="choco"),
}


@pytest.fixture(scope="module", params=sorted(SPARSE))
def jax_sparse_run(request, tmp_path_factory):
    over = SPARSE[request.param]
    return over, _jax_run(tmp_path_factory.mktemp("jax_sparse"), **over)


def _torch_run(init, results_dir=None, **over):
    ds, parts = _data()
    eng = RoundEngine(
        DLConfig(**{**CFG, **over}, results_dir=results_dir), lambda g: cnn_init(g, width=WIDTH),
        loss_fn, acc_fn, make_optimizer("sgd", 0.05),
        NodeBatcher(ds.train_x, ds.train_y, parts, BATCH, seed=0),
        init_params=None if init is None else params_from_jax(init), device="cpu",
    )
    snaps, record = [], eng._record

    def snap_record(rnd, *a, **kw):
        snaps.append(eng.X.clone().numpy())
        record(rnd, *a, **kw)

    eng._record = snap_record
    eng.run(log=False)
    return eng, snaps


def test_params_track_jax_at_every_eval(jax_run):
    eng, snaps = _torch_run(jax_run["init"])
    assert len(snaps) == len(jax_run["snaps"]) == 3  # rounds 0, 2, 3
    for got, want in zip(snaps, jax_run["snaps"]):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for h, jh in zip(eng.history, jax_run["history"]):
        assert h["round"] == jh["round"]
        assert abs(h["acc_mean"] - jh["acc_mean"]) <= 2 / 64


def test_bytes_time_and_engine_metrics_match_jax(jax_run):
    eng, _ = _torch_run(jax_run["init"])
    assert eng.bytes_sent == jax_run["bytes_sent"]
    assert eng.sim_time_s == pytest.approx(jax_run["sim_time_s"], rel=1e-6)
    assert eng.sim_time_s > 0
    for k in ("n_params", "share_stage_bytes", "wire_dtype", "mix_mode"):
        assert getattr(eng, k) == jax_run[k], k
    for h, jh in zip(eng.history, jax_run["history"]):
        assert h["bytes_per_node"] == jh["bytes_per_node"]
        assert h["sim_time_s"] == pytest.approx(jh["sim_time_s"], rel=1e-6)


@pytest.mark.parametrize("chunk", [0, 1, 4])
def test_trajectory_bitwise_across_chunk_rounds(jax_run, chunk):
    ref, ref_snaps = _torch_run(jax_run["init"], chunk_rounds=2)
    eng, snaps = _torch_run(jax_run["init"], chunk_rounds=chunk)
    for a, b in zip(snaps, ref_snaps):
        np.testing.assert_array_equal(a, b)
    assert [h["acc_mean"] for h in eng.history] == [h["acc_mean"] for h in ref.history]
    assert eng.bytes_sent == ref.bytes_sent and eng.sim_time_s == ref.sim_time_s


# the int8 wire is compared round by round (module docstring)
@pytest.mark.parametrize("jax_sparse_run", ["choco", "topk-fp32"], indirect=True)
def test_sparse_params_track_jax_at_every_eval(jax_sparse_run):
    over, want = jax_sparse_run
    eng, snaps = _torch_run(want["init"], **over)
    assert len(snaps) == len(want["snaps"]) == 3
    for got, ref in zip(snaps, want["snaps"]):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    for h, jh in zip(eng.history, want["history"]):
        assert abs(h["acc_mean"] - jh["acc_mean"]) <= 2 / 64


def test_sparse_bytes_and_wire_metrics_match_jax(jax_sparse_run):
    over, want = jax_sparse_run
    eng, _ = _torch_run(want["init"], **over)
    assert eng.bytes_sent == want["bytes_sent"] > 0
    assert eng.sim_time_s == pytest.approx(want["sim_time_s"], rel=1e-6)
    for k in ("n_params", "share_stage_bytes", "wire_dtype", "mix_mode"):
        assert getattr(eng, k) == want[k], k
    for h, jh in zip(eng.history, want["history"]):
        assert h["bytes_per_node"] == jh["bytes_per_node"]
        assert h["wire_dtype"] == jh["wire_dtype"]


def test_sparse_share_step_matches_jax_round_by_round(jax_sparse_run):
    over, want = jax_sparse_run
    dl = DLConfig(**{**CFG, **over})
    sharing = make_strategy(dl)
    topo = ttop.SparseTopology.regular_circulant(N, 5).to("cpu")
    assert len(want["steps"]) == CFG["rounds"]
    for X, state, jX2, jstate, jbytes in want["steps"]:
        state = {k: torch.tensor(v) for k, v in state.items()}
        X2, state, nbytes = sharing.round(torch.tensor(X), topo, state, key=None, degree=5.0)
        np.testing.assert_allclose(X2.numpy(), jX2, atol=1e-6, rtol=0)
        for k, v in jstate.items():
            np.testing.assert_allclose(state[k].numpy(), v, atol=1e-6, rtol=0)
        assert float(np.float32(nbytes)) == float(jbytes)


def test_results_json_has_the_jax_schema(jax_run, tmp_path):
    _torch_run(jax_run["init"], results_dir=str(tmp_path))
    with open(tmp_path / "results.json") as f:
        got = json.load(f)
    want = jax_run["results"]
    assert got.keys() == want.keys()
    assert got["config"].keys() == want["config"].keys()
    assert [h.keys() for h in got["history"]] == [h.keys() for h in want["history"]]


def test_default_init_is_per_node_and_seeded():
    a, _ = _torch_run(None, rounds=1)
    b, _ = _torch_run(None, rounds=1)
    np.testing.assert_array_equal(a.X.numpy(), b.X.numpy())
    ds, parts = _data()
    fresh = RoundEngine(DLConfig(**CFG), lambda g: cnn_init(g, width=WIDTH), loss_fn, acc_fn,
                        make_optimizer("sgd", 0.05),
                        NodeBatcher(ds.train_x, ds.train_y, parts, BATCH), device="cpu")
    X = fresh.X.numpy()
    assert not np.array_equal(X[0], X[1])  # each node its own generator
    g = torch.Generator().manual_seed(0 * 1_000_003 + 1)
    want = torch.cat([t.reshape(-1) for t in
                      _leaves(cnn_init(g, width=WIDTH))]).numpy()
    np.testing.assert_array_equal(X[1], want)
    assert fresh.params["fc2"]["w"].shape == (N, 128, 10)


def _leaves(tree):
    return [t for k in sorted(tree) for t in (_leaves(tree[k]) if isinstance(tree[k], dict)
                                              else [tree[k]])]


@pytest.mark.parametrize("knob", [
    dict(sharing="randomk", randk_sampler="strided", shard_devices=2),
    dict(secure=True, secure_recovery=True, faults=FaultPlan(crashes=((0, 1, 2),)),
         shard_devices=2),
    dict(shard_devices=2), dict(sharing="topk", shard_devices=4),
])
def test_validate_raises_not_implemented(knob):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        DLConfig(**knob).validate()


# the scheduler, cohort and batch-keying knobs (unported until the local
# and async schedulers came in): the port accepts and rejects them as the
# reference does; each case is (knobs, FaultPlan kwargs or None)
SEMANTICS_ACCEPTED = [
    (dict(semantics="local"), None), (dict(semantics="async"), None),
    (dict(sharing="int8", semantics="local"), dict(msg_loss=0.1)),
    (dict(semantics="async"), dict(msg_loss=0.1)),
    (dict(topology="dynamic", batch_keying="node"), None), (dict(batch_keying="node"), None),
]
SEMANTICS_REJECTED = [
    (dict(sharing="randomk", semantics="async"), None),
    (dict(sharing="quant", cohort_capacity=4), None),
    (dict(sharing="topk", participation=0.5, semantics="async"), None),
    (dict(sharing="choco", participation=0.5, cohort_capacity=4), None),
    (dict(cohort_capacity=4), None),
]


def _semantics_cfgs(knob, plan):
    return [cls(**knob, **({} if plan is None else {"faults": fp(**plan)}))
            for cls, fp in ((JDLConfig, JFaultPlan), (DLConfig, FaultPlan))]


@pytest.mark.parametrize("knob,plan", SEMANTICS_ACCEPTED)
def test_validate_accepts_the_semantics_knobs_as_jax_does(knob, plan):
    for cfg in _semantics_cfgs(knob, plan):
        cfg.validate()


@pytest.mark.parametrize("knob,plan", SEMANTICS_REJECTED)
def test_validate_rejects_the_semantics_knobs_as_jax_does(knob, plan):
    for cfg in _semantics_cfgs(knob, plan):
        with pytest.raises(ValueError):
            cfg.validate()


@pytest.mark.parametrize("knob", [
    dict(semantics="nope"), dict(mixing="nope"), dict(payload="on"),
    dict(payload_quant=True), dict(randk_sampler="strided"), dict(secure_recovery=True),
    dict(participation=1.5), dict(straggler_frac=0.5, straggler_factor=3.0),
    dict(compute_spread=0.5), dict(selection="hier"), dict(cold_dtype="int8"),
    dict(sharing="topk", payload="banana"), dict(sharing="choco", randk_sampler="strided"),
    dict(secure=True, payload="on"), dict(secure=True, payload_quant=True),
    dict(secure=True, sharing="randomk", randk_sampler="strided"),
    dict(secure=True, topology="dynamic"), dict(secure=True, participation=0.5),
    dict(secure=True, churn_machines=2), dict(secure_recovery=True, participation=0.5),
])
def test_validate_applies_the_jax_rules(knob):
    with pytest.raises(ValueError):
        JDLConfig(**knob).validate()
    with pytest.raises(ValueError):
        DLConfig(**knob).validate()


@pytest.mark.parametrize("knob", [
    dict(secure=True), dict(secure=True, secure_recovery=True),
    dict(secure=True, participation=0.5, secure_recovery=True),
    dict(secure=True, churn_machines=3, secure_recovery=True, mixing="dense"),
    dict(participation=0.5), dict(participation=0.5, churn_machines=2),
    dict(sharing="topk", churn_machines=2), dict(sharing="topk", participation=0.5),
    dict(sharing="choco", participation=0.5),
])
def test_validate_accepts_the_ported_secure_and_churn_knobs(knob):
    assert JDLConfig(**knob).validate() is not None
    assert DLConfig(**knob).validate() is not None


@pytest.mark.parametrize("knob", [
    dict(sharing="randomk"), dict(sharing="randomk", randk_sampler="strided"),
    dict(sharing="int8"), dict(sharing="quant"), dict(topology="dynamic"),
    dict(topology="dynamic", mixing="dense", participation=0.5),
    dict(sharing="quant", churn_machines=2), dict(sharing="choco", budget=0.2),
])
def test_validate_accepts_the_sampled_and_dynamic_knobs(knob):
    assert JDLConfig(**knob).validate() is not None
    assert DLConfig(**knob).validate() is not None


def test_unknown_sharing_is_a_value_error():
    with pytest.raises(ValueError, match="unknown sharing"):
        DLConfig(sharing="nope").validate()


def test_heterogeneous_lrs_not_ported():
    """Per-node learning rates are ported (``test_torch_optim.py`` holds
    them against the JAX engine); one of the wrong length still raises."""
    with pytest.raises(ValueError, match="heterogeneous_lrs"):
        RoundEngine(DLConfig(), None, None, None, None, None, np.ones(15), device="cpu")


def test_config_fields_and_defaults_carry_over():
    import dataclasses

    j = {f.name: f.default for f in dataclasses.fields(JDLConfig)}
    t = {f.name: f.default for f in dataclasses.fields(DLConfig)}
    assert j == t
    assert DLConfig().validate() is not None


def test_dense_topology_runs_through_matmul():
    ds, parts = _data()
    eng = RoundEngine(DLConfig(**{**CFG, "topology": "fully", "rounds": 1}),
                      lambda g: cnn_init(g, width=WIDTH), loss_fn, acc_fn,
                      make_optimizer("sgd", 0.05),
                      NodeBatcher(ds.train_x, ds.train_y, parts, BATCH), device="cpu")
    assert eng.mix_mode == "dense"
    eng.run(log=False)
    assert eng.bytes_sent == 7 * eng.n_params * 4 and eng.sim_time_s > 0


def test_quickstart_cli_writes_the_schema(tmp_path):
    eng = quickstart_main(["--rounds", "1", "--nodes", "16", "--device", "cpu",
                           "--network", "lan", "--results-dir", str(tmp_path)])
    with open(tmp_path / "results.json") as f:
        res = json.load(f)
    assert res["config"]["n_nodes"] == 16 and len(res["history"]) == 1
    assert eng.n_params == 277_706  # GN-LeNet at width 16
    assert np.isfinite(res["history"][-1]["acc_mean"])
