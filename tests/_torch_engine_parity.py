"""Shared helpers of the engine parity tests (secure aggregation, churn,
the dynamic overlay, random-k and quantized sharing, optimizers and
per-node learning rates: ``test_torch_{secure,churn,dynamic,randomk,
optim}.py``): one run of the JAX package's RoundEngine, recording each
round's share step, and one run of the port's RoundEngine from the same
initial parameters, with the same optimizer and per-node learning-rate
multipliers.

Two sizes.  ``WHOLE`` is the engine parity size of ``test_torch_engine.py``
(8 nodes, degree 5), where the two packages' trajectories are compared
after every eval.  ``REPLAY`` is 16 nodes of degree 4, where the
trajectories part after a few rounds on any sharing strategy, plain full
sharing included: a first-layer max-pool window of one node holds two
equal activations, and the port's batched convolution (``vmap`` over the
per-node weights) sends that window's gradient to the other pixel than the
JAX engine does (1.1e-3 apart after 4 rounds, while one SGD step per node,
unbatched, agrees to 1e-7).  There each round's share step is replayed
from the JAX engine's own inputs, and the metrics of the whole run, which
do not depend on the parameters, are compared.

``model="tiny"`` swaps GN-LeNet for the JAX fault tests' regression model
(``tests/test_faults.py``): a ``p_dim`` parameter vector pulled toward the
batch mean of 2x2x1 images.  Its loss is smooth, so whole runs track at
any node count, and a JAX engine over it compiles in seconds (the fault,
churn-sparsified and FedAvg parity tests).
"""
import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DLConfig as JDLConfig
from repro.core import FaultPlan as JFaultPlan
from repro.core import RoundEngine as JRoundEngine
from repro.core import engine as jengine
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
from repro_torch.data import NodeBatcher
from repro_torch.models.cnn import cnn_init
from repro_torch.optim import make_optimizer
from repro_torch.quickstart import acc_fn, loss_fn

WIDTH, BATCH = 8, 4
TINY_SHAPE = (2, 2, 1)
# the tiny model's engine knobs (rounds 8 evaluated at 0, 4 and 7)
TINY = dict(n_nodes=12, topology="regular", degree=4, local_steps=1, batch_size=BATCH,
            rounds=8, eval_every=4, chunk_rounds=4, network="lan", compute_time_s=0.01, seed=3)
BASE = dict(topology="regular", sharing="full", local_steps=2, batch_size=BATCH, rounds=4,
            eval_every=2, chunk_rounds=2, network="lan")
WHOLE = dict(BASE, n_nodes=8, degree=5)
REPLAY = dict(BASE, n_nodes=16, degree=4)


def _data(n, model="cnn"):
    if model == "tiny":
        ds = make_dataset("cifar10", n_train=256, n_test=32, shape=TINY_SHAPE, sigma=2.0)
    else:
        ds = make_dataset("cifar10", n_train=256, n_test=64)
    return ds, sharding_partition(ds.train_y, n, 2, seed=0)


def _jtiny_loss(p, x, y):
    t = x.reshape(x.shape[0], -1).mean(0)
    return jnp.mean((p["w"].reshape(-1, t.shape[0]) - t) ** 2)


def tiny_loss(p, x, y):
    """The port's copy of the JAX fault tests' regression loss."""
    t = x.reshape(x.shape[0], -1).mean(0)
    return torch.mean((p["w"].reshape(-1, t.shape[0]) - t) ** 2)


def tiny_acc(p, x, y):
    return -tiny_loss(p, x, y)


def _jax_model(model, p_dim):
    """(init, loss, acc) of the JAX engine's model."""
    if model == "tiny":
        return (lambda k: {"w": jax.random.normal(k, (p_dim,))}, _jtiny_loss,
                lambda p, x, y: -_jtiny_loss(p, x, y))
    return (lambda k: jcnn_init(k, width=WIDTH), lambda p, x, y: jce(jcnn_apply(p, x), y),
            lambda p, x, y: (jcnn_apply(p, x).argmax(-1) == y).mean())


def with_plan(cfg, plan_cls):
    """``cfg`` with its ``faults`` entry, the FaultPlan's keyword dict,
    made into ``plan_cls`` (the JAX package's or the port's)."""
    if isinstance(cfg.get("faults"), dict):
        return {**cfg, "faults": plan_cls(**cfg["faults"])}
    return cfg


@dataclasses.dataclass(frozen=True)
class _Recording:
    """A JAX strategy that also hands each round's share-step inputs and
    outputs to ``log``, in round order, as numpy: (X, W, key words,
    degree, rnd, act or None, X', bytes)."""

    inner: Any
    log: list = dataclasses.field(hash=False, compare=False)
    # (state, state') of each round, in the same order
    states: list = dataclasses.field(hash=False, compare=False)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def round(self, X, W, state, key, degree, rnd=0, act=None):
        kw = {} if act is None else {"act": act}
        out = self.inner.round(X, W, state, key, degree, rnd, **kw)
        jax.debug.callback(
            lambda *a: self.log.append(jax.tree_util.tree_map(np.asarray, a)),
            X, W, jax.random.key_data(key), degree, rnd, act, out[0], out[2], ordered=True)
        jax.debug.callback(
            lambda *a: self.states.append(jax.tree_util.tree_map(np.asarray, a)),
            state, out[1], ordered=True)
        return out


def jax_run(cfg, optimizer=("sgd", 0.05, {}), heterogeneous_lrs=None, model="cnn", p_dim=8,
            sharing_kw=None):
    """One JAX engine run: initial params, flat params at each eval,
    history, totals (the fault counters included), and each round's
    recorded share step.  ``optimizer`` is ``make_optimizer``'s (name, lr,
    kwargs); ``model`` 'cnn' (GN-LeNet) or 'tiny' (module docstring);
    ``sharing_kw`` further strategy kwargs (CHOCO's ``compressor``)."""
    sharing_kw = sharing_kw or {}
    ds, parts = _data(cfg["n_nodes"], model)
    init_fn, jloss, jacc = _jax_model(model, p_dim)
    name, lr, okw = optimizer
    steps, states = [], []
    make, secure = jsharing.make_sharing, jengine.SecureAggregation
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsharing, "make_sharing",
                   lambda *a, **kw: _Recording(make(*a, **kw, **sharing_kw), steps, states))
        mp.setattr(jengine, "SecureAggregation",
                   lambda *a, **kw: _Recording(secure(*a, **kw), steps, states))
        eng = JRoundEngine(
            JDLConfig(**with_plan(cfg, JFaultPlan)), init_fn, jloss, jacc, jmake_optimizer(name, lr, **okw),
            JNodeBatcher(ds.train_x, ds.train_y, parts, BATCH, seed=0),
            heterogeneous_lrs=heterogeneous_lrs,
        )
    init = jax.tree_util.tree_map(np.asarray, eng.params)
    snaps, record = [], eng._record

    def snap_record(rnd, *a, **kw):
        snaps.append(np.asarray(jax.vmap(jtree_vector)(eng.params)))
        record(rnd, *a, **kw)

    eng._record = snap_record
    eng.run(log=False)
    jax.effects_barrier()
    return {"init": init, "snaps": snaps, "history": eng.history, "steps": steps,
            "states": states, "X": np.asarray(jax.vmap(jtree_vector)(eng.params)),
            "bytes_sent": eng.bytes_sent, "sim_time_s": eng.sim_time_s,
            "share_stage_bytes": eng.share_stage_bytes, "wire_dtype": eng.wire_dtype,
            "mix_mode": eng.mix_mode, "topo_stage_bytes_peak": eng.topo_stage_bytes_peak,
            "opt_state": jax.tree_util.tree_map(np.asarray, eng.opt_state),
            "share_state": jax.tree_util.tree_map(np.asarray, eng.share_state),
            "totals": dict(eng.scheduler._fault_totals)}


def torch_engine(cfg, init, optimizer=("sgd", 0.05, {}), heterogeneous_lrs=None, model="cnn",
                 sharing_kw=None, p_dim=8):
    """The port's engine on the CPU from the JAX run's initial params (or
    its own draws where ``init`` is None), not yet run; ``sharing_kw`` and
    ``p_dim`` as :func:`jax_run`'s."""
    ds, parts = _data(cfg["n_nodes"], model)
    name, lr, okw = optimizer
    tiny = model == "tiny"
    eng = RoundEngine(
        DLConfig(**with_plan(cfg, FaultPlan)),
        (lambda g: {"w": torch.randn((p_dim,), generator=g)}) if tiny
        else (lambda g: cnn_init(g, width=WIDTH)),
        tiny_loss if tiny else loss_fn, tiny_acc if tiny else acc_fn,
        make_optimizer(name, lr, **okw), NodeBatcher(ds.train_x, ds.train_y, parts, BATCH, seed=0),
        heterogeneous_lrs, init_params=None if init is None else params_from_jax(init),
        device="cpu",
    )
    if sharing_kw:
        eng.sharing = eng.steps.sharing = dataclasses.replace(eng.sharing, **sharing_kw)
    return eng


def torch_run(cfg, init, **kw):
    """:func:`torch_engine` run to its end: (engine, flat params at each
    eval)."""
    eng = torch_engine(cfg, init, **kw)
    snaps, record = [], eng._record

    def snap_record(rnd, *a, **kw):
        snaps.append(eng.X.clone().numpy())
        record(rnd, *a, **kw)

    eng._record = snap_record
    eng.run(log=False)
    return eng, snaps


def assert_run_metrics_match(eng, want):
    """Totals and history equal (sim time within rtol 1e-6), the fault
    counters included."""
    assert eng.bytes_sent == want["bytes_sent"] > 0
    assert eng.sim_time_s == pytest.approx(want["sim_time_s"], rel=1e-6)
    for k in ("share_stage_bytes", "wire_dtype", "mix_mode", "topo_stage_bytes_peak"):
        assert getattr(eng, k) == want[k], k
    assert len(eng.history) == len(want["history"])
    for h, jh in zip(eng.history, want["history"]):
        assert h.keys() == jh.keys()
        for k in jh:
            if k == "sim_time_s":
                assert h[k] == pytest.approx(jh[k], rel=1e-6)
            elif k not in ("wall_s", "acc_mean", "acc_std"):
                assert h[k] == jh[k], k


def assert_whole_run_tracks(eng, snaps, want):
    """Parameters within atol 1e-4 of the JAX engine after every eval."""
    assert len(snaps) == len(want["snaps"]) == 3  # rounds 0, 2, 3
    for got, ref in zip(snaps, want["snaps"]):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    for h, jh in zip(eng.history, want["history"]):
        assert abs(h["acc_mean"] - jh["acc_mean"]) <= 2 / 64
