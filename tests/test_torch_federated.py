"""Port parity: FedAvg (``core/federated.py``) and the per-node batch
sampler it draws from, against the JAX package.

Tolerances: batches bitwise (numpy draws); the global model within 1e-5
after the run (fp32 SGD steps through ``vmap(grad)`` and an fp32 mean over
the clients, in another operation order), history rounds equal and
accuracy within one test sample.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import FederatedRunner as JFederatedRunner
from repro.core import FLConfig as JFLConfig
from repro.data import NodeBatcher as JNodeBatcher
from repro.data import make_dataset, sharding_partition
from repro.models.api import cross_entropy as jce
from repro.models.mlp import mlp_apply as jmlp_apply
from repro.models.mlp import mlp_init as jmlp_init
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.convert import mlp_params_from_jax
from repro_torch.core import FederatedRunner, FLConfig
from repro_torch.data import NodeBatcher
from repro_torch.optim import make_optimizer
from repro_torch.topologies_dynamic import acc_fn, loss_fn

N_TEST = 64


def _data(n=8):
    ds = make_dataset("cifar10", n_train=512, n_test=N_TEST, sigma=4.0)
    return ds, sharding_partition(ds.train_y, n, 2, seed=0)


@pytest.mark.parametrize("bs,rnd,step", [(8, 0, 0), (8, 5, 3), (80, 2, 1)])
def test_node_batcher_batch_bitwise(bs, rnd, step):
    """Per-node ``default_rng`` draws, without replacement where the
    partition is large enough (with replacement at batch 80, over the 64
    samples each node holds)."""
    ds, parts = _data()
    want = JNodeBatcher(ds.train_x, ds.train_y, parts, bs, seed=3).batch(rnd, step)
    got = NodeBatcher(ds.train_x, ds.train_y, parts, bs, seed=3).batch(rnd, step)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("optimizer", [("sgd", 0.05, {}), ("momentum", 0.05, {"beta": 0.9})],
                         ids=["sgd", "momentum"])
def test_fedavg_matches_jax(optimizer):
    """8 clients, 4 per round, 2 local steps, 3 rounds, MLP of width 16,
    from the JAX runner's initial model."""
    ds, parts = _data()
    fl = dict(n_clients=8, clients_per_round=4, local_steps=2, rounds=3, eval_every=2, seed=1)
    name, lr, okw = optimizer
    jr = JFederatedRunner(
        JFLConfig(**fl), lambda k: jmlp_init(k, hidden=16), lambda p, x, y: jce(jmlp_apply(p, x), y),
        lambda p, x, y: (jmlp_apply(p, x).argmax(-1) == y).mean(), jmake_optimizer(name, lr, **okw),
        JNodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0))
    init = jax.tree_util.tree_map(np.asarray, jr.params)
    jh = jr.run(log=False)
    tr = FederatedRunner(FLConfig(**fl), None, loss_fn, acc_fn, make_optimizer(name, lr, **okw),
                         NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0),
                         init_params=mlp_params_from_jax(init), device="cpu")
    th = tr.run(log=False)
    assert [h["round"] for h in th] == [h["round"] for h in jh] == [0, 2]
    for h, j in zip(th, jh):
        assert abs(h["acc"] - j["acc"]) <= 1 / N_TEST
    for layer in ("fc1", "fc2", "fc3"):
        for leaf in ("w", "b"):
            got = tr.params[layer][leaf]
            assert got.shape == init[layer][leaf].shape and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(jr.params[layer][leaf]),
                                       atol=1e-5, rtol=0)
    assert not np.allclose(tr.params["fc3"]["w"].numpy(), init["fc3"]["w"])


def test_fedavg_defaults_to_the_card():
    ds, parts = _data()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedRunner(FLConfig(), None, loss_fn, acc_fn, make_optimizer("sgd", 0.05),
                        NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0))


def test_fedavg_draws_its_own_model_from_the_seed():
    from repro_torch.models.mlp import mlp_init

    ds, parts = _data()
    runs = [FederatedRunner(FLConfig(n_clients=8, clients_per_round=2, rounds=2, seed=s),
                            lambda g: mlp_init(g, hidden=8), loss_fn, acc_fn,
                            make_optimizer("sgd", 0.05),
                            NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0), device="cpu")
            for s in (4, 4, 5)]
    assert torch.equal(runs[0].params["fc1"]["w"], runs[1].params["fc1"]["w"])
    assert not torch.equal(runs[0].params["fc1"]["w"], runs[2].params["fc1"]["w"])
    hist = runs[0].run(log=False)
    assert [h["round"] for h in hist] == [0, 1] and all(0 <= h["acc"] <= 1 for h in hist)
