"""Port parity: datasets, partitions and batch indices are bitwise the JAX
package's (both are numpy-seeded)."""
import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.data import datasets as jds
from repro.data import loader as jloader
from repro.data import partition as jpart
from repro_torch.data import datasets as tds
from repro_torch.data import loader as tloader
from repro_torch.data import partition as tpart


@pytest.mark.parametrize("name,kw", [
    ("cifar10", dict(n_train=128, n_test=32)),
    ("cifar10", dict(n_train=64, n_test=16, sigma=0.5, seed=3)),
    ("teacher", dict(n_train=64, n_test=16, seed=1)),
    ("celeba", dict(n_train=64, n_test=16)),
])
def test_datasets_bitwise(name, kw):
    a, b = jds.make_dataset(name, **kw), tds.make_dataset(name, **kw)
    for f in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


def test_unported_dataset_raises():
    # the token stream is ported now (tests/test_torch_trainer.py holds it
    # bitwise); an unknown name raises as in the reference
    assert tds.make_dataset("lm", n_train=4, n_test=2, seq_len=8).kind == "lm"
    with pytest.raises(ValueError):
        jds.make_dataset("nope")
    with pytest.raises(ValueError):
        tds.make_dataset("nope")


@pytest.mark.parametrize("n_nodes,shards,seed", [(8, 2, 0), (16, 2, 5), (5, 3, 1)])
def test_sharding_partition_bitwise(n_nodes, shards, seed):
    y = jds.make_dataset("cifar10", n_train=256, n_test=8).train_y
    pa = jpart.sharding_partition(y, n_nodes, shards, seed=seed)
    pb = tpart.sharding_partition(y, n_nodes, shards, seed=seed)
    assert len(pa) == len(pb)
    for x, z in zip(pa, pb):
        np.testing.assert_array_equal(x, z)


def _batchers(n_nodes=8, bs=4, seed=0):
    ds = jds.make_dataset("cifar10", n_train=256, n_test=8)
    parts = jpart.sharding_partition(ds.train_y, n_nodes, 2, seed=0)
    return (jloader.NodeBatcher(ds.train_x, ds.train_y, parts, bs, seed=seed),
            tloader.NodeBatcher(ds.train_x, ds.train_y, parts, bs, seed=seed))


@pytest.mark.parametrize("seed", [0, 7])
def test_batch_indices_bitwise(seed):
    ja, tb = _batchers(seed=seed)
    for r in (0, 1, 13):
        np.testing.assert_array_equal(ja.round_indices(r, 2), tb.round_indices(r, 2))
    np.testing.assert_array_equal(ja.chunk_indices(3, 4, 2), tb.chunk_indices(3, 4, 2))
    for a, b in zip(ja.test_batch(), tb.test_batch()):
        np.testing.assert_array_equal(a, b)


def test_empty_partition_raises():
    x = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="empty partition"):
        tloader.NodeBatcher(x, np.zeros(4, np.int32), [np.arange(4), np.arange(0)], 2)


@pytest.mark.parametrize("n_nodes,seed,n", [(8, 0, 256), (16, 5, 250), (3, 11, 17)])
def test_iid_partition_and_classes_per_node_bitwise(n_nodes, seed, n):
    y = jds.make_dataset("cifar10", n_train=n, n_test=8, seed=seed).train_y
    pa = jpart.iid_partition(y, n_nodes, seed=seed)
    pb = tpart.iid_partition(y, n_nodes, seed=seed)
    assert len(pa) == len(pb) == n_nodes
    for x, z in zip(pa, pb):
        np.testing.assert_array_equal(x, z)
        assert x.dtype == z.dtype
    np.testing.assert_array_equal(np.sort(np.concatenate(pb)), np.arange(n))
    for parts in (pb, tpart.sharding_partition(y, n_nodes, 2, seed=seed)):
        np.testing.assert_array_equal(jpart.classes_per_node(y, parts),
                                      tpart.classes_per_node(y, parts))


def test_sharding_limits_classes_as_in_the_paper():
    """The reference's substrate check: 2-sharding gives a node far fewer
    classes than an IID part."""
    y = jds.make_dataset("cifar10", n_train=2000, n_test=8).train_y
    iid = tpart.classes_per_node(y, tpart.iid_partition(y, 20))
    shard = tpart.classes_per_node(y, tpart.sharding_partition(y, 20, 2))
    assert iid.mean() > 8 and shard.mean() < 5
