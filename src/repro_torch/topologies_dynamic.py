"""Topologies and dynamicity (paper §3.2) on the port: ring, 5-regular,
fully connected and a new random 5-regular graph every round, compared by
accuracy and communication; the swap is one line of the config.  The twin
of ``examples/topologies_dynamic.py``, on the card unless ``--device``
names another.

    PYTHONPATH=src python -m repro_torch.topologies_dynamic [--rounds 40] [--device cpu]
"""
import argparse

from repro_torch.core import DecentralizedRunner, DLConfig
from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
from repro_torch.models.api import cross_entropy
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.optim import make_optimizer


def loss_fn(p, x, y):
    return cross_entropy(mlp_apply(p, x), y)


def acc_fn(p, x, y):
    return (mlp_apply(p, x).argmax(-1) == y).float().mean()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    ds = make_dataset("cifar10", n_train=8192, n_test=512)
    parts = sharding_partition(ds.train_y, args.nodes, 2, seed=0)
    batcher = NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0)

    print(f"{'topology':20s} {'acc':>8s} {'MB/node':>9s}")
    out = {}
    for topo, degree in [("ring", 2), ("regular", 5), ("fully", 0), ("dynamic", 5)]:
        # fewer nodes than the degree needs: the densest graph they allow
        degree = min(degree, args.nodes - 1)
        dl = DLConfig(n_nodes=args.nodes, topology=topo, degree=degree,
                      rounds=args.rounds, eval_every=args.rounds - 1, local_steps=2)
        r = DecentralizedRunner(dl, lambda g: mlp_init(g, hidden=128), loss_fn, acc_fn,
                                make_optimizer("sgd", 0.05), batcher, device=args.device)
        hist = r.run(log=False)
        out[topo] = (hist[-1]["acc_mean"], r.bytes_sent)
        print(f"{topo:20s} {hist[-1]['acc_mean']:8.4f} {r.bytes_sent / 1e6:9.1f}")
    return out


if __name__ == "__main__":
    main()
