"""Sparsification (paper §3.3) on the port: full sharing against random
sampling, TopK and CHOCO-SGD at a 10% budget; only the Sharing module
changes.  The twin of ``examples/sparsification.py``, on the card unless
``--device`` names another.

    PYTHONPATH=src python -m repro_torch.sparsification [--rounds 40] [--device cpu]
"""
import argparse

from repro_torch.core import DecentralizedRunner, DLConfig
from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
from repro_torch.optim import make_optimizer
from repro_torch.models.mlp import mlp_init
from repro_torch.topologies_dynamic import acc_fn, loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--budget", type=float, default=0.1)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    ds = make_dataset("cifar10", n_train=8192, n_test=512)
    parts = sharding_partition(ds.train_y, args.nodes, 2, seed=0)
    batcher = NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0)

    print(f"{'sharing':18s} {'acc':>8s} {'MB/node':>9s}")
    out = {}
    for sharing in ("full", "randomk", "topk", "choco"):
        dl = DLConfig(n_nodes=args.nodes, topology="regular", degree=min(5, args.nodes - 1),
                      sharing=sharing, budget=args.budget, rounds=args.rounds,
                      eval_every=args.rounds - 1, local_steps=2)
        r = DecentralizedRunner(dl, lambda g: mlp_init(g, hidden=128), loss_fn, acc_fn,
                                make_optimizer("sgd", 0.05), batcher, device=args.device)
        hist = r.run(log=False)
        out[sharing] = (hist[-1]["acc_mean"], r.bytes_sent)
        print(f"{sharing:18s} {hist[-1]['acc_mean']:8.4f} {r.bytes_sent / 1e6:9.1f}")
    return out


if __name__ == "__main__":
    main()
