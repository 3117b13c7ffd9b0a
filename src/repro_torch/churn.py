"""Churn on the port: each round every node is up with probability
``participation`` (iid, or with ``--machines M`` whole machines fail
together); down nodes skip their local step, drop out of the mixing
operand and keep their state until they rejoin.  Seeded stragglers set
heavier per-node compute times.  ``--semantics local`` runs the same
rounds on per-node clocks with a neighbourhood barrier, ``async`` as
event-driven gossip (one local step per event); both print the median
node clock, async also the mean staleness.  The twin of
``examples/churn.py``, on the card unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.churn [--rounds 40] [--machines 4]
        [--semantics sync|local|async] [--straggler-factor 10 --straggler-frac 0.1]
        [--device cpu]
"""
import argparse

from repro_torch.core import DecentralizedRunner, DLConfig
from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
from repro_torch.models.mlp import mlp_init
from repro_torch.optim import make_optimizer
from repro_torch.topologies_dynamic import acc_fn, loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--semantics", choices=("sync", "local", "async"), default="sync")
    ap.add_argument("--machines", type=int, default=0,
                    help="churn_machines: >0 drops whole machines together")
    ap.add_argument("--compute-time", type=float, default=0.05,
                    help="base per-node compute seconds in the time model")
    ap.add_argument("--straggler-factor", type=float, default=1.0)
    ap.add_argument("--straggler-frac", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    ds = make_dataset("cifar10", n_train=8192, n_test=512)
    parts = sharding_partition(ds.train_y, args.nodes, 2, seed=0)
    batcher = NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0)

    extra = ""
    if args.semantics != "sync":
        extra = f" {'median node clock':>18s}"
    if args.semantics == "async":
        extra += f" {'staleness':>10s}"
    print(f"{'participation':>14s} {'acc':>8s} {'MB/node':>9s} {'sim LAN s':>10s}" + extra)
    out = {}
    for p in (1.0, 0.9, 0.7, 0.5):
        dl = DLConfig(n_nodes=args.nodes, topology="regular", degree=min(5, args.nodes - 1),
                      rounds=args.rounds, eval_every=max(args.rounds - 1, 1),
                      local_steps=2 if args.semantics != "async" else 1,
                      participation=p, churn_machines=args.machines, network="lan",
                      semantics=args.semantics, compute_time_s=args.compute_time,
                      straggler_factor=args.straggler_factor,
                      straggler_frac=args.straggler_frac)
        r = DecentralizedRunner(dl, lambda g: mlp_init(g, hidden=128), loss_fn, acc_fn,
                                make_optimizer("sgd", 0.05), batcher, device=args.device)
        hist = r.run(log=False)
        out[f"participation={p}"] = (hist[-1]["acc_mean"], r.bytes_sent)
        line = (f"{p:14.1f} {hist[-1]['acc_mean']:8.4f} {r.bytes_sent / 1e6:9.1f} "
                f"{r.sim_time_s:10.2f}")
        if args.semantics != "sync":
            line += f" {hist[-1].get('vclock_median_s', float('nan')):18.2f}"
        if args.semantics == "async":
            line += f" {hist[-1].get('staleness_mean', float('nan')):10.2f}"
        print(line)
    return out


if __name__ == "__main__":
    main()
