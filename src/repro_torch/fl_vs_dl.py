"""FL emulation against DL on the port (paper Fig. 1: a node modified to
coordinate the training is the FL server).  The same dataset, non-IID
partition and optimizer drive one ``FederatedRunner`` run (a server and a
client subset per round) and one ``DecentralizedRunner`` run (5-regular
gossip, no server).  The twin of ``examples/fl_vs_dl.py``, on the card
unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.fl_vs_dl [--rounds 40] [--device cpu]
"""
import argparse

from repro_torch.core import DecentralizedRunner, DLConfig, FederatedRunner, FLConfig
from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
from repro_torch.models.mlp import mlp_init
from repro_torch.optim import make_optimizer
from repro_torch.topologies_dynamic import acc_fn, loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    ds = make_dataset("cifar10", n_train=1024, n_test=512, sigma=4.0)
    parts = sharding_partition(ds.train_y, args.nodes, 2, seed=0)
    batcher = NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0)
    init = lambda g: mlp_init(g, hidden=64)  # noqa: E731
    every = max(args.rounds // 4, 1)

    fl = FLConfig(n_clients=args.nodes, clients_per_round=args.nodes // 2, local_steps=4,
                  rounds=args.rounds, eval_every=every)
    r_fl = FederatedRunner(fl, init, loss_fn, acc_fn, make_optimizer("sgd", 0.05), batcher,
                           device=args.device)
    h_fl = r_fl.run(log=False)

    dl = DLConfig(n_nodes=args.nodes, topology="regular", degree=min(5, args.nodes - 1),
                  local_steps=4, rounds=args.rounds, eval_every=every)
    r_dl = DecentralizedRunner(dl, init, loss_fn, acc_fn, make_optimizer("sgd", 0.05), batcher,
                               device=args.device)
    h_dl = r_dl.run(log=False)

    print(f"{'round':>6s} {'FedAvg':>8s} {'D-PSGD':>8s}")
    fl_by_round = {h["round"]: h["acc"] for h in h_fl}
    dl_by_round = {h["round"]: h["acc_mean"] for h in h_dl}
    for r in sorted(set(fl_by_round) | set(dl_by_round)):
        print(f"{r:6d} {fl_by_round.get(r, float('nan')):8.4f} "
              f"{dl_by_round.get(r, float('nan')):8.4f}")
    print(f"\nD-PSGD bytes/node: {r_dl.bytes_sent / 1e6:.1f} MB "
          f"(FL server would carry {args.nodes // 2}x that inbound per round)")
    # FedAvg's bytes: each selected client downloads and uploads the model
    fl_bytes = 2.0 * r_dl.n_params * 4 * fl.clients_per_round * args.rounds / args.nodes
    return {"fedavg": (h_fl[-1]["acc"], fl_bytes), "d-psgd": (h_dl[-1]["acc_mean"], r_dl.bytes_sent)}


if __name__ == "__main__":
    main()
