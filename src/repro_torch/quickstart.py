"""Quickstart — the paper's Fig. 2 node loop on the port.

16 nodes, 5-regular static topology, GN-LeNet on the synthetic CIFAR-10
stand-in with 2-sharding non-IID data, plain SGD.  Writes
``results/torch_quickstart/results.json`` with the JAX quickstart's schema.

    PYTHONPATH=src python -m repro_torch.quickstart [--rounds 60] [--device cpu]
        [--shard-devices S]

``--shard-devices S`` shards the node axis over S ranks (``launch/shard.py``:
gloo ranks on the CPU, or ranks on the card); rank 0 prints and writes the
results, which equal the single-device run's.
"""
import argparse

from repro_torch.core import DLConfig, RoundEngine
from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
from repro_torch.models.api import cross_entropy
from repro_torch.models.cnn import cnn_apply, cnn_init
from repro_torch.optim import make_optimizer


def loss_fn(p, x, y):
    return cross_entropy(cnn_apply(p, x), y)


def acc_fn(p, x, y):
    return (cnn_apply(p, x).argmax(-1) == y).float().mean()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=10,
                    help="rounds per host sync of the metrics (0 = 1)")
    ap.add_argument("--network", default="none", choices=["none", "lan", "wan"],
                    help="simulated deployment for the wall-clock axis")
    ap.add_argument("--shard-devices", type=int, default=0,
                    help="shard the node axis over this many ranks (launch/shard.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--results-dir", default="results/torch_quickstart")
    args = ap.parse_args(argv)
    if args.shard_devices > 0:
        from repro_torch.launch import shard

        hist, nbytes, sim_t = shard.run(_run, args.shard_devices, args, device=args.device)
        _report(args, hist, nbytes, sim_t)
        return hist
    engine = _run(args, device=args.device)
    _report(args, engine.history, engine.bytes_sent, engine.sim_time_s)
    return engine


def _report(args, hist, nbytes, sim_t):
    print(f"\nfinal: acc {hist[-1]['acc_mean']:.4f} ± {hist[-1]['acc_std']:.4f}, "
          f"{nbytes / 1e6:.1f} MB sent/node "
          + (f"simulated {sim_t:.1f}s on {args.network}, "
             if args.network != "none" else "")
          + f"(results in {args.results_dir}/results.json)")


def _run(args, device=None):
    """The quickstart engine run to its end: the engine, or on a rank of a
    sharded run (history, bytes per node, simulated seconds)."""
    ds = make_dataset("cifar10", n_train=8192, n_test=512)
    parts = sharding_partition(ds.train_y, args.nodes, shards_per_node=2, seed=0)
    batcher = NodeBatcher(ds.train_x, ds.train_y, parts, batch_size=8, seed=0)
    dl = DLConfig(
        n_nodes=args.nodes,
        topology="regular", degree=5,
        sharing="full",
        local_steps=2, rounds=args.rounds, eval_every=10,
        chunk_rounds=args.chunk,
        network=args.network,
        shard_devices=args.shard_devices,
        results_dir=args.results_dir,
    )
    engine = RoundEngine(
        dl, lambda g: cnn_init(g, width=16), loss_fn, acc_fn,
        make_optimizer("sgd", 0.05), batcher, device=device,
    )
    engine.run()
    if args.shard_devices > 0:
        return engine.history, engine.bytes_sent, engine.sim_time_s
    return engine


if __name__ == "__main__":
    main()
