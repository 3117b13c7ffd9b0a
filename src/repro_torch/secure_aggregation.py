"""Secure aggregation (paper §3.4) on the port: pairwise cancellable masks
on a regular graph — the same accuracy trajectory as plain D-PSGD,
individual models hidden, ~3% byte overhead.  The twin of
``examples/secure_aggregation.py``, on the card unless ``--device`` names
another.

    PYTHONPATH=src python -m repro_torch.secure_aggregation [--rounds 30] [--nodes 16]
        [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import DecentralizedRunner, DLConfig, build_graph
from repro_torch.core.engine import resolve_device
from repro_torch.core.secure import SecureAggregation
from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
from repro_torch.models.mlp import mlp_init
from repro_torch.optim import make_optimizer
from repro_torch.topologies_dynamic import acc_fn, loss_fn


def masked_demo(X, device=None):
    """On the 8-node 4-regular graph with mask bound 5: the first masked
    message's distance from its sender's model (in units of the model's
    norm) and the masked aggregate's largest error against the plain
    Metropolis-Hastings aggregate.  ``X`` (8, P) fp32 numpy models."""
    dev = resolve_device(device)
    g = build_graph(DLConfig(n_nodes=8, topology="regular", degree=4))
    Xt = torch.as_tensor(X, device=dev)
    W = torch.as_tensor(g.metropolis_hastings().astype(np.float32), device=dev)
    s = SecureAggregation(g.adj, mask_bound=5.0)
    (i, _), m = next(iter(s.messages(Xt, prng.key(1), 0).items()))
    rel = float(torch.linalg.norm(m - Xt[i]) / torch.linalg.norm(Xt[i]))
    agg, _, _ = s.round(Xt, W, (), prng.key(1), degree=4.0, rnd=0)
    err = float((agg - W @ Xt).abs().max())
    return rel, err


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    ds = make_dataset("cifar10", n_train=8192, n_test=512)
    parts = sharding_partition(ds.train_y, args.nodes, 2, seed=0)
    batcher = NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0)

    results = {}
    for name, secure in (("d-psgd", False), ("secure-agg", True)):
        dl = DLConfig(n_nodes=args.nodes, topology="regular", degree=4, secure=secure,
                      rounds=args.rounds, eval_every=max(args.rounds - 1, 1), local_steps=2)
        r = DecentralizedRunner(dl, lambda g: mlp_init(g, hidden=128), loss_fn, acc_fn,
                                make_optimizer("sgd", 0.05), batcher, device=args.device)
        hist = r.run(log=False)
        results[name] = (hist[-1]["acc_mean"], r.bytes_sent)
        print(f"{name:12s} acc {hist[-1]['acc_mean']:.4f}  MB/node {r.bytes_sent/1e6:.1f}")

    overhead = results["secure-agg"][1] / results["d-psgd"][1] - 1
    print(f"\ncommunication overhead: {overhead:.1%} (paper: ~3%)")

    # an individual masked message is unreadable while the aggregate is exact
    X = np.random.default_rng(0).standard_normal((8, 1000)).astype(np.float32)
    rel, err = masked_demo(X, args.device)
    print(f"masked message vs raw model distance: {rel:.1f}x norm (unreadable)")
    print(f"aggregate vs plain MH aggregate max err: {err:.2e} (masks cancel)")
    return results


if __name__ == "__main__":
    main()
