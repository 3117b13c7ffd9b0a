"""Fault-tolerant gossip on the port: message-level fault injection end
to end.  The twin of ``examples/faults.py``, on the card unless
``--device`` names another.

Sweeps ``FaultPlan.msg_loss`` (or, with ``--secure``, runs secure
aggregation with the seed-recovery pass) and prints the fault counters of
each run's last history record: pure loss is survived by design
(injected == survived); ``--corrupt`` adds post-mix corruption, which the
step guard detects and rolls back (injected == detected == recovered);
``--crash N:D:R`` takes node N down for rounds [D, R) (R = -1: for good).

    PYTHONPATH=src python -m repro_torch.faults [--rounds 40] [--device cpu]
    PYTHONPATH=src python -m repro_torch.faults --participation 0.7 --secure
    PYTHONPATH=src python -m repro_torch.faults --corrupt 0.05 --crash 3:5:12
"""
import argparse

from repro_torch.core import DecentralizedRunner, DLConfig, FaultPlan
from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
from repro_torch.models.mlp import mlp_init
from repro_torch.optim import make_optimizer
from repro_torch.topologies_dynamic import acc_fn, loss_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--secure", action="store_true",
                    help="secure aggregation + seed recovery (composes with churn and "
                         "crashes, not msg_loss)")
    ap.add_argument("--corrupt", type=float, default=0.0,
                    help="per-node payload corruption probability")
    ap.add_argument("--crash", action="append", default=[], metavar="N:D:R",
                    help="crash node N for rounds [D, R)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    crashes = tuple(tuple(int(v) for v in c.split(":")) for c in args.crash)
    ds = make_dataset("cifar10", n_train=8192, n_test=512)
    parts = sharding_partition(ds.train_y, args.nodes, 2, seed=0)
    batcher = NodeBatcher(ds.train_x, ds.train_y, parts, 8, seed=0)

    losses = (0.0,) if args.secure else (0.0, 0.05, 0.1, 0.2)
    print(f"{'msg_loss':>9s} {'acc':>8s} {'sim LAN s':>10s} {'injected':>9s} "
          f"{'detected':>9s} {'survived':>9s} {'recovered':>10s} {'recovery MB':>12s}")
    out = {}
    for p_loss in losses:
        plan = None
        if p_loss > 0 or args.corrupt > 0 or crashes:
            plan = FaultPlan(msg_loss=p_loss, corrupt_prob=args.corrupt, crashes=crashes)
        dl = DLConfig(n_nodes=args.nodes, topology="regular", degree=min(5, args.nodes - 1),
                      rounds=args.rounds, eval_every=max(args.rounds - 1, 1), local_steps=2,
                      participation=args.participation, network="lan", compute_time_s=0.05,
                      faults=plan, secure=args.secure, secure_recovery=args.secure)
        r = DecentralizedRunner(dl, lambda g: mlp_init(g, hidden=128), loss_fn, acc_fn,
                                make_optimizer("sgd", 0.05), batcher, device=args.device)
        rec = r.run(log=False)[-1]
        out[f"msg_loss={p_loss}"] = (rec["acc_mean"], r.bytes_sent)
        print(f"{p_loss:9.2f} {rec['acc_mean']:8.4f} {r.sim_time_s:10.2f} "
              f"{rec.get('faults_injected', 0):9d} {rec.get('faults_detected', 0):9d} "
              f"{rec.get('faults_survived', 0):9d} {rec.get('faults_recovered', 0):10d} "
              f"{rec.get('recovery_bytes', 0.0) / 1e6:12.3f}")
    return out


if __name__ == "__main__":
    main()
