"""Real-network backend demo on the port: K OS processes, real sockets, a
real kill.  The twin of ``examples/processes.py``; the workers run on the
card (all K sharing it) unless ``--device`` names another.

Spawns K worker processes that gossip the payload wire format over
localhost TCP (``DLConfig.backend="processes"``), SIGKILLs one of them
mid-run, and shows the survivors detecting the death (heartbeat failure
detector), reweighting the dead nodes' edges away
(``sharing.edge_reweight_sparse`` — surviving rows stay row-stochastic),
and finishing training.  Prints the merged history, survivor fault
counters, and the final consensus error over surviving rows.

With ``--rejoin`` the supervisor relaunches the killed worker with a
bumped membership epoch: it restores its row-block from the last
checkpoint (or cold-syncs from a live donor over STATE frames), runs the
two-phase JOIN handshake, and the survivors re-admit it with pristine
edge weights — the run ends with every row live again.

    PYTHONPATH=src python -m repro_torch.processes --nodes 16 --workers 4 \\
        --rounds 12 --kill-worker 3 --kill-at-round 4
    PYTHONPATH=src python -m repro_torch.processes --sharing randomk --quant
    PYTHONPATH=src python -m repro_torch.processes --rejoin [--device cpu]
"""
import argparse

from repro_torch.core import DLConfig
from repro_torch.runtime import ProcessRunner


def main(argv=None):
    ap = argparse.ArgumentParser(description="processes-backend kill demo")
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--degree", type=int, default=5)
    ap.add_argument("--sharing", default="full", choices=["full", "randomk"])
    ap.add_argument("--budget", type=float, default=0.1)
    ap.add_argument("--quant", action="store_true",
                    help="int8 + scale payload wire format")
    ap.add_argument("--kill-worker", type=int, default=None)
    ap.add_argument("--kill-at-round", type=int, default=None)
    ap.add_argument("--rejoin", action="store_true",
                    help="relaunch the killed worker and re-admit it "
                         "(crash-rejoin demo: more rounds, slower rounds)")
    ap.add_argument("--watchdog", type=float, default=60.0)
    ap.add_argument("--eval-every", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="the workers' torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.rejoin and args.rounds == 12:
        # the relaunch is a fresh python+torch boot with a CUDA context and
        # a warm-up (some ten seconds on the card); give the run enough
        # slow rounds (40 of at least 1 s) for the rejoiner to land mid-run
        args.rounds = 40
    if args.kill_worker is None and args.kill_at_round is None:
        # default demo: kill the last worker a third of the way in
        args.kill_worker = args.workers - 1
        args.kill_at_round = max(1, args.rounds // 3) if not args.rejoin else 3

    dl = DLConfig(
        n_nodes=args.nodes, topology="regular", degree=args.degree,
        sharing=args.sharing, budget=args.budget,
        payload_quant=args.quant, rounds=args.rounds,
        eval_every=args.eval_every, backend="processes",
    )
    workload = {"dataset": "cifar10", "model": "mlp", "width": 2,
                "n_train": 512, "n_test": 256, "lr": 0.05}
    if args.rejoin:
        runner = ProcessRunner(
            dl, workload, workers=args.workers,
            watchdog_s=max(args.watchdog, 120.0),
            chaos_plan=[{"worker": args.kill_worker,
                         "kill_at_round": args.kill_at_round,
                         "rejoin": True}],
            ckpt_every=4, round_min_s=1.0,
            dump_view=True, keep_run_dir=True, device=args.device,
        )
    else:
        runner = ProcessRunner(
            dl, workload, workers=args.workers, watchdog_s=args.watchdog,
            kill_worker=args.kill_worker, kill_at_round=args.kill_at_round,
            device=args.device,
        )
    runner.run(log=True)

    print("\n--- workers ---")
    for w, res in sorted(runner.worker_results.items()):
        c = res["counters"]
        extra = ""
        if res.get("rejoined"):
            extra = (f" REJOINED epoch={res['epoch']} "
                     f"start_round={res['start_round']} "
                     f"catchup={res['catchup_source']} "
                     f"({c['catchup_bytes']} B)")
        print(f"worker {w}: rows {res['rows']}  "
              f"faults_detected={c['faults_detected']} "
              f"retries={c['retry_total']} leaves={c['leaves']} "
              f"stale_dropped={c['stale_frames_dropped']} "
              f"dead_peers={res['dead_peers']} "
              f"row_err={res['reweight_row_err']:.2e}{extra}")
    print(f"\nkilled worker {args.kill_worker} after round "
          f"{runner.killed_at_round}; surviving rows "
          f"{int(runner.live_rows.sum())}/{args.nodes}")
    print(f"merged counters: {runner.counters}")
    print(f"max |row_sum - 1| after reweight: {runner.reweight_row_err:.2e}")
    print(f"final acc: {runner.history[-1]['acc_mean']:.4f}")
    print(f"final consensus error: {runner.consensus_error():.4f}")
    assert runner.counters["faults_detected"] >= 1, "no survivor detected the kill"
    assert runner.reweight_row_err < 1e-5, "reweighted rows must stay stochastic"
    if args.rejoin:
        views = runner.verify_rejoin_views()
        print(f"rejoin conservation ok: {runner.conservation['ok']}; "
              f"bitwise views: {views}")
        assert runner.workers_rejoined == 1, "the killed worker never rejoined"
        assert runner.conservation["ok"], runner.conservation
        assert all(views.values()), "rejoiner row-block diverged from survivors"
    return runner


if __name__ == "__main__":
    main()
