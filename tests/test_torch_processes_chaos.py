"""Real faults on the port's process backend, on the CPU: K=4 worker
processes, N=16 nodes, the workload of ``tests/test_runtime.py``.

- Kill, detect, reweight: SIGKILL one worker mid-run; every survivor's
  heartbeat detector fires, the dead rows' edges are reweighted away
  (surviving rows stay row-stochastic) and the survivors finish every
  round.
- Kill and rejoin: SIGKILL one worker and relaunch it; it restores its
  checkpoint, the survivors re-admit it at a committed round with the
  pristine weights, conservation holds on every worker, and a survivor's
  view of the rejoiner's rows equals what it last sent, byte for byte.

Both runs are sized for a loaded host (several test processes, each with
K workers): a 6 s silence declares death, a send may wait 60 s for a
starved reader (a killed worker's socket fails at once), and the rejoin
run's rounds last at least 0.6 s, so a relaunch that boots slowly still
lands well before the end.
"""
import numpy as np

from repro_torch.core import DLConfig
from repro_torch.runtime import ProcessRunner

WL = {"dataset": "cifar10", "model": "mlp", "width": 1,
      "n_train": 256, "n_test": 128, "lr": 0.05}


def test_kill_worker_detect_reweight_converge():
    dl = DLConfig(n_nodes=16, topology="regular", degree=5, rounds=8, eval_every=4,
                  backend="processes", seed=5)
    r = ProcessRunner(dl, WL, workers=4, watchdog_s=120.0, dead_timeout_s=6.0,
                      send_timeout_s=60.0, kill_worker=3, kill_at_round=2, device="cpu")
    hist = r.run(log=False)
    assert r.killed_at_round is not None
    assert r.counters["faults_detected"] >= 1
    assert r.reweight_row_err < 1e-5
    assert int(r.live_rows.sum()) == 12
    assert hist[-1]["round"] == 7  # survivors finished every round
    assert np.isfinite(r.final_X[r.live_rows]).all()
    assert np.isnan(r.final_X[~r.live_rows]).all()
    assert np.isfinite(r.consensus_error())
    for w, res in r.worker_results.items():
        assert res["dead_peers"] == [3] and res["completed"], (w, res)
    assert r.conservation["ok"]


def test_kill_rejoin_heals_the_mesh(tmp_path):
    dl = DLConfig(n_nodes=16, topology="regular", degree=5, rounds=40, eval_every=10,
                  backend="processes", seed=7)
    r = ProcessRunner(
        dl, WL, workers=4, watchdog_s=120.0, dead_timeout_s=6.0, send_timeout_s=60.0,
        device="cpu",
        chaos_plan=[{"worker": 2, "kill_at_round": 4, "rejoin": True}],
        ckpt_every=4, round_min_s=0.6, dump_view=True,
        keep_run_dir=True, run_dir=str(tmp_path),
    )
    hist = r.run(log=False)
    assert r.workers_rejoined == 1
    assert r.counters["rejoin_total"] >= 1
    assert r.conservation["ok"], r.conservation
    assert hist[-1]["round"] == 39            # nobody stalled
    assert hist[-1]["n_live_rows"] == 16      # all rows healed
    res = r.worker_results[2]
    assert res["rejoined"] and res["completed"]
    assert res["epoch"] == 1
    assert res["catchup_source"].startswith("checkpoint:")
    assert res["counters"]["catchup_bytes"] > 0
    assert r.verify_rejoin_views() == {2: True}
    assert np.isfinite(r.final_X).all()       # no NaN rows remain
    assert np.isfinite(r.consensus_error())
