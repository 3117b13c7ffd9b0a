"""ProcessRunner — launch, monitor, kill/relaunch, and merge.

The launcher side of the processes backend: hosts the rendezvous
registry, spawns K ``repro_torch.runtime.peer`` worker processes (real
``subprocess`` children of a fresh interpreter each — killable with a
real SIGKILL, and never a ``fork`` of a process that holds a CUDA
context), watches their crash-consistent progress files, and merges the
per-worker results into the engine-shaped history every entry point
understands.

The launcher doubles as the elastic-membership **supervisor**: a
``chaos_plan`` entry ``{"worker": w, "kill_at_round": r, "rejoin": bool}``
SIGKILLs worker w once its progress reaches round r and — when
``rejoin`` — immediately relaunches it with ``--rejoin --epoch E`` (the
epoch bumps by one per relaunch, so survivors reject the corpse's stale
frames by integer compare).  With ``supervise=True`` the same relaunch
also fires on an *unplanned* death: a worker that exits without results,
or whose progress file goes stale past ``stall_timeout_s``.  A relaunch
re-arms a worker's next chaos entry only after its *new* incarnation
writes progress (mtime gating), so a pre-crash progress value cannot
double-trigger.

Workers rebuild the experiment from a *declarative* workload spec
(:func:`build_workload`) — callables cannot cross a process boundary —
and the oracle tests call the same function, so the simulator and the
workers cannot construct different experiments.  ``device`` (None: the
card) reaches every worker through the spec; ``init_params`` (a
node-stacked tree, as ``RoundEngine`` takes it) is written to the run
directory as one (N, P) fp32 matrix, of which each worker loads its rows.
On the card the launcher builds the kernels the workers launch before it
spawns them, so K workers do not start K compiler runs of one source.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.membership import RUNTIME_COUNTER_KEYS
from repro_torch.utils.io import atomic_write_json


def build_workload(wl: Dict, dl) -> Tuple[Callable, Callable, Callable, Any, Any]:
    """(init_params_fn(generator), loss_fn, acc_fn, optimizer, batcher)
    from a declarative workload spec — the JAX package's construction
    (dataset seed 7, label-sharded partitions, per-config seeds) on the
    port's data, models and optimizers, shared by the worker processes and
    the launcher-side equivalence oracle.  ``model="cnn"`` is GN-LeNet at
    ``width``, ``"mlp"`` the MLP with ``8 * width`` hidden units."""
    from repro_torch.data import NodeBatcher, make_dataset, sharding_partition
    from repro_torch.models.api import cross_entropy
    from repro_torch.optim import make_optimizer

    dataset = wl.get("dataset", "cifar10")
    kw = {} if dataset in ("teacher", "cifar10-hard", "lm") else {
        "sigma": wl.get("sigma", 4.0)
    }
    ds = make_dataset(
        dataset, n_train=wl.get("n_train", 1024),
        n_test=wl.get("n_test", 512), seed=wl.get("data_seed", 7), **kw,
    )
    parts = sharding_partition(
        ds.train_y, dl.n_nodes, wl.get("shards_per_node", 2), seed=dl.seed
    )
    batcher = NodeBatcher(
        ds.train_x, ds.train_y, parts, dl.batch_size, seed=dl.seed
    )
    model, width = wl.get("model", "mlp"), wl.get("width", 16)
    if model == "cnn":
        from repro_torch.models.cnn import cnn_apply, cnn_init

        init = lambda g: cnn_init(g, width=width)  # noqa: E731
        apply = cnn_apply
    else:
        from repro_torch.models.mlp import mlp_apply, mlp_init

        init = lambda g: mlp_init(g, hidden=8 * width)  # noqa: E731
        apply = mlp_apply

    def loss_fn(p, x, y):
        return cross_entropy(apply(p, x), y)

    def acc_fn(p, x, y):
        return (apply(p, x).argmax(-1) == y).float().mean()

    opt = make_optimizer(wl.get("optimizer", "sgd"), wl.get("lr", 0.05))
    return init, loss_fn, acc_fn, opt, batcher


def _src_root() -> str:
    """The directory holding the ``repro_torch`` package."""
    import repro_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))


def worker_libraries(dl) -> Tuple[str, ...]:
    """The CUDA sources a worker of this config launches kernels from."""
    if dl.sharing.lower() in ("randomk", "random"):
        return ("scatter_gossip", "quantize") if dl.payload_quant else ("scatter_gossip",)
    return ("gossip_mix",)


class ProcessRunner:
    """Run a ``backend='processes'`` experiment as K worker processes.

    kill_worker/kill_at_round: SIGKILL that worker once its progress file
    reaches the given round — the built-in fault injector for the real
    backend (the simulated backend's ``FaultPlan`` does not apply here).
    device: the workers' torch device (None: the card; raises without
    one).  init_params: a node-stacked parameter tree replacing the
    per-node initial draws.
    """

    def __init__(
        self,
        dl,
        workload: Dict,
        *,
        workers: int = 4,
        run_dir: Optional[str] = None,
        hb_interval_s: float = 0.25,
        dead_timeout_s: float = 3.0,
        watchdog_s: float = 60.0,
        send_timeout_s: float = 10.0,
        join_timeout_s: float = 60.0,
        retry_backoff_s: float = 0.05,
        retry_backoff_cap: int = 5,
        kill_worker: Optional[int] = None,
        kill_at_round: Optional[int] = None,
        chaos_plan: Optional[List[Dict]] = None,
        supervise: bool = False,
        stall_timeout_s: Optional[float] = None,
        max_relaunches: int = 2,
        ckpt_every: int = 0,
        round_min_s: float = 0.0,
        dump_view: bool = False,
        timeout_s: Optional[float] = None,
        keep_run_dir: bool = False,
        device=None,
        init_params: Optional[Dict] = None,
    ):
        from repro_torch.core.engine import resolve_device

        dl.validate()
        if dl.backend != "processes":
            raise ValueError(
                "ProcessRunner is the backend='processes' launcher; set "
                f"DLConfig.backend='processes' (got {dl.backend!r})"
            )
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if dl.n_nodes % workers:
            raise ValueError(
                f"n_nodes={dl.n_nodes} must divide evenly over "
                f"workers={workers} (each worker owns a row-block)"
            )
        if (kill_worker is None) != (kill_at_round is None):
            raise ValueError(
                "kill_worker and kill_at_round come as a pair"
            )
        if kill_worker is not None and not 0 <= kill_worker < workers:
            raise ValueError(f"kill_worker {kill_worker} out of range")
        # normalize the legacy kill pair into a one-entry chaos plan
        self.chaos_plan = [dict(e) for e in (chaos_plan or [])]
        if kill_worker is not None:
            self.chaos_plan.append({
                "worker": kill_worker, "kill_at_round": kill_at_round,
                "rejoin": False,
            })
        for e in self.chaos_plan:
            w = e.get("worker")
            if not isinstance(w, int) or not 0 <= w < workers:
                raise ValueError(f"chaos_plan worker {w!r} out of range")
            r = e.get("kill_at_round")
            if not isinstance(r, int) or r < 0:
                raise ValueError(
                    f"chaos_plan kill_at_round {r!r} must be an int >= 0"
                )
            e["rejoin"] = bool(e.get("rejoin", True))
        self.chaos_plan.sort(key=lambda e: (e["kill_at_round"], e["worker"]))
        self.device = str(resolve_device(device))
        self.dl = dl
        self.workload = dict(workload)
        self.init_params = init_params
        self.workers = workers
        self.kill_worker = kill_worker
        self.kill_at_round = kill_at_round
        self.supervise = supervise
        self.stall_timeout_s = stall_timeout_s
        self.max_relaunches = int(max_relaunches)
        self.keep_run_dir = keep_run_dir
        self._cfg = dict(
            hb_interval_s=hb_interval_s, dead_timeout_s=dead_timeout_s,
            watchdog_s=watchdog_s, send_timeout_s=send_timeout_s,
            join_timeout_s=join_timeout_s, retry_backoff_s=retry_backoff_s,
            retry_backoff_cap=retry_backoff_cap, ckpt_every=int(ckpt_every),
            round_min_s=float(round_min_s), dump_view=bool(dump_view),
        )
        self.timeout_s = (
            timeout_s if timeout_s is not None
            else join_timeout_s + 2 * watchdog_s
            + (2.0 + round_min_s) * dl.rounds + 120.0
        )
        self.run_dir = run_dir
        # engine-shaped surface
        self.history: List[Dict] = []
        self.bytes_sent = 0.0
        self.sim_time_s = 0.0
        self.round_wall_s: List[float] = []
        self.n_params: Optional[int] = None
        self.counters: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}
        self.worker_results: Dict[int, Dict] = {}
        self.final_X: Optional[np.ndarray] = None
        self.live_rows: Optional[np.ndarray] = None
        self.killed_at_round: Optional[int] = None
        self.epochs: Dict[int, int] = {w: 0 for w in range(workers)}
        self.kill_events: List[Dict] = []
        self.workers_rejoined = 0
        self.conservation: Dict[str, Any] = {}
        self.reweight_row_err = 0.0
        self.wire_dtype = (
            "int8" if (dl.payload_quant and dl.sharing.lower() in
                       ("randomk", "random")) else "float32"
        )

    # ------------------------------------------------------------------
    def _progress(self, wid: int) -> int:
        try:
            with open(os.path.join(self.run_dir, f"w{wid}.progress")) as f:
                return int(f.read().strip() or -1)
        except (OSError, ValueError):
            return -1

    @staticmethod
    def _tail(path: str, n: int = 20) -> str:
        try:
            with open(path, errors="replace") as f:
                return "".join(f.readlines()[-n:])
        except OSError:
            return "<no log>"

    def _write_init(self) -> Optional[str]:
        """The injected parameters as one (N, P) fp32 matrix in the run
        directory, rows in ``tree_vector`` order (sorted keys)."""
        if self.init_params is None:
            return None
        import torch

        from repro_torch.utils.pytree import tree_leaves

        n = self.dl.n_nodes
        X = torch.cat([torch.as_tensor(l).detach().cpu().reshape(n, -1).to(torch.float32)
                       for l in tree_leaves(self.init_params)], 1)
        path = os.path.join(self.run_dir, "init_X.npy")
        np.save(path, X.numpy())
        return path

    def run(self, rounds: Optional[int] = None, log: bool = True) -> List[Dict]:
        from repro_torch.runtime.transport import RendezvousServer

        rounds = rounds if rounds is not None else self.dl.rounds
        own_dir = self.run_dir is None
        if own_dir:
            self.run_dir = tempfile.mkdtemp(prefix="repro-torch-procs-")
        os.makedirs(self.run_dir, exist_ok=True)
        if self.device.startswith("cuda"):
            # one compiler run per source, here, before K workers load it
            from repro_torch.kernels.build import build

            for lib in worker_libraries(self.dl):
                build(lib)
        spec = {
            "dl": dataclasses.asdict(self.dl),
            "workload": self.workload,
            "workers": self.workers,
            "rounds": rounds,
            "run_dir": self.run_dir,
            "device": self.device,
            "init_params": self._write_init(),
            **self._cfg,
        }
        rdv = RendezvousServer(self.workers)
        host, port = rdv.start()
        spec["rendezvous"] = [host, port]
        spec_path = os.path.join(self.run_dir, "spec.json")
        atomic_write_json(spec_path, spec)
        env = dict(os.environ)
        env["PYTHONPATH"] = _src_root() + os.pathsep + env.get("PYTHONPATH", "")
        procs: Dict[int, subprocess.Popen] = {}
        logs = {w: os.path.join(self.run_dir, f"w{w}.log")
                for w in range(self.workers)}
        armed_after: Dict[int, float] = {}
        relaunches = {w: 0 for w in range(self.workers)}
        gone_for_good: set = set()  # killed with no relaunch coming
        plan = list(self.chaos_plan)

        def _launch(w: int, *, rejoin: bool = False):
            cmd = [sys.executable, "-m", "repro_torch.runtime.peer",
                   "--spec", spec_path, "--worker", str(w),
                   "--epoch", str(self.epochs[w])]
            if rejoin:
                cmd.append("--rejoin")
            with open(logs[w], "a") as lf:
                procs[w] = subprocess.Popen(
                    cmd, stdout=lf, stderr=subprocess.STDOUT, env=env
                )
            armed_after[w] = time.time()

        def _relaunch(w: int, why: str):
            self.epochs[w] += 1
            relaunches[w] += 1
            _launch(w, rejoin=True)
            if log:
                print(f"[runner] relaunch worker {w} epoch "
                      f"{self.epochs[w]} ({why})", flush=True)

        def _progress_fresh(w: int) -> bool:
            # only the *current* incarnation's progress arms a trigger —
            # a pre-crash progress value must not double-fire
            try:
                return os.path.getmtime(os.path.join(
                    self.run_dir, f"w{w}.progress")) > armed_after[w]
            except OSError:
                return False

        try:
            for w in range(self.workers):
                _launch(w)
            deadline = time.time() + self.timeout_s
            while any(p.poll() is None for p in procs.values()):
                # planned chaos kills
                for e in list(plan):
                    w = e["worker"]
                    if w in gone_for_good or procs[w].poll() is not None:
                        continue
                    if (_progress_fresh(w)
                            and self._progress(w) >= e["kill_at_round"]):
                        rnd = self._progress(w)
                        os.kill(procs[w].pid, signal.SIGKILL)
                        procs[w].wait()
                        self.kill_events.append({
                            "worker": w, "round": rnd,
                            "rejoin": e["rejoin"],
                            "epoch": self.epochs[w], "cause": "chaos",
                        })
                        if self.killed_at_round is None:
                            self.killed_at_round = rnd
                        if log:
                            print(f"[runner] SIGKILL worker {w} after "
                                  f"round {rnd}"
                                  + (" (rejoin)" if e["rejoin"] else ""),
                                  flush=True)
                        plan.remove(e)
                        if e["rejoin"]:
                            _relaunch(w, "chaos kill")
                        else:
                            gone_for_good.add(w)
                # unplanned deaths / stalls (supervision)
                if self.supervise:
                    for w in range(self.workers):
                        if (w in gone_for_good
                                or relaunches[w] >= self.max_relaunches):
                            continue
                        p = procs[w]
                        res = os.path.join(
                            self.run_dir, f"worker_{w}.json")
                        if p.poll() is not None and not os.path.exists(res):
                            self.kill_events.append({
                                "worker": w, "round": self._progress(w),
                                "rejoin": True, "epoch": self.epochs[w],
                                "cause": f"exit {p.returncode}",
                            })
                            _relaunch(w, f"unexpected exit "
                                         f"{p.returncode}")
                        elif (self.stall_timeout_s is not None
                                and p.poll() is None):
                            try:
                                mt = os.path.getmtime(os.path.join(
                                    self.run_dir, f"w{w}.progress"))
                            except OSError:
                                mt = armed_after[w]
                            last = max(mt, armed_after[w])
                            if time.time() - last > self.stall_timeout_s:
                                os.kill(p.pid, signal.SIGKILL)
                                p.wait()
                                self.kill_events.append({
                                    "worker": w,
                                    "round": self._progress(w),
                                    "rejoin": True,
                                    "epoch": self.epochs[w],
                                    "cause": "stall",
                                })
                                _relaunch(w, "progress stall")
                if time.time() > deadline:
                    for p in procs.values():
                        if p.poll() is None:
                            p.kill()
                    tails = "\n".join(
                        f"--- worker {w} ---\n{self._tail(logs[w])}"
                        for w in range(self.workers)
                    )
                    raise RuntimeError(
                        f"processes-backend run exceeded {self.timeout_s}s; "
                        f"killed all workers.\n{tails}"
                    )
                time.sleep(0.02)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            rdv.stop()
        # --- collect ----------------------------------------------------
        for w in range(self.workers):
            path = os.path.join(self.run_dir, f"worker_{w}.json")
            if os.path.exists(path):
                with open(path) as f:
                    self.worker_results[w] = json.load(f)
            elif w not in gone_for_good and procs[w].returncode != 0:
                raise RuntimeError(
                    f"worker {w} exited {procs[w].returncode} without "
                    f"results:\n{self._tail(logs[w])}"
                )
        if not self.worker_results:
            raise RuntimeError(
                "no worker produced results:\n"
                + "\n".join(self._tail(p) for p in logs.values())
            )
        self._merge(log)
        if self.dl.results_dir:
            atomic_write_json(
                os.path.join(self.dl.results_dir, "results.json"),
                {"config": dataclasses.asdict(self.dl),
                 "history": self.history},
            )
        if own_dir and not self.keep_run_dir:
            shutil.rmtree(self.run_dir, ignore_errors=True)
        return self.history

    # ------------------------------------------------------------------
    def _merge(self, log: bool):
        n = self.dl.n_nodes
        res = self.worker_results
        self.n_params = next(iter(res.values()))["n_params"]
        self.live_rows = np.zeros(n, bool)
        self.final_X = np.full((n, self.n_params), np.nan, np.float32)
        for w, r in res.items():
            lo, hi = r["rows"]
            self.live_rows[lo:hi] = True
            xp = os.path.join(self.run_dir, f"worker_{w}_X.npy")
            if os.path.exists(xp):
                self.final_X[lo:hi] = np.load(xp)
            self.reweight_row_err = max(
                self.reweight_row_err, r["reweight_row_err"]
            )
        # per-round wall: elementwise max over workers (the sync barrier)
        walls = [r["round_wall_s"] for r in res.values()]
        for i in range(max(len(ws) for ws in walls)):
            self.round_wall_s.append(
                max(ws[i] for ws in walls if i < len(ws))
            )
        for key in RUNTIME_COUNTER_KEYS:
            self.counters[key] = sum(
                r["counters"].get(key, 0) for r in res.values()
            )
        # kernel launches of the rounds (warm-up excluded), over workers
        self.launches = {k: sum(r["launches"][k] for r in res.values())
                         for k in next(iter(res.values()))["launches"]}
        self.workers_rejoined = sum(
            1 for r in res.values() if r.get("rejoined")
        )
        # per-worker conservation: every detection either stays dead or
        # was re-admitted (the chaos gate's bookkeeping invariant)
        per_worker = {}
        for w, r in res.items():
            c = r["counters"]
            per_worker[str(w)] = {
                "detected": int(c.get("faults_detected", 0)),
                "still_dead": len(r.get("dead_peers", [])),
                "rejoined": int(c.get("rejoin_total", 0)),
            }
        self.conservation = {
            "per_worker": per_worker,
            "ok": all(
                d["detected"] == d["still_dead"] + d["rejoined"]
                for d in per_worker.values()
            ),
        }
        by_round: Dict[int, List[Dict]] = {}
        for r in res.values():
            for rec in r["history"]:
                by_round.setdefault(rec["round"], []).append(rec)
        for rnd in sorted(by_round):
            recs = by_round[rnd]
            accs = np.concatenate([np.asarray(r["accs"]) for r in recs])
            total_bytes = float(sum(r["bytes_wire"] for r in recs))
            rec = {
                "round": rnd,
                "acc_mean": float(accs.mean()),
                "acc_std": float(accs.std()),
                "bytes_per_node": total_bytes / n,
                "wall_s": max(r["wall_s"] for r in recs),
                "sim_time_s": 0.0,
                "wire_dtype": self.wire_dtype,
                "n_live_rows": int(len(accs)),
                "workers_reporting": len(recs),
                "faults_detected": sum(r["faults_detected"] for r in recs),
                "retry_total": sum(r["retry_total"] for r in recs),
            }
            self.history.append(rec)
            if log:
                print(
                    f"[processes/{self.workers}w] round {rnd:4d} "
                    f"acc {rec['acc_mean']:.4f}±{rec['acc_std']:.4f} "
                    f"MB/node {rec['bytes_per_node'] / 1e6:.2f} "
                    f"rows {rec['n_live_rows']}/{n}",
                    flush=True,
                )
        self.bytes_sent = (
            self.history[-1]["bytes_per_node"] if self.history else 0.0
        )

    # ------------------------------------------------------------------
    def verify_rejoin_views(self) -> Dict[int, bool]:
        """Bitwise post-catch-up check (full sharing, ``dump_view=True``,
        ``keep_run_dir=True``): for every rejoined worker v, a surviving
        worker's final view of v's rows must equal — byte for byte — the
        rows v last put on the wire.  Proves the rejoiner was genuinely
        re-admitted into the final barrier, not merely reweighted back in
        approximately."""
        out: Dict[int, bool] = {}
        res = self.worker_results
        for v, rv in res.items():
            if not rv.get("rejoined") or not rv.get("completed"):
                continue
            sent_p = os.path.join(self.run_dir, f"worker_{v}_sent.npy")
            if not os.path.exists(sent_p):
                raise RuntimeError(
                    "verify_rejoin_views needs dump_view=True and "
                    "keep_run_dir=True"
                )
            sent = np.load(sent_p)
            lo = rv["rows"][0]
            ok = None
            for s, rs in res.items():
                if s == v or not rs.get("completed"):
                    continue
                ids = rs.get("need_from", {}).get(str(v), [])
                if not ids:
                    continue
                view = np.load(os.path.join(
                    self.run_dir, f"worker_{s}_view.npy"))
                ids = np.asarray(ids, np.int64)
                same = np.array_equal(view[ids], sent[ids - lo])
                ok = same if ok is None else (ok and same)
            out[v] = bool(ok) if ok is not None else False
        return out

    # ------------------------------------------------------------------
    def consensus_error(self) -> float:
        """mean_i ||x_i - x̄|| / (||x̄|| + eps) over surviving rows — the
        disagreement metric the examples print."""
        X = self.final_X[self.live_rows]
        xbar = X.mean(0)
        denom = np.linalg.norm(xbar) + 1e-12
        return float(
            np.mean(np.linalg.norm(X - xbar[None, :], axis=1)) / denom
        )
