"""Scheduler layer: when the steps fire and what time means.

Only the synchronous round barrier is ported.  A span of rounds is a
Python loop on the host that queues each round's work on the device; the
per-round metrics stay on the device until the span ends, when one host
sync reads them all.  The engine's ``chunk_rounds`` sets that cadence and
nothing else: batches, participation masks, crash windows and fault draws
are pure functions of the absolute round, each staged on the device once
per span, and the metrics are summed round by round in float64, so the
trajectory and the totals do not depend on it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import faults as faults_lib
from repro_torch.core.faults import STAT_KEYS
from repro_torch.core.steps import RoundFaults
from repro_torch.core.topology import stage_rounds


class SyncScheduler:
    """The synchronous round barrier: every node trains and mixes each
    round; the round's simulated time is the max over nodes.  ``eng`` is
    the owning RoundEngine; the scheduler reads its static resources and
    writes its running metrics (bytes_sent, sim_time_s)."""

    semantics = "sync"

    def __init__(self, eng):
        self.eng = eng
        # host float64 fault-counter totals, reported when a fault axis (a
        # FaultPlan or secure recovery) is on
        self._fault_totals = {k: 0.0 for k in STAT_KEYS}
        self._track_faults = eng.dl.faults is not None or (
            eng.dl.secure and eng.dl.secure_recovery)

    def participation_mask(self, start: int, n_rounds: int) -> np.ndarray:
        """(R, N) {0,1} activity masks for rounds [start, start+n_rounds),
        bitwise the reference's: a splitmix64 hash of (seed, absolute
        round, unit), so masks do not depend on the chunking.  The unit is
        the node, or with ``churn_machines=M`` the machine, whose
        round-robin node set drops together.  The last column is each
        round's fallback draw: if every unit drew down, one is kept up."""
        dl = self.eng.dl
        n = dl.n_nodes
        if dl.participation >= 1.0:
            return np.ones((n_rounds, n), np.float32)
        m_units = dl.churn_machines if dl.churn_machines > 0 else n
        with np.errstate(over="ignore"):  # uint64 wraparound is the point
            x = (
                np.uint64(dl.seed * 1_000_003 + 7_919)
                * np.uint64(0x9E3779B97F4A7C15)
                + np.arange(start, start + n_rounds, dtype=np.uint64)[:, None]
                * np.uint64(0xBF58476D1CE4E5B9)
                + np.arange(m_units + 1, dtype=np.uint64)[None, :]
                * np.uint64(0x94D049BB133111EB)
            )
            x ^= x >> np.uint64(30)
            x *= np.uint64(0xBF58476D1CE4E5B9)
            x ^= x >> np.uint64(27)
            x *= np.uint64(0x94D049BB133111EB)
            x ^= x >> np.uint64(31)
        u = (x >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)
        up = u[:, :m_units] < dl.participation
        dead = ~up.any(1)
        if dead.any():  # keep at least one unit alive per round
            up[dead, (u[dead, m_units] * m_units).astype(np.int64)] = True
        if dl.churn_machines > 0:
            up = up[:, np.arange(n) % dl.churn_machines]
        return up.astype(np.float32)

    def _stage_indices(self, start: int, n_rounds: int) -> torch.Tensor:
        """(R, L, N, B) sample indices of rounds [start, start+R) on the
        device, where the dataset already lives."""
        eng = self.eng
        idx = eng.batcher.chunk_indices(start, n_rounds, eng.dl.local_steps)
        return torch.as_tensor(idx, device=eng.device).long()

    def stage_topology(self, start: int, n_rounds: int) -> List[Tuple[object, Optional[tuple]]]:
        """Each round's mixing operand for rounds [start, start+n_rounds)
        and, for the dynamic overlay, the host form of its edges
        ``(nbr, live)`` (``sharing.participation_deg_eff``'s operands;
        None for a static overlay, whose edges the step layer holds).  The
        dynamic overlay stages the span's (R, N, D) tables, or with dense
        mixing its (R, N, N) W stack, in one copy and records the peak in
        ``eng.topo_stage_bytes_peak``."""
        eng = self.eng
        if eng.sampler is None:
            return [(eng._mix_static, None)] * n_rounds
        if eng.mix_mode == "sparse":
            st = eng.sampler.sparse_stack(start, n_rounds)
            staged = st.stage_bytes()
            ops = [(W, (st.nbr[r], st.w[r] > 0))
                   for r, W in enumerate(stage_rounds(st, eng.device))]
        else:
            Wst = eng.sampler.weights_stack(start, n_rounds)
            staged = int(Wst.nbytes)
            off = 1.0 - np.eye(Wst.shape[1], dtype=np.float32)
            Wd = torch.as_tensor(Wst, device=eng.device)
            ops = [(Wd[r], (None, Wst[r] * off > 0)) for r in range(n_rounds)]
        eng.topo_stage_bytes_peak = max(eng.topo_stage_bytes_peak, staged)
        return ops

    def stage_faults(self, start: int, n_rounds: int, topo) -> List[Optional[RoundFaults]]:
        """Each round's fault draws for rounds [start, start+n_rounds)
        (``faults.edge_draws`` over the round's edge layout, from ``topo``
        as :meth:`stage_topology` gives it, and ``faults.corruption_mask``),
        drawn on the host and staged on the device in one copy per family.
        None per round without a fault plan."""
        eng = self.eng
        plan, key = eng.steps.faults, eng.steps.fault_key
        if plan is None:
            return [None] * n_rounds
        n = eng.dl.n_nodes
        ids = torch.arange(n)
        fams: Dict[str, List[np.ndarray]] = {}
        for r in range(n_rounds):
            if plan.edge_faults:
                d = (topo[r][1] or eng.steps.live_edges)[1].shape[1]
                live, spike = faults_lib.edge_draws(key, start + r, ids, d, plan)
                fams.setdefault("live", []).append(live.numpy())
                fams.setdefault("spike", []).append(spike.numpy())
            if plan.corrupt_prob > 0:
                cm = faults_lib.corruption_mask(key, start + r, ids, plan)
                fams.setdefault("corrupt", []).append(cm.numpy())
        staged = {}
        for name, arrs in fams.items():
            host = np.stack(arrs)
            dev = torch.as_tensor(host, device=eng.device)
            staged[name] = [(dev[r], host[r]) for r in range(n_rounds)]
        return [RoundFaults(**{name: v[r] for name, v in staged.items()})
                for r in range(n_rounds)]

    def stage_activity(self, start: int, n_rounds: int) -> Tuple[Optional[np.ndarray], float]:
        """``(act, downtime)``: the (R, N) activity of rounds [start,
        start+n_rounds), the churn draw ANDed with the crash windows (None
        at full participation without crash windows), and the node-rounds
        the windows take down."""
        dl = self.eng.dl
        crashes = dl.faults is not None and bool(dl.faults.crashes)
        if dl.participation >= 1.0 and not crashes:
            return None, 0.0
        m = self.participation_mask(start, n_rounds)
        if not crashes:
            return m, 0.0
        cm = faults_lib.crash_mask(dl.faults, dl.n_nodes, start, n_rounds)
        return m * cm, float((1.0 - cm).sum())

    def run_span(self, start: int, n_rounds: int) -> None:
        eng = self.eng
        topo = self.stage_topology(start, n_rounds)
        idx = self._stage_indices(start, n_rounds)
        act_np, downtime = self.stage_activity(start, n_rounds)
        # crash downtime: injected faults survived by the churn machinery
        # (frozen state, reweighted mixing)
        self._fault_totals["faults_injected"] += downtime
        self._fault_totals["faults_survived"] += downtime
        act_dev = None if act_np is None else torch.as_tensor(act_np, device=eng.device)
        faults = self.stage_faults(start, n_rounds, topo)
        nbytes, times, stats = [], [], []
        for r in range(n_rounds):
            bx = eng._dev_x[idx[r]]  # (L, N, B, ...)
            by = eng._dev_y[idx[r]]
            act = None if act_np is None else (act_dev[r], act_np[r])
            W, live = topo[r]
            eng.X, eng.opt_state, eng.share_state, nb, t, fstats = eng.steps.train_and_mix(
                eng.X, eng.opt_state, eng.share_state, bx, by, W, start + r, act, live,
                faults[r],
            )
            nbytes.append(nb)
            times.append(t)
            stats.append(fstats)
        # one host sync for the span (the round times and the guard's
        # detections); per-round float64 sums in round order
        dev_keys = [(r, k) for r, st in enumerate(stats) for k, v in st.items()
                    if isinstance(v, torch.Tensor)]
        read = torch.stack(times + [stats[r][k] for r, k in dev_keys]).cpu().double().tolist()
        for (r, k), v in zip(dev_keys, read[n_rounds:]):
            stats[r][k] = v
        for nb, t, st in zip(nbytes, read[:n_rounds], stats):
            eng.bytes_sent += nb
            eng.sim_time_s += t
            for k in STAT_KEYS:
                self._fault_totals[k] += st[k]

    def extra_metrics(self) -> Dict:
        """Metrics merged into each history record: the running fault
        counters, when a fault plan or secure recovery is on."""
        if not self._track_faults:
            return {}
        t = self._fault_totals
        m = {k: int(round(t[k])) for k in STAT_KEYS if k != "recovery_bytes"}
        m["recovery_bytes"] = t["recovery_bytes"]
        return m


def make_scheduler(eng) -> SyncScheduler:
    sem = eng.dl.semantics
    if sem == "sync":
        return SyncScheduler(eng)
    raise NotImplementedError(f"semantics={sem!r} is not ported yet")
