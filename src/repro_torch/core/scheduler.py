"""Scheduler layer: when the steps fire and what time means.

Three schedulers implement ``DLConfig.semantics``:

* ``sync`` (:class:`SyncScheduler`) — the synchronous round barrier: every
  node trains and mixes each round; the round's simulated time is the max
  over nodes.
* ``local`` (:class:`LocalScheduler`) — the same trajectories, but each
  node runs on its own virtual clock with a neighbourhood barrier: node i
  starts round r once it and its live neighbours have finished round r-1.
  The simulated time is the largest clock, a running maximum.
* ``async`` (:class:`AsyncScheduler`) — event-driven gossip on a virtual
  clock (AD-PSGD): each step fires the nodes whose next event lands in the
  earliest time slice; a fired node takes a local step, gossips against
  possibly stale neighbour rows (its whole neighbourhood, or one sampled
  partner) and reschedules its next event.  With ``cohort_capacity=C`` a
  step gathers only the C earliest in-slice rows, runs the same step on
  them and scatters them back into the population, whose cold rows may
  live in bf16 or int8 (``cold_dtype``).

A span of rounds (or event steps) is a Python loop on the host that
queues each step's work on the device; the per-step metrics stay on the
device until the span ends, when one host sync reads them all.  The
engine's ``chunk_rounds`` sets that cadence and nothing else: batches,
participation masks, crash windows and fault draws are pure functions of
the absolute round, each staged on the device once per span.  Two host
reads are added on the async path: the clock rebase check after each
span, and under ``selection="hier"`` whether a step's slice is covered by
the selected segments (the reference's ``lax.cond``), once per step.
``chunk_rounds=0`` (synchronous only) is the JAX package's legacy
per-round dispatch, :meth:`SyncScheduler.run_legacy_round`: the round's
batches gathered on the host, and one host read of its metrics a round.

Node-sharded runs (``shard_devices``, the synchronous scheduler only):
every rank stages the span's global host inputs as the single-device
engine does and keeps its own rows of the batches and masks; the round
times are reduced over the ranks (``pmax``) once per span, before the one
host read.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import compression as compression_lib
from repro_torch.core import faults as faults_lib
from repro_torch.core.faults import STAT_KEYS
from repro_torch.core.mixing import ShardedDense, gossip_pair_avg, shard_topology
from repro_torch.core.sharing import (
    edge_reweight,
    edge_reweight_sparse,
    live_edge_mask,
    participation_deg_eff,
    participation_reweight_rows,
)
from repro_torch.core.steps import RoundFaults, node_where
from repro_torch.core.topology import SparseTopology, gather_rows, sample_neighbor_slots, stage_rounds
from repro_torch.data.loader import node_batch_indices
from repro_torch.kernels.gossip_mix import gossip_mix_rows
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unvector

# virtual-clock rebase threshold (the reference's): once every pending
# event time is past it, a common fp32 shift leaves t_next/vclock for a
# float64 host offset, so millisecond event durations are not absorbed
_REBASE_T_S = 65536.0

# selection="auto" takes the segment hierarchy from this node count on
_HIER_AUTO_MIN_N = 1 << 18


def _f32(x: float, like) -> torch.Tensor:
    """``x`` rounded to fp32, as a 0-d tensor on ``like``'s device.  The
    reference's per-step bytes divide by the node count, a constant that
    XLA turns into a multiplication by its fp32 reciprocal; the port
    multiplies by ``_f32(1.0 / n)`` to match them bitwise."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _live_edges(W, act):
    """``(live, gather)``: the live off-diagonal edges of a mixing operand
    pruned by a churn mask ``act`` (device (N,) or None) — (N, D) over the
    neighbour slots of a SparseTopology, (N, N) for a dense W — and
    ``gather(v)``, which aligns an (N,) vector with them."""
    if isinstance(W, SparseTopology):
        nbr = W.nbr.long()
        live = W.w > 0
        if act is not None:
            live = live & (act[:, None] > 0) & (act[nbr] > 0)
        return live, lambda v: v[nbr]
    n = W.shape[0]
    live = W * (1.0 - torch.eye(n, dtype=W.dtype, device=W.device)) > 0
    if act is not None:
        live = live & (act[:, None] > 0) & (act[None, :] > 0)
    return live, lambda v: v[None, :].expand(n, n)


def _read(values: List[torch.Tensor]) -> List[float]:
    """One host sync for a list of 0-d device tensors."""
    if not values:
        return []
    return torch.stack([v.to(torch.float64) for v in values]).cpu().tolist()


class Scheduler:
    """Base: the host-side staging of a span (activity masks, batches,
    mixing operands, fault draws) shared by every semantics.  ``eng`` is
    the owning RoundEngine; the scheduler reads its static resources and
    writes its running metrics (bytes_sent, sim_time_s)."""

    semantics = "sync"

    def __init__(self, eng):
        self.eng = eng
        # 'node' keying derives each step's batch indices on the device
        # from (round, global id): no host staging of (R, L, N, B) indices
        self._node_keying = eng.dl.batch_keying == "node"
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

    def _node_indices(self, rnd: int, ids) -> torch.Tensor:
        """(L, |ids|, B) sample indices of the global ids ``ids`` under
        'node' keying: a pure function of (round, id), so a gathered
        cohort samples what the full population samples for it."""
        eng = self.eng
        return node_batch_indices(eng._batch_key, rnd, ids, eng._dev_lens, eng._dev_parts_pad,
                                  eng.dl.local_steps, eng.dl.batch_size)

    def stage_batches(self, start: int, n_rounds: int):
        """Each round's (L, N, B) sample indices on the device, where the
        dataset already lives: the span's host-drawn stream indices in one
        copy, or under 'node' keying a callable per round."""
        eng = self.eng
        if self._node_keying:
            ids = torch.arange(eng.dl.n_nodes, device=eng.device)
            return [lambda r=start + i: self._node_indices(r, ids) for i in range(n_rounds)]
        idx = eng.batcher.chunk_indices(start, n_rounds, eng.dl.local_steps)
        if eng.shard is not None:  # (R, L, N, B): this rank's nodes
            idx = eng.shard.local(idx, axis=2)
        staged = torch.as_tensor(np.ascontiguousarray(idx), device=eng.device).long()
        return [lambda i=i: staged[i] for i in range(n_rounds)]

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
            if eng.shard is None:
                tables = stage_rounds(st, eng.device)
            else:  # this rank's rows of each round's table, all-gathered mixing
                tables = [shard_topology(SparseTopology(st.nbr[r], st.w[r], st.w_self[r]),
                                         eng.shard, eng.device) for r in range(n_rounds)]
            ops = [(W, (st.nbr[r], st.w[r] > 0)) for r, W in enumerate(tables)]
        else:
            Wst = eng.sampler.weights_stack(start, n_rounds)
            staged = int(Wst.nbytes)
            off = 1.0 - np.eye(Wst.shape[1], dtype=np.float32)
            if eng.shard is None:
                Wd = torch.as_tensor(Wst, device=eng.device)
                mix = [Wd[r] for r in range(n_rounds)]
            else:
                Wd = torch.as_tensor(eng.shard.local(Wst, axis=1), device=eng.device)
                mix = [ShardedDense(Wd[r], eng.shard) for r in range(n_rounds)]
            ops = [(mix[r], (None, Wst[r] * off > 0)) for r in range(n_rounds)]
        eng.topo_stage_bytes_peak = max(eng.topo_stage_bytes_peak, staged)
        return ops

    def stage_faults(self, start: int, n_rounds: int, topo,
                     edge_width: Optional[int] = None) -> List[Optional[RoundFaults]]:
        """Each round's fault draws for rounds [start, start+n_rounds)
        (``faults.edge_draws`` over the round's edge layout, from ``topo``
        as :meth:`stage_topology` gives it, or ``edge_width`` slots per row
        where given, and ``faults.corruption_mask``), drawn on the host and
        staged on the device in one copy per family.  None per round
        without a fault plan."""
        eng = self.eng
        plan, key = eng.steps.faults, eng.steps.fault_key
        if plan is None:
            return [None] * n_rounds
        n = eng.dl.n_nodes
        ids = torch.arange(n)
        fams: Dict[str, List[np.ndarray]] = {}
        for r in range(n_rounds):
            if plan.edge_faults:
                d = edge_width or (topo[r][1] or eng.steps.live_edges)[1].shape[1]
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

    def _stage_span(self, start: int, n_rounds: int):
        """The span's staged inputs: per round ``(W, live_edges, batch
        indices, act or None, faults)``; crash downtime is counted as
        injected faults survived by the churn machinery."""
        eng = self.eng
        topo = self.stage_topology(start, n_rounds)
        idx = self.stage_batches(start, n_rounds)
        act_np, downtime = self.stage_activity(start, n_rounds)
        self._fault_totals["faults_injected"] += downtime
        self._fault_totals["faults_survived"] += downtime
        act_dev = None if act_np is None else torch.as_tensor(act_np, device=eng.device)
        if act_dev is not None and eng.shard is not None:  # (R, B): this rank's nodes
            act_dev = eng.shard.local(act_dev, axis=1)
        pairwise = self.semantics == "async" and eng.dl.async_gossip == "pairwise"
        faults = self.stage_faults(start, n_rounds, topo, edge_width=1 if pairwise else None)
        return [(topo[r][0], topo[r][1], idx[r],
                 None if act_np is None else (act_dev[r], act_np[r]), faults[r])
                for r in range(n_rounds)]

    def _batch(self, idx):
        eng = self.eng
        return eng._dev_x[idx], eng._dev_y[idx]

    def _accum_faults(self, stats: List[Dict]) -> None:
        """Fold the span's per-step counters (floats, or 0-d device
        tensors read here) into the host totals."""
        dev_keys = [(r, k) for r, st in enumerate(stats) for k, v in st.items()
                    if isinstance(v, torch.Tensor)]
        for (r, k), v in zip(dev_keys, _read([stats[r][k] for r, k in dev_keys])):
            stats[r][k] = v
        for st in stats:
            for k in STAT_KEYS:
                self._fault_totals[k] += st[k]

    def run_span(self, start: int, n_rounds: int) -> None:
        raise NotImplementedError

    def run_legacy_round(self, rnd: int) -> None:
        raise ValueError(
            f"legacy per-round dispatch (chunk_rounds=0) supports "
            f"semantics='sync' only, not {self.semantics!r}"
        )

    def eval_params(self):
        """The parameter tree evaluation runs on: the engine's, except on
        the async cohort path with compressed cold rows, which decodes."""
        return self.eng.params

    def extra_metrics(self) -> Dict:
        """Metrics merged into each history record: the running fault
        counters, when a fault plan or secure recovery is on."""
        if not self._track_faults:
            return {}
        t = self._fault_totals
        m = {k: int(round(t[k])) for k in STAT_KEYS if k != "recovery_bytes"}
        m["recovery_bytes"] = t["recovery_bytes"]
        return m


class SyncScheduler(Scheduler):
    """The synchronous round barrier: every node trains and mixes each
    round; the round's simulated time is the max over nodes."""

    semantics = "sync"

    def run_span(self, start: int, n_rounds: int) -> None:
        eng = self.eng
        nbytes, times, stats = [], [], []
        for r, (W, live, idx, act, faults) in enumerate(self._stage_span(start, n_rounds)):
            bx, by = self._batch(idx())
            eng.X, eng.opt_state, eng.share_state, nb, t, fstats = eng.steps.train_and_mix(
                eng.X, eng.opt_state, eng.share_state, bx, by, W, start + r, act, live, faults,
                shard=eng.shard,
            )
            nbytes.append(nb)
            times.append(t)
            stats.append(fstats)
        if eng.shard is not None and times:  # each rank's maxima: one pmax for the span
            times = list(eng.shard.pmax(torch.stack(times)))
        # one host sync for the span (the round times and the guard's
        # detections); per-round float64 sums in round order
        for nb, t in zip(nbytes, _read(times)):
            eng.bytes_sent += nb
            eng.sim_time_s += t
        self._accum_faults(stats)

    def run_legacy_round(self, rnd: int) -> None:
        """The per-round dispatch of ``chunk_rounds=0`` (the JAX package's
        baseline): the round's full batches gathered on the host and
        copied to the device, its mixing operand and participation mask
        staged alone, one ``train_and_mix`` call, and one host read of its
        metrics.  Same draws as the spans, so the same trajectory."""
        eng = self.eng
        dl = eng.dl
        idx = eng.batcher.round_indices(rnd, dl.local_steps)  # (L, N, B)
        bx = torch.as_tensor(eng.batcher.x[idx], device=eng.device)
        by = torch.as_tensor(eng.batcher.y[idx], device=eng.device).long()
        W, live = self.stage_topology(rnd, 1)[0]
        act = None
        if dl.participation < 1.0:
            m = self.participation_mask(rnd, 1)[0]
            act = (torch.as_tensor(m, device=eng.device), m)
        eng.X, eng.opt_state, eng.share_state, nb, t, fstats = eng.steps.train_and_mix(
            eng.X, eng.opt_state, eng.share_state, bx, by, W, rnd, act, live)
        eng.bytes_sent += nb
        eng.sim_time_s += _read([t])[0]
        self._accum_faults([fstats])


class LocalScheduler(Scheduler):
    """Neighbourhood-barrier semantics: trajectories identical to sync,
    but each node runs on its own virtual clock — node i starts round r
    once it and its live neighbours have finished round r-1, then adds its
    own compute and comm time.  Stragglers delay only their graph
    neighbourhood, so the simulated time (the largest clock) is at most
    sync's sum of per-round maxima.  Down nodes stall their clock and
    rejoin where they left off."""

    semantics = "local"

    def __init__(self, eng):
        super().__init__(eng)
        self._clock = torch.zeros((eng.dl.n_nodes,), dtype=torch.float32, device=eng.device)

    @staticmethod
    def _nbr_clock_max(W, act, clock):
        """Per-node max of the live neighbours' clocks (-inf where none)."""
        live, gather = _live_edges(W, act)
        return torch.where(live, gather(clock), -torch.inf).amax(1)

    def run_span(self, start: int, n_rounds: int) -> None:
        eng = self.eng
        nbytes, times, stats = [], [], []
        clock = self._clock
        for r, (W, live, idx, act, faults) in enumerate(self._stage_span(start, n_rounds)):
            bx, by = self._batch(idx())
            eng.X, eng.opt_state, eng.share_state, nb, node_t, fstats = eng.steps.train_and_mix(
                eng.X, eng.opt_state, eng.share_state, bx, by, W, start + r, act, live, faults,
                time_reduce="none",
            )
            a = None if act is None else act[0]
            # wait for the live neighbours' previous round, then run this
            # one (node_t is 0 for a down node, whose clock stalls)
            ready = torch.maximum(clock, self._nbr_clock_max(W, a, clock))
            clock = ready + node_t if a is None else torch.where(a > 0, ready + node_t, clock)
            nbytes.append(nb)
            times.append(clock.max())
            stats.append(fstats)
        self._clock = clock
        eng.bytes_sent += float(np.asarray(nbytes, np.float64).sum())
        # the virtual clock is a running maximum, not a per-round sum
        eng.sim_time_s = _read(times[-1:])[0]
        self._accum_faults(stats)

    def extra_metrics(self) -> Dict:
        clock = self._clock.cpu().double().numpy()
        return {
            "semantics": "local",
            "vclock_min_s": float(clock.min()),
            "vclock_median_s": float(np.median(clock)),
            "vclock_max_s": float(clock.max()),
            **super().extra_metrics(),
        }


class AsyncScheduler(Scheduler):
    """Event-driven asynchronous gossip on a virtual clock (AD-PSGD).  One
    step is one event cohort: the nodes whose next event completes inside
    the earliest ``async_slice_s`` window fire — each takes a local step,
    gossips against possibly stale neighbour rows and reschedules its next
    event at ``+compute_time[i] + comm_time[i]``.  With homogeneous times
    and full participation every cohort is one synchronous round.

    Gossip forms (``DLConfig.async_gossip``): ``"neighborhood"`` — the
    fired node reads its whole (churn-pruned) W row through the sharing
    strategy (one gather-merge launch); ``"pairwise"`` — one uniformly
    sampled partner, ``x_i' = (x_i + x_j) / 2``, blocked when the partner
    is down.  Down nodes burn their event slots and rejoin with their
    stale model.  Under a FaultPlan, lost pairwise exchanges retry after
    an exponential backoff on the node's clock, and corrupted rows roll
    back to the start of the event.

    ``cohort_capacity=C`` runs the population path: each step selects the
    C earliest in-slice nodes (ties by lowest id) — flat over the (N,)
    clock, or through the carried segment minima (``selection="hier"``,
    the same cohort) — gathers their rows, runs the same event on them and
    scatters them back; in-slice nodes past C keep their ``t_next`` and
    fire later (overflow carry).  Selection sorts are stable, which gives
    ``lax.top_k``'s tie order."""

    semantics = "async"

    def __init__(self, eng):
        super().__init__(eng)
        dl, dev = eng.dl, eng.device
        n = dl.n_nodes
        self._t_next = eng._compute_node.clone()
        self._vclock = torch.zeros((n,), dtype=torch.float32, device=dev)
        self._events = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._retries = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._stale_sum = 0.0
        self._stale_n = 0.0
        self._stale_max = 0.0
        self._fired_total = 0
        self._t_offset = 0.0
        self._cohort_c = int(dl.cohort_capacity)
        self._occ_sum = 0.0
        self._occ_steps = 0
        self._overflow_total = 0
        self._fallback_total = 0
        self._vmax = None
        sel = dl.selection
        if sel == "auto":
            sel = "hier" if self._cohort_c > 0 and n >= _HIER_AUTO_MIN_N else "flat"
        self._selection = sel
        if sel == "hier":
            seg = int(dl.segment_size)
            if seg <= 0:
                seg = int(np.clip(round(np.sqrt(n / max(self._cohort_c, 1))), 4, 128))
            self._seg = min(seg, n)
            self._n_seg = -(-n // self._seg)
            self._seg_k = min(self._n_seg, max(self._cohort_c,
                                               2 * (-(-self._cohort_c // self._seg)), 8))
            self._seg_min = self._build_seg_min(self._t_next)
        else:
            self._seg = self._n_seg = self._seg_k = 0
            self._seg_min = None
        # cold population storage: under bf16/int8 the (N, P) parameters
        # and the optimizer moments live compressed; a cohort decodes its
        # rows at the gather and re-encodes them at the scatter
        self._cold = dl.cold_dtype
        self._cold_params = None
        if self._cold != "fp32":
            self._cold_params = compression_lib.encode_cold(eng.params, self._cold)
            eng.opt_state = compression_lib.encode_cold(eng.opt_state, self._cold)
            eng.X = None

    # -- population state --------------------------------------------------
    def eval_params(self):
        if self._cold == "fp32":
            return self.eng.params
        return compression_lib.decode_cold(self._cold_params, self._cold)

    def _decode_rows(self, ids) -> torch.Tensor:
        """(len(ids), P) fp32 population rows of the global ids ``ids``."""
        if self._cold == "fp32":
            return self.eng.X[ids]
        dec = compression_lib.decode_cold(compression_lib.take_rows(self._cold_params, ids),
                                          self._cold)
        return torch.cat([l.reshape(ids.shape[0], -1) for l in tree_leaves(dec)], 1)

    def _build_seg_min(self, t_next):
        """(S,) exact per-segment minima of ``t_next``, the carried
        selection index (built at start and after a rebase)."""
        n, seg, S = self.eng.dl.n_nodes, self._seg, self._n_seg
        rows = (torch.arange(S, device=t_next.device)[:, None] * seg
                + torch.arange(seg, device=t_next.device)[None, :])
        vals = torch.where(rows < n, t_next[rows.clamp_max(n - 1)], torch.inf)
        return vals.amin(1)

    # -- per-event pieces --------------------------------------------------
    def _pair_comm(self, partner, ok, rows=None):
        """Per-event comm seconds of a pairwise exchange: one message of
        the whole parameter vector from the partner."""
        steps = self.eng.steps
        if steps.lat is None:
            return torch.zeros_like(ok)
        if rows is None:
            rows = torch.arange(partner.shape[0], device=partner.device)
        msg8 = _f32(self.eng.n_params * 4 * 8.0, ok)
        t = steps.lat[rows, partner] + msg8 / steps.goodput[rows, partner]
        return ok * t

    def _cohort(self, r: int, rnd: int, W, live_edges, idx, act, faults):
        """One dense event cohort over all N rows (the reference's
        ``AsyncScheduler._cohort``); returns the step's device outputs."""
        eng = self.eng
        dl, steps = eng.dl, eng.steps
        plan = steps.faults
        n = dl.n_nodes
        a = None if act is None else act[0]
        fstats = faults_lib.zero_stats()
        guard = plan is not None and plan.corrupt_prob > 0
        if guard:  # the local step updates X in place
            snap = (eng.X.clone(), tree_map(torch.clone, eng.opt_state))
        t_next = self._t_next
        fire = (t_next <= t_next.min() + dl.async_slice_s).to(torch.float32)
        actv = fire if a is None else fire * a
        bx, by = self._batch(idx())
        X = eng.X
        _, eng.opt_state = steps.local_train(tree_unvector(X, eng.template), eng.opt_state,
                                             bx, by, actv)
        key = prng.fold_in(steps.base_key, rnd)
        ev_f = self._events.to(torch.float32)
        backoff = None
        if dl.async_gossip == "pairwise":
            X2, partner, ok = gossip_pair_avg(W, X, key, fire=actv, act=a)
            ok_eff = ok
            comm = self._pair_comm(partner, ok)
            if plan is not None and plan.edge_faults:
                lv, sp = faults.live[0][:, 0], faults.spike[0][:, 0]
                lost = ok * (1.0 - lv)
                ok_eff = ok * lv
                X2 = torch.where(lost[:, None] > 0, X, X2)
                spiked = ok * sp
                comm = comm * (1.0 + sp * (plan.latency_spike_factor - 1.0))
                retries = self._retries
                backoff = lost * faults_lib.retry_backoff_delay(
                    retries, plan.retry_backoff_s, plan.retry_backoff_cap)
                recovered = ok_eff * (retries > 0).to(torch.float32)
                self._retries = torch.where(lost > 0, retries + 1,
                                            torch.where(ok_eff > 0, 0, retries))
                fstats["faults_injected"] = lost.sum() + spiked.sum()
                fstats["faults_detected"] = lost.sum()
                fstats["faults_survived"] = spiked.sum()
                fstats["faults_recovered"] = recovered.sum()
                fstats["retry_total"] = lost.sum()
            stale_i = ok_eff * torch.clamp_min(ev_f - ev_f[partner], 0.0)
            n_reads = ok_eff
            msg = _f32(float(eng.n_params * 4), ok)
            # bytes at the pre-loss ok: the sender transmitted either way
            nbytes = ok.sum() * msg * _f32(1.0 / n, ok)
        else:
            Wm, deg, _, _ = steps.share_operands(W, rnd, act, live_edges)
            Wm_mix, lat_mult = Wm, None
            if plan is not None and plan.edge_faults:
                lv, sp = faults.live, faults.spike
                reweight = edge_reweight_sparse if isinstance(Wm, SparseTopology) else edge_reweight
                Wm_mix = reweight(Wm, lv[0])
                sent = live_edge_mask(*(live_edges or steps.live_edges),
                                      None if act is None else act[1])
                hit = float(np.count_nonzero(sent & (lv[1] == 0))
                            + np.count_nonzero(sent & (sp[1] > 0)))
                if plan.latency_spike_prob > 0:
                    lat_mult = 1.0 + sp[0] * (plan.latency_spike_factor - 1.0)
                fstats["faults_injected"] += hit
                fstats["faults_survived"] += hit
            X2_all, _, nbytes_rate = eng.sharing.round(X, Wm_mix, eng.share_state, key=key,
                                                       degree=deg, rnd=rnd)
            X2 = torch.where(actv[:, None] > 0, X2_all, X)
            live_b, gather = _live_edges(W, a)
            live_f = live_b.to(torch.float32)
            gap = torch.clamp_min(ev_f[:, None] - gather(ev_f), 0.0)
            cnt = torch.clamp_min(live_f.sum(1), 1.0)
            stale_i = actv * (live_f * gap).sum(1) / cnt
            n_reads = actv
            rate = _f32(float(np.float32(nbytes_rate)), actv)
            nbytes = rate * actv.sum() * _f32(1.0 / n, actv)
            if steps.lat is not None:
                comm = steps.round_time(Wm, float(np.float32(nbytes_rate)), deg, None,
                                        lat_mult, reduce="none") - steps.compute_node
            else:
                comm = torch.zeros((n,), dtype=torch.float32, device=X.device)
        actv_w = actv  # the state-write mask, rolled-back rows left out
        if guard:
            cmask = actv * faults.corrupt[0]
            X2 = faults_lib.corrupt_rows_(X2, cmask, plan.corrupt_mode)
            bad = actv * faults_lib.nonfinite_rows(X2)
            actv_w = actv * (1.0 - bad)
            fstats["faults_injected"] = fstats["faults_injected"] + cmask.sum()
            fstats["faults_detected"] = fstats["faults_detected"] + bad.sum()
            fstats["faults_recovered"] = fstats["faults_recovered"] + bad.sum()
        Xn = torch.where(actv_w[:, None] > 0, X2, X)
        if guard:
            # rolled-back rows drop the local step too: back to the
            # start-of-event snapshot
            X0, opt0 = snap
            good = 1.0 - bad
            Xn = torch.where(good[:, None] > 0, Xn, X0)
            eng.opt_state = node_where(good, eng.opt_state, opt0)
        eng.X = Xn
        dur = steps.compute_node + comm
        if backoff is not None:
            dur = dur + backoff
        self._vclock = torch.where(fire > 0, t_next, self._vclock)
        self._t_next = t_next + fire * dur  # down-but-scheduled slots burn time too
        self._events = self._events + actv_w.to(torch.int32)
        return dict(nbytes=nbytes, vmax=self._vclock.max(), fired=actv.sum(),
                    stale_sum=stale_i.sum(), stale_n=n_reads.sum(), stale_max=stale_i.max(),
                    fstats=fstats)

    # -- cohort selection --------------------------------------------------
    def _select_flat(self, t_next, t_min=None):
        """The flat selection: the C earliest in-slice ``t_next`` over the
        whole (N,) clock (a stable sort: ties by lowest id).  Returns
        ``(cids ascending, cmask, occupancy, overflow)``."""
        C = self._cohort_c
        if t_min is None:
            t_min = t_next.min()
        in_slice = t_next <= t_min + self.eng.dl.async_slice_s
        order = torch.sort(torch.where(in_slice, t_next, torch.inf), stable=True).indices[:C]
        pad = in_slice[order].to(torch.float32)
        occupancy = pad.sum()
        overflow = in_slice.sum() - occupancy.to(torch.int64)
        cids, perm = torch.sort(order)
        return cids, pad[perm], occupancy, overflow

    def _select_hier(self, t_next, seg_min):
        """Segment-minimum selection: the flat cohort bitwise whenever
        every in-slice segment is among the K earliest (``covered``, read
        on the host each step: the reference's ``lax.cond``), otherwise the
        flat selection itself (counted as a fallback).  Returns the flat
        selection's four outputs and the fallback flag."""
        t_min = seg_min.min()
        theta = t_min + self.eng.dl.async_slice_s
        if int((seg_min <= theta).sum()) > self._seg_k:
            return self._select_flat(t_next, t_min=t_min) + (1,)
        return self._select_segments(t_next, seg_min, theta) + (0,)

    def _select_segments(self, t_next, seg_min, theta):
        """The K earliest segments of the carried (S,) ``seg_min`` (ties by
        lowest segment), their (K·seg,) clock union in ascending global id,
        and the flat rule inside it.  Union rows past N read as +inf; they
        are never selected, because the union holds at least C rows below
        N and ties go to the lower position."""
        C, n, seg, K = self._cohort_c, self.eng.dl.n_nodes, self._seg, self._seg_k
        seg_sel = torch.sort(torch.sort(seg_min, stable=True).indices[:K]).values
        rows = (seg_sel[:, None] * seg
                + torch.arange(seg, device=seg_min.device)[None, :]).reshape(-1)
        u_t = torch.where(rows < n, t_next[rows.clamp_max(n - 1)], torch.inf)
        in_sl = u_t <= theta
        pos = torch.sort(torch.where(in_sl, u_t, torch.inf), stable=True).indices[:C]
        pad = in_sl[pos].to(torch.float32)
        occupancy = pad.sum()
        overflow = in_sl.sum() - occupancy.to(torch.int64)
        cids, perm = torch.sort(rows[pos].clamp_max(n - 1))
        return cids, pad[perm], occupancy, overflow

    def _cohort_gs(self, r: int, rnd: int, W, live_edges, idx, act):
        """Population-scale cohort step: :meth:`_cohort`'s semantics on a
        gathered (C, ...) hot set.  Capacity-padding slots carry cmask 0:
        their rows run through the masked ops as down nodes do and go back
        unchanged (under bf16/int8 the original encoded rows go back, never
        a re-encode).  Neighbour reads of this step see the fresh rows of
        cohort members, as the dense oracle reads post-local-step rows."""
        eng = self.eng
        dl, steps = eng.dl, eng.steps
        n, C, cold = dl.n_nodes, self._cohort_c, self._cold
        a = None if act is None else act[0]
        t_next = self._t_next
        if self._selection == "hier":
            cids, cmask, occupancy, overflow, fb = self._select_hier(t_next, self._seg_min)
        else:
            cids, cmask, occupancy, overflow = self._select_flat(t_next)
            fb = 0
        act_c = None if a is None else a[cids]
        actv_c = cmask if a is None else cmask * act_c
        # --- local step on the hot rows ---------------------------------
        if cold == "fp32":
            X_c = eng.X[cids]
            o_c = tree_map(lambda l: l[cids], eng.opt_state)
        else:
            enc_p = compression_lib.take_rows(self._cold_params, cids)
            enc_o = compression_lib.take_rows(eng.opt_state, cids)
            X_c = self._decode_rows(cids)
            o_c = compression_lib.decode_cold(enc_o, cold)
        bx, by = self._batch(self._node_indices(rnd, cids))
        _, o_c = steps.local_train(tree_unvector(X_c, eng.template), o_c, bx, by, actv_c,
                                   rows=cids)
        key = prng.fold_in(steps.base_key, rnd)
        ev_c = self._events[cids].to(torch.float32)
        topo_c = gather_rows(W, cids)

        def slot_of(ids):
            """Cohort slot of each global id, -1 outside the cohort."""
            pos = torch.searchsorted(cids, ids).clamp_max(C - 1)
            return torch.where(cids[pos] == ids, pos, -1)

        def fresh(ids):
            """Post-local-step rows of ``ids``: the hot rows for cohort
            members, the population's rows for the rest."""
            s = slot_of(ids)
            return torch.where((s >= 0)[:, None], X_c[s.clamp_min(0)], self._decode_rows(ids))

        if dl.async_gossip == "pairwise":
            slot = sample_neighbor_slots(key, topo_c, rows=cids)
            partner = topo_c.nbr.gather(1, slot[:, None])[:, 0].long()
            ok = actv_c if a is None else actv_c * a[partner]
            X2_c = torch.where(ok[:, None] > 0, 0.5 * (X_c + fresh(partner)), X_c)
            stale_c = ok * torch.clamp_min(ev_c - self._events[partner].to(torch.float32), 0.0)
            n_reads = ok
            msg = _f32(float(eng.n_params * 4), ok)
            nbytes = ok.sum() * msg * _f32(1.0 / n, ok)
            comm = self._pair_comm(partner, ok, rows=cids)
        else:
            if act is not None:
                Wm_c = participation_reweight_rows(topo_c, a, cids)
                deg = participation_deg_eff(*(live_edges or steps.live_edges), act[1])
            else:
                Wm_c, deg = topo_c, steps.mean_degree
            nbr_c = Wm_c.nbr.long()
            w = torch.cat([Wm_c.w_self.to(torch.float32)[:, None],
                           Wm_c.w.to(torch.float32)], 1).contiguous()
            if cold == "fp32":
                # the hot rows go into the population first, so the merge
                # reads them where a neighbour is a cohort member; the
                # merged rows go back where the row fired
                eng.X[cids] = X_c
                rows = torch.cat([cids[:, None], nbr_c], 1).to(torch.int32).contiguous()
                mixed = gossip_mix_rows(eng.X, rows, w)
            else:
                ids = torch.cat([cids[:, None], nbr_c], 1).reshape(-1)
                mixed = gossip_mix_rows(fresh(ids), None, w)
            X2_c = torch.where(actv_c[:, None] > 0, mixed, X_c)
            live_c = topo_c.w > 0
            if a is not None:
                live_c = live_c & (act_c[:, None] > 0) & (a[topo_c.nbr.long()] > 0)
            live_f = live_c.to(torch.float32)
            gap = torch.clamp_min(ev_c[:, None] - self._events[topo_c.nbr.long()].to(torch.float32),
                                  0.0)
            cnt = torch.clamp_min(live_f.sum(1), 1.0)
            stale_c = actv_c * (live_f * gap).sum(1) / cnt
            n_reads = actv_c
            rate = float(np.float32(deg * eng.n_params * 4))
            nbytes = _f32(rate, actv_c) * actv_c.sum() * _f32(1.0 / n, actv_c)
            if steps.lat is not None:
                comm = steps.cohort_comm_time(cids, Wm_c.nbr, (Wm_c.w > 0).to(torch.float32),
                                              rate, deg)
            else:
                comm = torch.zeros((C,), dtype=torch.float32, device=X_c.device)
        # --- the one (C, P) scatter of the step ---------------------------
        P2_c = torch.where(actv_c[:, None] > 0, X2_c, X_c)
        if cold == "fp32":
            eng.X[cids] = P2_c
            tree_map(lambda l, s: l.index_copy_(0, cids, s), eng.opt_state, o_c)
        else:
            enc_new = compression_lib.encode_cold(tree_unvector(P2_c, eng.template), cold)
            compression_lib.put_rows_(self._cold_params, cids,
                                      compression_lib.where_rows(actv_c, enc_new, enc_p))
            compression_lib.put_rows_(eng.opt_state, cids, compression_lib.where_rows(
                actv_c, compression_lib.encode_cold(o_c, cold), enc_o))
        # --- clock advance on the gathered rows ---------------------------
        dur_c = steps.compute_node[cids] + comm
        t_c = t_next[cids]
        self._vclock[cids] = torch.where(cmask > 0, t_c, self._vclock[cids])
        t_next[cids] = t_c + cmask * dur_c
        self._events[cids] = self._events[cids] + actv_c.to(torch.int32)
        # the running max of vclock, carried as a scalar (max is exact)
        self._vmax = torch.maximum(self._vmax, torch.where(cmask > 0, t_c, -torch.inf).max())
        if self._selection == "hier":
            # refresh the minima of exactly the segments this scatter
            # touched (duplicate segments write equal values)
            seg = self._seg
            segs = cids // seg
            rows2 = segs[:, None] * seg + torch.arange(seg, device=cids.device)[None, :]
            vals = torch.where(rows2 < n, t_next[rows2.clamp_max(n - 1)], torch.inf)
            self._seg_min[segs] = vals.amin(1)
        return dict(nbytes=nbytes, vmax=self._vmax, fired=actv_c.sum(),
                    stale_sum=stale_c.sum(), stale_n=n_reads.sum(), stale_max=stale_c.max(),
                    occupancy=occupancy, overflow=overflow, fallback=fb)

    # -- host-side dispatch ------------------------------------------------
    def run_span(self, start: int, n_rounds: int) -> None:
        eng = self.eng
        cohort = self._cohort_c > 0
        if cohort:  # the running max restarts from the clock each span
            self._vmax = self._vclock.max()
        outs = []
        for r, (W, live, idx, act, faults) in enumerate(self._stage_span(start, n_rounds)):
            if cohort:
                outs.append(self._cohort_gs(r, start + r, W, live, idx, act))
            else:
                outs.append(self._cohort(r, start + r, W, live, idx, act, faults))
        keys = ["nbytes", "vmax", "fired", "stale_sum", "stale_n", "stale_max"]
        if cohort:
            keys += ["occupancy", "overflow"]
        read = np.asarray(_read([o[k] for o in outs for k in keys]),
                          np.float64).reshape(len(outs), len(keys))
        col = {k: read[:, i] for i, k in enumerate(keys)}
        eng.bytes_sent += float(np.asarray(col["nbytes"].astype(np.float32), np.float64).sum())
        # the virtual clock is a running maximum (exact in fp32) plus the
        # rebase offset
        eng.sim_time_s = float(col["vmax"][-1]) + self._t_offset
        self._fired_total += int(col["fired"].sum())
        self._stale_sum += float(col["stale_sum"].astype(np.float32).astype(np.float64).sum())
        self._stale_n += float(col["stale_n"].sum())
        self._stale_max = max(self._stale_max, float(col["stale_max"].max()))
        if cohort:
            self._occ_sum += float(col["occupancy"].sum())
            self._occ_steps += len(outs)
            self._overflow_total += int(col["overflow"].sum())
            self._fallback_total += sum(o["fallback"] for o in outs)
        else:
            self._accum_faults([o["fstats"] for o in outs])
        self._maybe_rebase()

    def _maybe_rebase(self) -> None:
        """Once every pending event is past ``_REBASE_T_S``, subtract one
        fp32 shift from ``t_next``/``vclock`` (and the segment minima and
        running max) on the device and carry it in the float64 offset.
        Below the threshold nothing changes."""
        t_min = float(self._t_next.min())
        if t_min < _REBASE_T_S:
            return
        shift = float(np.float32(t_min))
        self._t_offset += shift
        s = _f32(shift, self._t_next)
        self._t_next = self._t_next - s
        self._vclock = self._vclock - s
        if self._seg_min is not None:
            # x - s is monotone in x, so each segment's min stays its min
            self._seg_min = self._seg_min - s

    # -- population-scale memory accounting ---------------------------------
    def memory_model(self) -> Dict:
        """Analytic bytes of the hot/cold split, as the reference counts
        them: hot = the per-step working set of the cohort path
        (O(C·(d+1)·P) gossip operands and the (L, C, B) batch slice); cold
        = the device-resident population (params as stored, clocks,
        topology), which is only gathered and scattered."""
        eng = self.eng
        dl = eng.dl
        n, p = dl.n_nodes, eng.n_params
        c = self._cohort_c if self._cohort_c > 0 else n
        topo = eng._mix_static
        if isinstance(topo, SparseTopology):
            d = int(topo.dmax)
            topo_bytes = int(sum(t.numel() * t.element_size()
                                 for t in (topo.nbr, topo.w, topo.w_self)))
        elif topo is None:  # dynamic: (N, degree) tables staged per round
            d = int(dl.degree)
            topo_bytes = n * d * 8 + n * 4
        else:
            d = n
            topo_bytes = 4 * n * n
        bx, by = eng.batcher.x, eng.batcher.y
        feat_bytes = int(bx.nbytes // max(bx.shape[0], 1)) + int(by.nbytes // max(by.shape[0], 1))
        hot = {
            "gossip_gather_bytes": c * (1 + d) * p * 4,
            "work_vectors_bytes": 2 * c * p * 4,
            "batch_bytes": dl.local_steps * c * dl.batch_size * feat_bytes,
            "topology_rows_bytes": c * (d * 8 + 4),
        }
        hot["total"] = int(sum(hot.values()))
        stored = self._cold_params if self._cold != "fp32" else eng.params
        pop_b, pop_fp32 = compression_lib.cold_tree_bytes((stored, eng.opt_state))
        seg_min_bytes = self._n_seg * 4 if self._selection == "hier" else 0
        cold = {
            "population_params_bytes": int(pop_b),
            "clock_bytes": n * (4 + 4 + 4) + seg_min_bytes,
            "topology_bytes": topo_bytes,
        }
        cold["total"] = int(sum(cold.values()))
        cold["population_params_fp32_bytes"] = int(pop_fp32)
        cold["total_fp32"] = int(cold["total"] - pop_b + pop_fp32)
        if self._selection == "hier":
            selection = {"mode": "hier", "segment": self._seg, "n_segments": self._n_seg,
                         "segments_topk": self._seg_k,
                         "per_step_bytes": self._seg_k * self._seg * 12 + self._n_seg * 4}
        else:
            selection = {"mode": "flat", "per_step_bytes": n * 12}
        return {"cohort_capacity": c, "n_nodes": n, "n_params": p, "dmax": d,
                "cold_dtype": self._cold, "selection": selection, "hot": hot, "cold": cold}

    def extra_metrics(self) -> Dict:
        events = self._events.cpu().numpy().astype(np.int64)
        vclock = self._vclock.cpu().numpy().astype(np.float64) + self._t_offset
        m = {
            "semantics": "async",
            "events_total": int(events.sum()),
            "events_min": int(events.min()),
            "events_max": int(events.max()),
            "vclock_min_s": float(vclock.min()),
            "vclock_median_s": float(np.median(vclock)),
            "vclock_max_s": float(vclock.max()),
            "staleness_mean": self._stale_sum / max(self._stale_n, 1.0),
            "staleness_max": self._stale_max,
        }
        if self._cohort_c > 0:
            m["cohort_capacity"] = self._cohort_c
            m["cohort_occupancy_mean"] = self._occ_sum / max(self._occ_steps, 1)
            m["cohort_overflow_total"] = self._overflow_total
            m["cohort_overflow_ratio"] = self._overflow_total / max(self._fired_total, 1)
            m["cohort_selection"] = self._selection
            if self._selection == "hier":
                m["selection_fallback_total"] = self._fallback_total
        m.update(super().extra_metrics())
        return m


def make_scheduler(eng) -> Scheduler:
    sem = eng.dl.semantics
    if sem == "sync":
        return SyncScheduler(eng)
    if sem == "local":
        return LocalScheduler(eng)
    if sem == "async":
        return AsyncScheduler(eng)
    raise ValueError(f"unknown semantics {sem!r} (sync|local|async)")
