"""Elastic membership for the process backend: epoch-stamped views.

One :class:`Membership` instance is a single worker's *view* of the
mesh: which peers are live, dead, or gracefully departed, what each
peer's current **membership epoch** (incarnation number) is, and when
each peer was last heard from.  It is deliberately free of sockets,
topology, and torch so the failure detector and the rejoin admission
rules are testable in isolation (``tests/test_torch_runtime.py`` drives
it beside the JAX package's copy).

## Epochs

Every worker incarnation carries a monotone epoch: the first launch is
epoch 0, each supervisor relaunch after a crash bumps it by one.  Every
frame on the wire is stamped with the sender's epoch, and admission is
decided per frame:

* ``epoch < epochs[v]``  — a **zombie frame** from a pre-crash
  incarnation: dropped, counted under ``stale_frames_dropped``.
* ``epoch == epochs[v]`` — current; accepted iff the sender is live (or
  mid-rejoin, see below).  Frames from senders already declared dead or
  left are dropped and counted — a dead peer's late frames must never
  queue into the per-sender inboxes.
* ``epoch > epochs[v]``  — a *future* incarnation whose JOIN has not
  been processed yet (frames are FIFO per connection, so this is a
  transient reorder across connections): ignored without counting.
  Only a JOIN advances a peer's epoch.

## Rejoin state machine

    live --declare_dead/declare_left--> dead/left
    dead --hello(newer epoch)--> dead+pending (beacons refresh liveness,
                                 ROWS may queue, barrier still excludes)
    pending --schedule_admit(start)--> admission due at round `start`
    due --admit()--> live again (caller restores pristine edge weights)

The two-phase hello/commit split exists because survivors run a
synchronous barrier: every survivor must re-admit the rejoiner at the
*same* future round (the rejoiner picks ``start`` past everyone's
current round), otherwise one survivor would wait on rows the rejoiner
never sent.

## Counter schema

``RUNTIME_COUNTER_KEYS`` is the uniform per-worker counter schema the
runtime emits; the conservation invariant checked by the chaos harness
is ``faults_detected == len(dead) + rejoin_total`` for every worker's
final report (each detection either stays dead or was re-admitted).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

#: Uniform per-worker counter schema (the fault counters and the
#: elastic-membership triple).
RUNTIME_COUNTER_KEYS = (
    "faults_detected",      # peers this worker declared dead
    "retry_total",          # send retries (shared backoff policy)
    "leaves",               # graceful BYE departures honored
    "rejoin_total",         # dead peers this worker re-admitted
    "stale_frames_dropped",  # zombie/stale-epoch frames rejected
    "catchup_bytes",        # checkpoint/STATE bytes a rejoiner restored
)


def zero_counters() -> Dict[str, int]:
    return {k: 0 for k in RUNTIME_COUNTER_KEYS}


class Membership:
    """One worker's epoch-stamped view of the K-worker mesh."""

    def __init__(self, n_workers: int, wid: int, dead_timeout_s: float):
        self.n = int(n_workers)
        self.wid = int(wid)
        self.dead_timeout_s = float(dead_timeout_s)
        self.epochs: Dict[int, int] = {v: 0 for v in range(self.n)}
        self.dead: Set[int] = set()
        self.left: Set[int] = set()
        # dead peers whose new incarnation said hello (rejoin in flight)
        self.pending_hello: Set[int] = set()
        # v -> first round the re-admitted peer participates in
        self.pending_admit: Dict[int, int] = {}
        self.last_seen: Dict[int, float] = {}

    # -- basic views ----------------------------------------------------
    def peers(self) -> List[int]:
        return [v for v in range(self.n) if v != self.wid]

    def is_live(self, v: int) -> bool:
        return v not in self.dead and v not in self.left

    def live_peers(self) -> List[int]:
        return [v for v in self.peers() if self.is_live(v)]

    def beacon_targets(self) -> List[int]:
        """Who to heartbeat: live peers plus mid-rejoin peers — a
        rejoiner must hear survivors' beacons *before* it is re-admitted
        or its own failure detector would declare every survivor dead
        while it waits for its start round."""
        return [v for v in self.peers()
                if self.is_live(v) or self._pending(v)]

    def _pending(self, v: int) -> bool:
        return v in self.pending_hello or v in self.pending_admit

    # -- frame admission ------------------------------------------------
    def frame_status(self, v: int, epoch: int) -> str:
        """'ok' | 'stale' | 'future' for a data-plane frame (ROWS /
        HEARTBEAT / BYE) stamped with ``epoch``.  'stale' frames are the
        ones the caller counts under ``stale_frames_dropped``."""
        cur = self.epochs.get(v)
        if cur is None:
            return "stale"
        if epoch > cur:
            return "future"
        if epoch < cur:
            return "stale"
        return "ok" if (self.is_live(v) or self._pending(v)) else "stale"

    def heartbeat(self, v: int, epoch: int, now: float) -> str:
        """Process a liveness beacon; refreshes ``last_seen`` only for
        the sender's *current* incarnation (a zombie's beacon must not
        keep its corpse looking alive)."""
        st = self.frame_status(v, epoch)
        if st == "ok":
            self.last_seen[v] = now
        return st

    # -- failure detection ----------------------------------------------
    def silent_too_long(self, v: int, now: float) -> bool:
        """True when a live peer has been silent past the dead timeout.
        Callers feed this into :meth:`declare_dead`."""
        if not self.is_live(v):
            return False
        seen = self.last_seen.get(v)
        return seen is not None and (now - seen) > self.dead_timeout_s

    def declare_dead(self, v: int) -> bool:
        """Declare a peer dead.  Returns True exactly once per
        incarnation — repeated silence checks and retry-budget
        exhaustion on an already-dead peer are no-ops."""
        if v in self.dead or v in self.left:
            return False
        self.dead.add(v)
        self.pending_hello.discard(v)
        self.pending_admit.pop(v, None)
        return True

    def declare_left(self, v: int) -> bool:
        """Graceful-leave twin of :meth:`declare_dead`."""
        if v in self.dead or v in self.left:
            return False
        self.left.add(v)
        return True

    # -- rejoin ----------------------------------------------------------
    def hello(self, v: int, epoch: int) -> str:
        """A (re)JOIN hello from incarnation ``epoch`` of peer v.

        Returns 'rejoin' (a declared-dead/left peer at a strictly newer
        epoch — the dead mark will clear at admission), 'ok' (a live
        peer re-announcing, e.g. the supervisor restarted it before we
        ever noticed the death — the caller should first retire the old
        incarnation), or 'stale' (epoch not newer than what we know for
        a non-live peer: a zombie JOIN)."""
        cur = self.epochs[v]
        if self.is_live(v):
            if epoch < cur:
                return "stale"
            self.epochs[v] = max(cur, epoch)
            return "ok"
        if epoch <= cur:
            return "stale"
        self.epochs[v] = epoch
        self.pending_hello.add(v)
        return "rejoin"

    def schedule_admit(self, v: int, epoch: int, start_round: int,
                       cur_round: int) -> bool:
        """Commit phase: re-admit peer v at the top of ``start_round``.
        Refused when the epoch is stale or the round is not safely in
        the future (the barrier for ``cur_round + 1`` may already be in
        flight)."""
        if epoch != self.epochs[v]:
            return False
        if start_round < cur_round + 2:
            return False
        self.pending_admit[v] = int(start_round)
        self.pending_hello.discard(v)
        return True

    def due_admissions(self, rnd: int) -> List[int]:
        return sorted(v for v, s in self.pending_admit.items() if s <= rnd)

    def admit(self, v: int) -> bool:
        """Make peer v live again.  Returns True when v was declared
        dead (the caller counts it under ``rejoin_total``); re-admitting
        a gracefully-left or never-dead peer returns False."""
        was_dead = v in self.dead
        self.dead.discard(v)
        self.left.discard(v)
        self.pending_hello.discard(v)
        self.pending_admit.pop(v, None)
        return was_dead

    # -- introspection ---------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        return {
            "epochs": dict(self.epochs),
            "dead": sorted(self.dead),
            "left": sorted(self.left),
            "pending": sorted(set(self.pending_hello)
                              | set(self.pending_admit)),
        }
