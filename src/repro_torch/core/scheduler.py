"""Scheduler layer: when the steps fire and what time means.

Only the synchronous round barrier is ported.  A span of rounds is a
Python loop on the host that queues each round's work on the device; the
per-round metrics stay on the device until the span ends, when one host
sync reads them all.  The engine's ``chunk_rounds`` sets that cadence and
nothing else: batches are a pure function of the absolute round, and the
metrics are summed round by round in float64, so the trajectory and the
totals do not depend on it.
"""
from __future__ import annotations

import torch


class SyncScheduler:
    """The synchronous round barrier: every node trains and mixes each
    round; the round's simulated time is the max over nodes.  ``eng`` is
    the owning RoundEngine; the scheduler reads its static resources and
    writes its running metrics (bytes_sent, sim_time_s)."""

    semantics = "sync"

    def __init__(self, eng):
        self.eng = eng

    def _stage_indices(self, start: int, n_rounds: int) -> torch.Tensor:
        """(R, L, N, B) sample indices of rounds [start, start+R) on the
        device, where the dataset already lives."""
        eng = self.eng
        idx = eng.batcher.chunk_indices(start, n_rounds, eng.dl.local_steps)
        return torch.as_tensor(idx, device=eng.device).long()

    def run_span(self, start: int, n_rounds: int) -> None:
        eng = self.eng
        idx = self._stage_indices(start, n_rounds)
        nbytes, times = [], []
        for r in range(n_rounds):
            bx = eng._dev_x[idx[r]]  # (L, N, B, ...)
            by = eng._dev_y[idx[r]]
            eng.X, eng.opt_state, eng.share_state, nb, t = eng.steps.train_and_mix(
                eng.X, eng.opt_state, eng.share_state, bx, by, eng._mix_static,
                start + r,
            )
            nbytes.append(nb)
            times.append(t)
        # one host sync for the span; per-round float64 sums in round order
        for nb, t in zip(nbytes, torch.stack(times).cpu().double().tolist()):
            eng.bytes_sent += nb
            eng.sim_time_s += t


def make_scheduler(eng) -> SyncScheduler:
    sem = eng.dl.semantics
    if sem == "sync":
        return SyncScheduler(eng)
    raise NotImplementedError(f"semantics={sem!r} is not ported yet")
