"""Fault injection and recovery: message-level faults for the round engine.

``FaultPlan`` (``DLConfig.faults``) is the JAX package's declarative fault
model, and every draw here is bitwise the reference's:

* **message loss** (``msg_loss``): each directed message is lost with
  probability p per round; the mixing operand drops the lost edges and
  their weight returns to the receiver's diagonal
  (``sharing.edge_reweight`` / ``edge_reweight_sparse``).  The sender does
  not know: wire bytes and link time are still charged.
* **crash/restart windows** (``crashes``): ``(node, crash_round,
  restart_round)`` windows made into per-round (N,) availability masks on
  the host, ANDed into the churn participation mask.
* **latency spikes** (``latency_spike_prob`` / ``latency_spike_factor``):
  per-edge multiplicative latency surges in the simulated round time.
* **payload corruption** (``corrupt_prob`` / ``corrupt_mode``): a node's
  post-mix row is overwritten with NaN, or its exponent bits are set
  (``"bitflip"``); both are non-finite, so the step guard's detection is
  exact, and detected rows roll back to the start-of-round snapshot.

Draws are pure functions of ``(fault seed, absolute round, global node
id)`` through the Threefry ``fold_in`` chain (``repro_torch.prng``), so
they do not depend on the chunking.  The engine draws them on the host, a
span at a time, as it draws the participation masks.

Counters (``STAT_KEYS``): ``faults_injected`` (lost + spiked + corrupted +
crash downtime), ``faults_detected`` (guard detections),
``faults_survived`` (absorbed by renormalization, late delivery or the
churn machinery), ``faults_recovered`` (rollbacks), ``retry_total`` and
``recovery_bytes`` (secure aggregation's seed-recovery traffic).
``injected == detected + survived`` in every scenario.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import prng

# fold_in tags of the independent per-(round, node) draw families
_TAG_EDGE = 0x10      # per-edge message-loss draws
_TAG_SPIKE = 0x11     # per-edge latency-spike draws
_TAG_CORRUPT = 0x12   # per-node payload-corruption draws
_SEED_OFFSET = 0xFA11

# the fault-counter schema every round reports
STAT_KEYS = (
    "faults_injected",
    "faults_detected",
    "faults_survived",
    "faults_recovered",
    "retry_total",
    "recovery_bytes",
)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault-injection specification (``DLConfig.faults``).

    crashes: tuple of ``(node, crash_round, restart_round)``; the node is
    down for rounds ``[crash_round, restart_round)``, and a negative
    restart_round means it never comes back.
    """

    msg_loss: float = 0.0
    crashes: Tuple = ()
    latency_spike_prob: float = 0.0
    latency_spike_factor: float = 10.0
    corrupt_prob: float = 0.0
    corrupt_mode: str = "nan"   # nan | bitflip
    retry_backoff_s: float = 1e-3
    retry_backoff_cap: int = 6
    seed: int = 0

    def validate(self) -> "FaultPlan":
        def bad(msg):
            raise ValueError(f"invalid FaultPlan: {msg}")

        if not 0.0 <= self.msg_loss < 1.0:
            bad(f"msg_loss must be in [0, 1), got {self.msg_loss}")
        if not 0.0 <= self.latency_spike_prob < 1.0:
            bad("latency_spike_prob must be in [0, 1), got "
                f"{self.latency_spike_prob}")
        if self.latency_spike_factor <= 0:
            bad("latency_spike_factor must be > 0")
        if not 0.0 <= self.corrupt_prob < 1.0:
            bad(f"corrupt_prob must be in [0, 1), got {self.corrupt_prob}")
        if self.corrupt_mode not in ("nan", "bitflip"):
            bad(f"unknown corrupt_mode {self.corrupt_mode!r} (nan|bitflip)")
        if self.retry_backoff_s < 0:
            bad("retry_backoff_s must be >= 0")
        if self.retry_backoff_cap < 0:
            bad("retry_backoff_cap must be >= 0")
        for c in self.crashes:
            if len(c) != 3:
                bad(f"crash entries are (node, crash_round, restart_round), got {c!r}")
            node, down, up = c
            if node < 0:
                bad(f"crash node must be >= 0, got {node}")
            if down < 0:
                bad(f"crash_round must be >= 0, got {down}")
            if 0 <= up <= down:
                bad(f"restart_round must be > crash_round (or < 0 for never), got {c!r}")
        return self

    @property
    def edge_faults(self) -> bool:
        """Any per-edge fault axis active (loss or latency spikes)."""
        return self.msg_loss > 0 or self.latency_spike_prob > 0

    @property
    def any_faults(self) -> bool:
        return self.edge_faults or self.corrupt_prob > 0 or bool(self.crashes)


def fault_key(plan: FaultPlan, engine_seed: int) -> prng.Key:
    """The plan's root key, folded off its own seed and the engine seed,
    so fault draws never collide with the sharing or batch draws."""
    return prng.fold_in(prng.key(plan.seed + _SEED_OFFSET), engine_seed)


def _row_keys(key: prng.Key, tag: int, rnd: int, rows) -> prng.Key:
    """(len(rows), 1)-word batch of per-(round, global node id) keys of one
    draw family: ``fold_in(fold_in(fold_in(key, tag), rnd), id)``."""
    k = prng.fold_in(prng.fold_in(key, tag), int(rnd))
    ids = torch.as_tensor(rows, dtype=torch.int64)
    return prng.fold_in(k, ids.reshape(-1, 1))


def crash_mask(plan: FaultPlan, n: int, start: int, n_rounds: int) -> np.ndarray:
    """(R, N) {0,1} availability of the crash schedule for absolute rounds
    [start, start + n_rounds): a pure function of the absolute round, so
    any chunking slices the same schedule."""
    m = np.ones((n_rounds, n), np.float32)
    r = np.arange(start, start + n_rounds)
    for node, down, up in plan.crashes:
        dead = (r >= down) if up < 0 else (r >= down) & (r < up)
        m[dead, node] = 0.0
    return m


def _f32(x: float, like):
    """The Python float ``x`` rounded to fp32, as the reference's weak-typed
    scalars are before they meet an fp32 array."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def edge_draws(key: prng.Key, rnd: int, rows, d: int, plan: FaultPlan):
    """Per-edge draws for the receiver rows ``rows``: ``(live, spike)``,
    both (len(rows), d) fp32 {0,1} tensors on ``rows``' device.
    ``live[i, s]`` is 1 when the message on row i's slot s arrives,
    ``spike[i, s]`` 1 when its latency spikes; ``d`` is the slot count (the
    neighbour table's width, or N for a dense W)."""
    ul = prng.uniform(_row_keys(key, _TAG_EDGE, rnd, rows), (d,))
    us = prng.uniform(_row_keys(key, _TAG_SPIKE, rnd, rows), (d,))
    return ((ul >= _f32(plan.msg_loss, ul)).to(torch.float32),
            (us < _f32(plan.latency_spike_prob, us)).to(torch.float32))


def corruption_mask(key: prng.Key, rnd: int, rows, plan: FaultPlan):
    """(len(rows),) fp32 {0,1}: 1 marks a node whose post-mix row is
    corrupted this round (one scalar uniform per row)."""
    u = prng.uniform(_row_keys(key, _TAG_CORRUPT, rnd, rows), ())
    return (u < _f32(plan.corrupt_prob, u)).to(torch.float32)


def corrupt_rows_(X2, cmask, mode: str):
    """Corrupt the rows of the post-mix (N, P) fp32 matrix where ``cmask``
    (N,) > 0, in place: ``"nan"`` overwrites them with NaN, ``"bitflip"``
    ORs every element's bits with the fp32 exponent mask (inf or NaN).
    Returns X2."""
    rows = (cmask > 0)[:, None]
    if mode == "nan":
        return X2.masked_fill_(rows, float("nan"))
    X2.view(torch.int32).bitwise_or_(rows.to(torch.int32) * 0x7F800000)
    return X2


def nonfinite_rows(X2):
    """(N,) fp32 {0,1}: 1 marks rows holding any non-finite value (the step
    guard's detection pass)."""
    return 1.0 - torch.isfinite(X2).all(1).to(torch.float32)


def zero_stats():
    """The all-zero counter record (``STAT_KEYS``)."""
    return {k: 0.0 for k in STAT_KEYS}


def retry_backoff_delay(retries, base_s: float, cap: int):
    """Seconds to wait before retry number ``retries``: base·2^min(k, cap),
    as an fp32 tensor for a tensor of retry counts, else a float."""
    if isinstance(retries, torch.Tensor):
        k = torch.minimum(retries.to(torch.float32), _f32(float(cap), retries))
        return _f32(base_s, retries) * torch.pow(2.0, k)
    return base_s * 2.0 ** min(int(retries), int(cap))
