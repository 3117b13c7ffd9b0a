"""Step layer: what one node-stacked round does.

``RoundSteps`` holds the static pieces of an experiment (loss, optimizer,
sharing strategy, per-node compute times, link matrices, the fault plan)
and no mutable state.  The caller threads the flat (N, P) parameter
matrix X through :meth:`RoundSteps.train_and_mix`.  Churn (a per-round
participation mask) and fault injection (``core/faults.py``: message
loss, latency spikes, payload corruption with the rollback guard; crash
windows reach the step as churn) are ported.

The participation masks and the fault draws are made on the host, so the
round's degree, bytes, seed-recovery bytes and the fault counters that
depend on them alone are computed there, in the reference's fp32
operation order; the guard's detections stay on the device until the
scheduler's one sync per span.  The device is never read inside a round.

Node-sharded rounds (``shard``, a ``mixing.NodeShard``): X, the optimizer
state, the sharing state and the round's active mask are this rank's
(B, ...) rows, the mixing operand a sharded one.  Every rank stages the
same global host masks, so the degree, the bytes and the seed-recovery
bytes come out equal on every rank without a collective; the round time
is this rank's maximum, which the scheduler reduces over the ranks once
per span.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch import prng
from repro_torch.core import faults as faults_lib
from repro_torch.core.mixing import ShardedDense, ShardedTopology
from repro_torch.core.network import gathered_round_times, node_round_times
from repro_torch.core.secure import SEED_SHARE_BYTES
from repro_torch.core.sharing import (
    edge_reweight,
    edge_reweight_sparse,
    live_edge_mask,
    participation_deg_eff,
    participation_reweight,
    participation_reweight_sparse,
)
from repro_torch.core.topology import SparseTopology
from repro_torch.optim.optimizers import apply_updates_
from repro_torch.utils.pytree import tree_map, tree_unvector


def node_scale(tree, scale):
    """Multiply every node-stacked leaf by a per-node (N,) factor."""
    return tree_map(lambda a: a * scale.reshape((-1,) + (1,) * (a.dim() - 1)), tree)


def node_where(mask, new, old):
    """Per-node select between two node-stacked trees: ``new`` where
    mask > 0, else ``old``."""
    return tree_map(
        lambda n, o: torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)) > 0, n, o),
        new, old,
    )


def node_where_(mask, new, old):
    """:func:`node_where` written into ``new``'s leaves in place."""
    def f(n, o):
        torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)) > 0, n, o, out=n)
        return n

    return tree_map(f, new, old)


def per_edge_bytes(nbytes: float, deg_eff, device) -> torch.Tensor:
    """The bytes of one message, fp32 on ``device``, as the reference
    divides a round's bytes by its degree: a churn round's degree (an
    ``np.float32`` from the host) by an fp32 division, the static mean
    degree (a Python float, a constant to XLA) by a multiplication with
    its fp32 reciprocal.  Both operands are device tensors, so the card
    rounds as the CPU does."""
    nb = torch.full((), nbytes, dtype=torch.float32, device=device)
    if not deg_eff > 0:
        return torch.zeros_like(nb)
    d = max(float(deg_eff), 1e-9)
    if isinstance(deg_eff, np.floating):
        return nb / torch.tensor(d, dtype=torch.float32, device=device)
    return nb * torch.tensor(1.0 / d, dtype=torch.float32, device=device)


class RoundFaults(NamedTuple):
    """One round's fault draws (``core/faults.py``), each as ``(device
    tensor, host array)`` or None: ``live`` and ``spike`` (N, E) per-edge
    {0,1} over the mixing operand's edge layout (neighbour slots, or the
    columns of a dense W), ``corrupt`` (N,) {0,1}."""

    live: Optional[Tuple[torch.Tensor, np.ndarray]] = None
    spike: Optional[Tuple[torch.Tensor, np.ndarray]] = None
    corrupt: Optional[Tuple[torch.Tensor, np.ndarray]] = None


@dataclasses.dataclass(eq=False)
class RoundSteps:
    """The per-round step functions of the synchronous scheduler.

    compute_node: (N,) fp32 per-node local compute seconds.
    lat/goodput: (N, N) fp32 link matrices of the simulated network, or None.
    base_key: the ``prng`` key each round's sharing key is folded from.
    live_edges: ``(nbr, live)`` host arrays of the static mixing operand's
    edges (see ``sharing.participation_deg_eff``), for churn rounds; a
    dynamic overlay passes each round's own to :meth:`train_and_mix`.
    lr_scales: (N,) per-node learning-rate multipliers, or None.
    """

    loss_fn: Callable
    opt: Any
    sharing: Any
    template: Any
    mean_degree: float
    compute_node: torch.Tensor
    parallel_sends: bool
    lat: Optional[torch.Tensor] = None
    goodput: Optional[torch.Tensor] = None
    base_key: prng.Key = prng.key(17)
    live_edges: Optional[Tuple[Optional[np.ndarray], np.ndarray]] = None
    lr_scales: Optional[torch.Tensor] = None
    # fault injection (core/faults.py): the plan and its root key; None
    # leaves out every fault branch
    faults: Optional[faults_lib.FaultPlan] = None
    fault_key: Optional[prng.Key] = None

    def local_train(self, params, opt_state, bx, by, active=None, rows=None, shard=None):
        """``bx.shape[0]`` SGD steps on every node at once: per-node
        gradients by ``vmap(grad(loss_fn))``.  ``params`` are views of the
        flat state and are updated in place.  A down node (active 0) takes
        a zero update and keeps its optimizer state.  ``rows`` (global node
        ids) marks a gathered row subset, the cohort path's hot set, whose
        per-node learning rates are those rows'; ``shard`` a sharded
        rank's block, whose rates are its block's."""
        node_grad = vmap(grad(self.loss_fn))
        lrs = self.lr_scales
        if lrs is not None and rows is not None:
            lrs = lrs[rows]
        elif lrs is not None and shard is not None:
            lrs = shard.local(lrs)
        for s in range(bx.shape[0]):
            grads = node_grad(params, bx[s], by[s])
            updates, new_opt = self.opt.update(grads, opt_state, params)
            if lrs is not None:
                updates = node_scale(updates, lrs)
            if active is not None:
                updates = node_scale(updates, active)
                new_opt = node_where(active, new_opt, opt_state)
            apply_updates_(params, updates)
            opt_state = new_opt
        return params, opt_state

    def round_time(self, Wm, nbytes: float, deg_eff, active=None, lat_mult=None,
                   reduce: str = "max", shard=None):
        """Simulated round wall-clock, fp32 on the device, from the
        per-node ``network.node_round_times`` (a down node's time counts
        0): their max (``reduce="max"``, the synchronous barrier) or the
        (N,) vector itself (``"none"``, for the local and async clocks).
        For a SparseTopology the per-edge latency and goodput are gathered
        through the neighbor table.  ``lat_mult`` multiplies each edge's
        latency (latency spikes), in ``Wm``'s edge layout.  Sharded
        (``shard``, ``Wm`` a sharded operand): this rank's rows, indexing
        the replicated link matrices by global id; the max is this rank's,
        and the caller reduces it over the ranks."""
        dev = self.lat.device
        per_edge = per_edge_bytes(nbytes, deg_eff, dev)
        ct = self.compute_node if shard is None else shard.local(self.compute_node)
        if isinstance(Wm, ShardedTopology):
            rows = Wm.rows[:, None]
            nbr = Wm.nbr.long()
            A = (Wm.w > 0).to(torch.float32)
            lat = self.lat[rows, nbr]
            gp = self.goodput[rows, nbr]
        elif isinstance(Wm, ShardedDense):
            rows = Wm.rows
            offdiag = torch.arange(Wm.W.shape[1], device=dev)[None, :] != rows[:, None]
            A = (Wm.W * offdiag > 0).to(torch.float32)
            lat, gp = self.lat[rows], self.goodput[rows]
        elif isinstance(Wm, SparseTopology):
            rows = torch.arange(Wm.nbr.shape[0], device=dev)[:, None]
            nbr = Wm.nbr.long()
            A = (Wm.w > 0).to(torch.float32)
            lat = self.lat[rows, nbr]
            gp = self.goodput[rows, nbr]
        else:
            n = Wm.shape[0]
            offdiag = 1.0 - torch.eye(n, dtype=torch.float32, device=dev)
            A = (Wm * offdiag > 0).to(torch.float32)
            lat, gp = self.lat, self.goodput
        if lat_mult is not None:
            lat = lat * lat_mult
        node_t = node_round_times(A, lat, gp, per_edge, ct, self.parallel_sends)
        if active is not None:
            node_t = active * node_t
        return node_t if reduce == "none" else node_t.max()

    def cohort_comm_time(self, rows, nbr, live, nbytes: float, deg_eff):
        """Per-event comm seconds of a gathered cohort: the (C,)-row slice
        of ``round_time(..., reduce="none") - compute_node`` that the dense
        async path computes over all N rows, expression for expression
        (the per-edge bytes, the ``(ct + comm) - ct`` round trip), so the
        cohort's clock equals the dense one.  rows (C,) global ids; nbr
        their (C, D) global neighbour ids; live (C, D) {0,1} live edges."""
        ct = self.compute_node[rows]
        node_t = gathered_round_times(self.lat, self.goodput, rows, nbr.long(), live,
                                      per_edge_bytes(nbytes, deg_eff, ct.device), ct,
                                      self.parallel_sends)
        return node_t - ct

    def _secure_recovery_bytes(self, active: np.ndarray) -> np.float32:
        """Wire bytes of the seed-recovery pass: one revealed seed share per
        (live receiver, live sender, dropped co-neighbour) triple of the
        secure-aggregation neighbour table.  Counts are integers, exact in
        fp32 as the reference sums them."""
        a = active.astype(np.float32)
        valid = self.sharing._valid.astype(np.float32)
        nbr_act = a[self.sharing._nbr]
        live, dead = valid * nbr_act, valid * (1.0 - nbr_act)
        pairs = np.float32(np.sum(a * live.sum(1) * dead.sum(1), dtype=np.float32))
        return pairs * np.float32(SEED_SHARE_BYTES)

    def share_operands(self, W, rnd: int, act=None, live_edges=None):
        """The share step's operands for round ``rnd``: ``(Wm, degree, key,
        kwargs)``.  Under churn (``act`` as in :meth:`train_and_mix`) the
        mixing operand is reweighted on the device, the degree is computed
        on the host from ``live_edges`` (this round's edges; the static
        operand's by default), and a strategy that ``needs_act`` (secure
        recovery; TopK and CHOCO, to freeze a down node's state) gets the
        mask as ``act=``.  A sharded operand's reweight gathers the
        neighbours' mask over the ranks."""
        key = prng.fold_in(self.base_key, rnd)
        if act is None:
            return W, self.mean_degree, key, {}
        if isinstance(W, (SparseTopology, ShardedTopology)):
            Wm = participation_reweight_sparse(W, act[0], shard=getattr(W, "shard", None))
        elif isinstance(W, ShardedDense):
            Wm = ShardedDense(participation_reweight(W.W, act[0], shard=W.shard), W.shard)
        else:
            Wm = participation_reweight(W, act[0])
        deg = participation_deg_eff(*(live_edges or self.live_edges), act[1])
        share_kw = {"act": act[0]} if getattr(self.sharing, "needs_act", False) else {}
        return Wm, deg, key, share_kw

    def train_and_mix(self, X, opt_state, share_state, bx, by, W, rnd: int = 0, act=None,
                      live_edges=None, faults: Optional[RoundFaults] = None,
                      time_reduce: str = "max", shard=None):
        """One round: local steps (in place on X), then the share/mix step.

        ``act`` is None for full participation, else the round's mask as
        ``(device (N,) fp32 tensor, host (N,) numpy array)`` (churn and
        crash windows): the mixing operand is churn-reweighted on the
        device, the degree and bytes are computed on the host (from
        ``live_edges``, the round's edges of a dynamic overlay), and down
        nodes keep their parameters and their sharing state.

        With a fault plan, ``faults`` holds the round's draws and the
        round follows the reference's order: a snapshot of X, the
        optimizer state and the sharing state (when corruption is on);
        local steps; the churn reweight; lost edges dropped from the mixing
        operand (bytes and link time are still charged on the churn-level
        operand); the share step; corruption of active rows after the mix;
        the freeze of down nodes; the guard's rollback of non-finite
        active rows to the snapshot.

        Returns ``(X', opt_state, share_state, nbytes, sim_t, fstats)``:
        the bytes each node sent (seed-recovery bytes included) as an
        fp32-rounded float, the simulated round time as a 0-d device
        tensor (``time_reduce="max"``) or the (N,) per-node times
        (``"none"``, for the local scheduler's clocks; the compute times
        alone without a network model), and the ``faults.STAT_KEYS``
        counters, floats or (the guard's detections) 0-d device
        tensors.

        ``shard``: a sharded rank's round (module docstring): ``act`` is
        then ``(this rank's (B,) block on the device, the global (N,) host
        mask)`` and the round time this rank's maximum."""
        plan = self.faults
        fstats = faults_lib.zero_stats()
        active = None if act is None else act[0]
        guard = plan is not None and plan.corrupt_prob > 0
        if guard:  # local steps and TopK/CHOCO update these in place
            snap = (X.clone(), tree_map(torch.clone, opt_state),
                    tree_map(torch.clone, share_state))
        params = tree_unvector(X, self.template)
        _, opt_state = self.local_train(params, opt_state, bx, by, active, shard=shard)
        Wm, deg, key, share_kw = self.share_operands(W, rnd, act, live_edges)
        Wm_mix, lat_mult = Wm, None
        if plan is not None and plan.edge_faults:
            live, spike = faults.live, faults.spike
            reweight = edge_reweight_sparse if isinstance(Wm, SparseTopology) else edge_reweight
            Wm_mix = reweight(Wm, live[0])
            sent = live_edge_mask(*(live_edges or self.live_edges),
                                  None if act is None else act[1])
            hit = float(np.count_nonzero(sent & (live[1] == 0))
                        + np.count_nonzero(sent & (spike[1] > 0)))
            if plan.latency_spike_prob > 0:
                lat_mult = 1.0 + spike[0] * (plan.latency_spike_factor - 1.0)
            # drops are absorbed by the renormalization, spikes by late
            # delivery: survived by design
            fstats["faults_injected"] += hit
            fstats["faults_survived"] += hit
        X2, share_state, nbytes = self.sharing.round(
            X, Wm_mix, share_state, key=key, degree=deg, rnd=rnd, **share_kw
        )
        nbytes = np.float32(nbytes)
        if act is not None and getattr(self.sharing, "recovery", False):
            rec = self._secure_recovery_bytes(act[1])
            nbytes = nbytes + rec
            fstats["recovery_bytes"] += float(rec)
        if guard:
            cmask, cmask_np = faults.corrupt
            if act is not None:  # a down node received nothing
                cmask, cmask_np = cmask * active, cmask_np * act[1]
            # the strategies return a fresh X2: corrupt it in place
            X2 = faults_lib.corrupt_rows_(X2, cmask, plan.corrupt_mode)
            fstats["faults_injected"] += float(np.count_nonzero(cmask_np))
        if active is not None:
            X2 = torch.where(active[:, None] > 0, X2, X)
        if guard:
            bad = faults_lib.nonfinite_rows(X2)
            if active is not None:
                bad = bad * active
            good = 1.0 - bad
            X0, opt0, share0 = snap
            torch.where(good[:, None] > 0, X2, X0, out=X2)
            opt_state = node_where(good, opt_state, opt0)
            share_state = node_where_(good, share_state, share0)
            fstats["faults_detected"] = fstats["faults_recovered"] = bad.sum()
        if self.lat is not None:
            sim_t = self.round_time(Wm, float(nbytes), deg, active, lat_mult,
                                    reduce=time_reduce, shard=shard)
        elif time_reduce == "none":
            # no network: comm is free, the compute times still drive the
            # clocks (as the async scheduler's cadence is compute-only)
            sim_t = self.compute_node if active is None else active * self.compute_node
        else:
            sim_t = torch.zeros((), dtype=torch.float32, device=X.device)
        return X2, opt_state, share_state, float(nbytes), sim_t, fstats
