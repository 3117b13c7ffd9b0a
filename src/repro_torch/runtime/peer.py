"""One worker process of the real-network backend.

A worker owns a contiguous row-block of ``B = N/K`` nodes and runs the
synchronous semantics for them on real clocks, on the torch device of the
run spec (the card unless it names the CPU):

    every round:  local SGD on own rows (``RoundSteps.local_train``, in a
                  thread so the event loop keeps pumping heartbeats) ->
                  serialize the payload wire format for exactly the rows
                  each peer's nodes neighbor -> TCP send (per-message
                  timeout, shared exponential-backoff retry) ->
                  barrier-gather peer payloads -> merge own rows through
                  the simulator's kernels (one gather-merge launch,
                  ``gossip_mix_rows``, over the own rows' merge tables for
                  full sharing; one payload-merge launch,
                  ``payload_mix_rows``, for random-k, with the int8 codec
                  kernels on the wire values).

Determinism mirrors the engine exactly — each node's parameters drawn
from its own generator seeded ``seed * 1_000_003 + i`` by global id i (or
the rows of injected parameters), batches from the ``NodeBatcher`` PCG64
stream keyed by absolute round, payload coordinate draws per-node keyed
by *global* id (``sharing._randk_idx(rows=...)``), gossip key
``fold_in(base_key, rnd)`` — which is what makes the loss-free-localhost
equivalence oracle (process trajectory == simulator trajectory) hold.
The state ``X_view`` (N, P) stays on the device; wire bytes are staged
through host buffers.

## Join/leave protocol and failure detection

Workers discover each other through the rendezvous registry, then hold a
full mesh of directed TCP connections.  A heartbeat beacon doubles as
the failure detector: a peer silent for ``dead_timeout_s`` (or whose
sends exhaust the retry budget) is declared dead, its nodes' edges are
reweighted away via ``sharing.edge_reweight_sparse`` — surviving rows
stay row-stochastic, training completes on the survivors.  A graceful
leave announces itself with a BYE frame (counted as a leave, not a
fault); a SIGKILL'd worker never says goodbye, so its silence is counted
in ``faults_detected``.  A per-round watchdog bounds any socket wait so
a hung transport fails fast instead of stalling forever.  Every kernel
the worker will launch runs once before it registers (``_warmup``), so
no peer takes a first-use stall for death.

## Elastic membership: crash-rejoin

All liveness/epoch bookkeeping lives in :class:`runtime.membership.Membership`;
this module wires it to the sockets.  A supervisor-relaunched worker
(``--rejoin --epoch E``) restores its row-block from its newest
checkpoint (``run_dir/ckpt_w{wid}``, written every ``ckpt_every`` rounds
*before* the progress marker so visible progress implies a durable
checkpoint) or, with no checkpoint, cold-syncs a live donor's current
block over ``STATE_REQ``/``STATE`` frames.  It then runs the two-phase
JOIN handshake: *hello* (announce the new endpoint + epoch; survivors
reply WELCOME with their current round) and *commit* (pick a start round
safely past every survivor's current round; each survivor schedules the
re-admission for the top of exactly that round).  At admission the
survivor clears the dead mark and rebuilds its effective topology from
the pristine table (``sharing.edge_readmit_sparse`` — with everyone live
again this *is* the pristine object, so the fault-free mixing matrix is
restored bitwise).  Every frame carries the sender's epoch; frames from
dead/left senders or older incarnations are dropped — never enqueued —
and counted under ``stale_frames_dropped``.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch import prng
from repro_torch.checkpoint import load_checkpoint, restore_tree, save_checkpoint
from repro_torch.core.compression import dequantize_int8, quantize_int8
from repro_torch.core.engine import DLConfig, build_graph, resolve_device
from repro_torch.core.faults import retry_backoff_delay
from repro_torch.core.sharing import _randk_idx, edge_readmit_sparse
from repro_torch.core.steps import RoundSteps
from repro_torch.core.topology import SparseTopology
from repro_torch.kernels.gossip_mix import gossip_mix_rows
from repro_torch.kernels.quantize import dequantize, quantize
from repro_torch.kernels.scatter_gossip import payload_mix_rows
from repro_torch.runtime import transport as tp
from repro_torch.runtime.membership import Membership, zero_counters
from repro_torch.runtime.runner import build_workload
from repro_torch.utils.io import atomic_write_json
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unvector, tree_vector

# evaluation runs over groups of nodes sized so that one group's input
# activations stay near this many elements (the engine's grouping)
_EVAL_ELEMS = 1 << 25


def _kernel_wrappers() -> Dict:
    """The kernel wrappers a worker launches, by the names the results
    report (each counts its kernel's launches in ``.launches``)."""
    return {"gossip_mix_rows": gossip_mix_rows, "payload_mix_rows": payload_mix_rows,
            "quantize": quantize, "dequantize": dequantize}


class PeerWorker:
    def __init__(self, spec: Dict, wid: int, *, epoch: int = 0,
                 rejoin: bool = False):
        self._t0 = time.monotonic()
        self.spec = spec
        self.wid = wid
        self.epoch = int(epoch)
        self.rejoin = bool(rejoin)
        dl = DLConfig(**spec["dl"])
        dl.validate()
        assert dl.backend == "processes"
        self.dl = dl
        self.device = dev = resolve_device(spec.get("device"))
        if dev.type == "cuda":
            # full fp32 on the card, as the engine runs (process-wide)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        else:
            # K workers share the host's cores with each other
            torch.set_num_threads(1)
        self.K = int(spec["workers"])
        n = dl.n_nodes
        self.B = n // self.K
        self.lo, self.hi = wid * self.B, (wid + 1) * self.B
        self.own_ids = np.arange(self.lo, self.hi)
        self.rounds = int(spec.get("rounds", dl.rounds))
        self.ev = max(dl.eval_every, 1)
        # timeouts / retry policy (the fault axis' backoff, on the wall clock)
        self.hb_interval_s = float(spec.get("hb_interval_s", 0.25))
        self.dead_timeout_s = float(spec.get("dead_timeout_s", 3.0))
        self.watchdog_s = float(spec.get("watchdog_s", 60.0))
        self.send_timeout_s = float(spec.get("send_timeout_s", 10.0))
        self.backoff_s = float(spec.get("retry_backoff_s", 0.05))
        self.backoff_cap = int(spec.get("retry_backoff_cap", 5))
        # elastic-membership knobs: checkpoint cadence (0 = off), a round
        # floor so rejoin lands mid-run instead of after the run finished,
        # and the bitwise view dump the chaos gate reads
        self.ckpt_every = int(spec.get("ckpt_every", 0))
        self.round_min_s = float(spec.get("round_min_s", 0.0))
        self.dump_view = bool(spec.get("dump_view", False))
        self.run_dir = spec["run_dir"]
        self.rdv = tuple(spec["rendezvous"])
        # torch work runs on one thread, in order, off the event loop
        self._pool = ThreadPoolExecutor(1)

        # --- experiment state (identical derivations to RoundEngine) ----
        init_fn, loss_fn, acc_fn, opt, batcher = build_workload(spec["workload"], dl)
        self.batcher, self.acc_fn, self.opt = batcher, acc_fn, opt
        self._dev_x = torch.as_tensor(batcher.x, device=dev)
        self._dev_y = torch.as_tensor(batcher.y, device=dev).long()
        self.template = init_fn(torch.Generator(device=dev).manual_seed(dl.seed * 1_000_003))
        self.P = P = int(tree_vector(self.template).numel())
        self.X_view = torch.zeros((n, P), dtype=torch.float32, device=dev)
        if spec.get("init_params"):
            X0 = np.load(spec["init_params"], mmap_mode="r")
            self.X_view[self.lo:self.hi] = torch.as_tensor(np.array(X0[self.lo:self.hi]))
        else:
            for i in self.own_ids:
                gen = torch.Generator(device=dev).manual_seed(dl.seed * 1_000_003 + int(i))
                self.X_view[i].copy_(tree_vector(init_fn(gen)))
        # the own parameters: views of the own rows of X_view
        self.params = tree_unvector(self.X_view[self.lo:self.hi], self.template)
        self.opt_state = opt.init(self.params)
        self.steps = RoundSteps(loss_fn=loss_fn, opt=opt, sharing=None, template=self.template,
                                mean_degree=float(dl.degree), compute_node=None,
                                parallel_sends=False)
        self._base_key = prng.key(dl.seed + 17)

        graph = build_graph(dl)
        topo = SparseTopology.from_graph(graph)
        self.nbr = np.asarray(topo.nbr)
        self.w0 = np.asarray(topo.w, np.float32)
        self.w_self0 = np.asarray(topo.w_self, np.float32)
        self.topo_base = topo.to(dev)  # the pristine tables
        self.live_nodes = np.ones(n, np.float32)
        # per-peer send/need sets from the genuine-edge mask (w > 0)
        valid = self.w0 > 0
        need = np.zeros((self.K, n), bool)  # need[v, i]: worker v reads row i
        owner = np.arange(n) // self.B
        for j in range(n):
            need[owner[j], self.nbr[j, valid[j]]] = True
        self.send_to = {
            v: np.array([i for i in self.own_ids if need[v, i]], np.int32)
            for v in range(self.K) if v != wid
        }
        self.need_from = {
            v: np.array(
                [j for j in range(v * self.B, (v + 1) * self.B)
                 if need[wid, j]], np.int32)
            for v in range(self.K) if v != wid
        }

        # --- sharing strategy: full rows or randomk payloads ------------
        self.payload = dl.sharing.lower() in ("randomk", "random")
        self.quantize = self.payload and dl.payload_quant
        self.k = max(1, int(dl.budget * P)) if self.payload else 0
        self._own_rows_dev = torch.as_tensor(self.own_ids, device=dev)
        self._set_topo(self.topo_base)
        # host staging buffers (pinned on the card): the own block out,
        # one received block in
        pin = dev.type == "cuda"
        width = self.k if self.payload else P
        self._host_out = torch.empty((self.B, width), dtype=torch.float32, pin_memory=pin)
        self._host_in = torch.empty((self.B * width * 4,), dtype=torch.uint8, pin_memory=pin)

        # --- runtime state ----------------------------------------------
        self.mem = Membership(self.K, wid, self.dead_timeout_s)
        self.peers: Dict[int, Tuple[str, int]] = {}
        self.conns: Dict[int, Tuple] = {}
        # every inbox exists before the server accepts: a peer that learns
        # our address first may send its round-0 rows while we still
        # register or dial the others
        self.inbox: Dict[int, asyncio.Queue] = {
            v: asyncio.Queue() for v in range(self.K) if v != wid
        }
        self._pending_bye: set = set()
        self._ctrl_q: asyncio.Queue = asyncio.Queue()
        self._state_q: asyncio.Queue = asyncio.Queue()
        self.wire_bytes = 0.0
        self.counters = zero_counters()
        self.detect_rounds: Dict[str, int] = {}
        self.admit_rounds: Dict[str, int] = {}
        self.reweight_row_err = 0.0
        self.round_wall: List[float] = []
        self.round_phases: List[Dict[str, float]] = []
        self._phase: Dict[str, float] = {}
        self.records: List[Dict] = []
        self.cur_round = -1
        self.start_round = 0
        self.rejoined = False
        self.completed = False
        self.catchup_source: Optional[str] = None
        self._last_sent: Optional[np.ndarray] = None
        self.warmup_launches: Dict[str, int] = {}
        self.boot_s: Dict[str, float] = {}

    # back-compat views (tests and the runner read these)
    @property
    def dead(self) -> set:
        return self.mem.dead

    @property
    def left(self) -> set:
        return self.mem.left

    # ------------------------------------------------------------------
    # device <-> host
    # ------------------------------------------------------------------
    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A received (read-only, host) array on the device, through the
        inbound staging buffer (a blocking copy, so the buffer is free
        again on return)."""
        arr = np.ascontiguousarray(arr)
        if self.device.type == "cpu":
            return torch.from_numpy(arr.copy())
        if arr.nbytes > self._host_in.numel():  # a donor's STATE block
            self._host_in = torch.empty((arr.nbytes,), dtype=torch.uint8, pin_memory=True)
        buf = self._host_in[:arr.nbytes].numpy().view(arr.dtype).reshape(arr.shape)
        buf[...] = arr
        return torch.from_numpy(buf).to(self.device)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """An fp32 (B, width) device tensor in the outbound staging buffer
        (valid until the next call)."""
        out = self._host_out[:, :t.shape[1]]
        out.copy_(t)
        return out.numpy()

    def _set_topo(self, topo_eff):
        """Install an effective topology: its merge tables' own rows are
        the operands of the round's one merge launch."""
        self.topo_eff = topo_eff
        rows, w = topo_eff.merge_tables(include_self=not (self.payload and not self.quantize))
        self._merge_rows = rows[self.lo:self.hi].contiguous()
        self._merge_w = w[self.lo:self.hi].contiguous()

    # ------------------------------------------------------------------
    # the compute (torch; runs on the worker's one compute thread)
    # ------------------------------------------------------------------
    def _local(self, rnd: int, params, opt_state):
        """Local SGD on the own rows for round ``rnd`` (in place on
        ``params``); returns the new optimizer state."""
        idx = self.batcher.round_indices(rnd, self.dl.local_steps)[:, self.lo:self.hi]
        idx = torch.as_tensor(idx, device=self.device).long()
        _, opt_state = self.steps.local_train(params, opt_state, self._dev_x[idx],
                                              self._dev_y[idx])
        return opt_state

    def _emit(self, rnd: int, X_own):
        """The own payload of round ``rnd``: device (idx, val the receivers
        reconstruct) and host (idx, val or codes and scales) forms."""
        key = prng.fold_in(self._base_key, rnd)
        idx = _randk_idx(key, (self.B, self.P), self.k, self.device, rows=self._own_rows_dev)
        val = X_own.gather(1, idx.long())
        host = {"idx": idx.cpu().numpy()}
        if self.quantize:
            codes, scale = quantize_int8(val)
            val = dequantize_int8(codes, scale)
            host["codes"] = codes.cpu().numpy()
            host["scale"] = scale.reshape(-1).cpu().numpy()
        else:
            host["val"] = self._to_host(val)
        return idx, val, host

    def _merge(self, X_own, got: Dict[int, Dict], own_pay=None):
        """The round's merge of the own rows, written into X_view."""
        if self.payload:
            n = self.dl.n_nodes
            idx_all = torch.zeros((n, self.k), dtype=torch.int32, device=self.device)
            val_all = torch.zeros((n, self.k), dtype=torch.float32, device=self.device)
            idx_all[self.lo:self.hi], val_all[self.lo:self.hi] = own_pay
            for msg in got.values():
                ids = torch.as_tensor(msg["ids"].astype(np.int64), device=self.device)
                if msg["fmt"] == tp.FMT_PAYLOAD_I8:
                    val = dequantize_int8(self._to_device(msg["codes"]),
                                          self._to_device(msg["scale"]).reshape(-1, 1))
                else:
                    val = self._to_device(msg["val"])
                idx_all[ids] = self._to_device(msg["idx"])
                val_all[ids] = val
            # every sender sorts its index rows (sharing._randk_select)
            X2 = payload_mix_rows(X_own, idx_all, val_all, self._merge_rows, self._merge_w,
                                  sorted_idx=True)
        else:
            for msg in got.values():
                ids = torch.as_tensor(msg["ids"].astype(np.int64), device=self.device)
                self.X_view[ids] = self._to_device(msg["rows"])
            X2 = gossip_mix_rows(self.X_view, self._merge_rows, self._merge_w)
        X_own.copy_(X2)

    @torch.no_grad()
    def _eval_accs(self, params) -> np.ndarray:
        """(B,) per-node accuracy on the test batch, over node groups."""
        tx, ty = self.batcher.test_batch()
        tx = torch.as_tensor(tx, device=self.device)
        ty = torch.as_tensor(ty, device=self.device).long()
        group = max(1, _EVAL_ELEMS // max(tx.numel(), 1))
        node_acc = vmap(lambda p: self.acc_fn(p, tx, ty))
        accs = [node_acc(tree_map(lambda a: a[i:i + group], params))
                for i in range(0, self.B, group)]
        return torch.cat(accs).float().cpu().numpy()

    def _warmup(self):
        """Launch every kernel and trace every function before joining
        the mesh, on copies of the state, so no peer mistakes a first-use
        stall for death and the round walls calibration records exclude
        it.  The kernel counts restart from 0 afterwards."""
        X_own = self.X_view[self.lo:self.hi].clone()
        params = tree_unvector(X_own, self.template)
        self._local(0, params, self.opt.init(params))
        if self.payload:
            idx, val, host = self._emit(0, X_own)
            got = {}
            if self.quantize:  # a received int8 frame's dequantize too
                got = {-1: {"fmt": tp.FMT_PAYLOAD_I8, "ids": self.own_ids[:1],
                            "idx": host["idx"][:1], "codes": host["codes"][:1],
                            "scale": host["scale"][:1]}}
            self._merge(X_own, got, (idx, val))
        else:
            # no frame: the merge reads X_view and writes only X_own
            self._to_host(X_own)
            self._merge(X_own, {})
        self._eval_accs(params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wrappers = _kernel_wrappers()
        self.warmup_launches = {k: int(f.launches) for k, f in wrappers.items()}
        for f in wrappers.values():
            f.launches = 0

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------
    def _rows_of(self, v: int) -> np.ndarray:
        return np.arange(v * self.B, (v + 1) * self.B)

    def _recompute_topo(self):
        """Effective topology from the *pristine* table and the current
        live mask: the reweight on deaths, the exact (bitwise, when all
        rows are live again) restore on re-admissions."""
        live = torch.as_tensor(self.live_nodes[self.nbr], device=self.device)
        self._set_topo(edge_readmit_sparse(self.topo_base, live))

    def _purge_inbox(self, v: int):
        q = self.inbox.get(v)
        if q is None:
            return
        while not q.empty():
            q.get_nowait()
            self.counters["stale_frames_dropped"] += 1

    def _mark_gone(self, v: int, rnd: int, *, fault: bool):
        """Graceful-degradation path: drop worker v's nodes and return
        their edge mass to the surviving receivers' diagonals
        (``edge_reweight_sparse`` — the fault axis' reweight, reused on
        real deaths), so surviving rows stay row-stochastic.  Already-queued
        frames from v are purged (and counted stale) — a corpse's rows
        must not feed a later barrier."""
        if not self.mem.is_live(v):
            return
        if fault:
            self.mem.declare_dead(v)
            self.counters["faults_detected"] += 1
        else:
            self.mem.declare_left(v)
            self.counters["leaves"] += 1
        self.live_nodes[self._rows_of(v)] = 0.0
        self._recompute_topo()
        w = self.topo_eff.w.cpu().numpy()
        ws = self.topo_eff.w_self.cpu().numpy()
        rows = slice(self.lo, self.hi)
        err = float(np.abs(ws[rows] + w[rows].sum(-1) - 1.0).max())
        self.reweight_row_err = max(self.reweight_row_err, err)
        self.detect_rounds[str(v)] = rnd
        self.conns.pop(v, None)
        self._purge_inbox(v)

    def _process_admissions(self, rnd: int):
        """Top-of-round hook: re-admit every peer whose committed start
        round has arrived — clear the dead mark, restore the pristine
        edge weights, and resume expecting its rows this very round."""
        for v in self.mem.due_admissions(rnd):
            was_dead = self.mem.admit(v)
            self.live_nodes[self._rows_of(v)] = 1.0
            self._recompute_topo()
            if was_dead:
                self.counters["rejoin_total"] += 1
            self.mem.last_seen[v] = time.monotonic()
            self.admit_rounds[str(v)] = rnd

    def _live_peers(self) -> List[int]:
        return self.mem.live_peers()

    # ------------------------------------------------------------------
    # transport
    # ------------------------------------------------------------------
    async def _handle_conn(self, reader, writer):
        try:
            while True:
                ftype, body = await tp.read_frame(reader)
                if ftype == tp.MSG_ROWS:
                    msg = tp.decode_rows(body)
                    v = msg["sender"]
                    st = self.mem.frame_status(v, msg["epoch"])
                    if st == "ok":
                        self.mem.last_seen[v] = time.monotonic()
                        self.inbox[v].put_nowait(msg)
                    elif st == "stale":
                        self.counters["stale_frames_dropped"] += 1
                elif ftype == tp.MSG_HEARTBEAT:
                    v, ep = tp.decode_peer(body)
                    if self.mem.heartbeat(
                            v, ep, time.monotonic()) == "stale":
                        self.counters["stale_frames_dropped"] += 1
                elif ftype == tp.MSG_BYE:
                    # graceful leave: the barrier stops expecting rows from
                    # v (same reweight as a death, counted as a leave)
                    v, ep = tp.decode_peer(body)
                    if self.mem.frame_status(v, ep) == "ok":
                        self._pending_bye.add(v)
                    else:
                        self.counters["stale_frames_dropped"] += 1
                elif ftype == tp.MSG_JOIN:
                    await self._on_join(tp.decode_json(body))
                elif ftype == tp.MSG_WELCOME:
                    msg = tp.decode_json(body)
                    v = int(msg["worker"])
                    # a WELCOME teaches the joiner the survivor's epoch
                    # (a survivor may itself be a prior rejoiner, and the
                    # joiner's fresh view starts everyone at epoch 0)
                    self.mem.epochs[v] = max(
                        self.mem.epochs.get(v, 0), int(msg["epoch"])
                    )
                    self.mem.last_seen[v] = time.monotonic()
                    self._ctrl_q.put_nowait(msg)
                elif ftype == tp.MSG_STATE_REQ:
                    await self._on_state_req(tp.decode_json(body))
                elif ftype == tp.MSG_STATE:
                    self._state_q.put_nowait((tp.decode_rows(body), len(body)))
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                ValueError):
            return
        finally:
            writer.close()

    async def _send_ctrl(self, v: int, ftype: int, body: bytes) -> bool:
        """Best-effort control-plane send (JOIN/WELCOME/STATE*), reusing
        (or re-dialing) the data-plane connection to v."""
        try:
            if v not in self.conns:
                self.conns[v] = await asyncio.wait_for(
                    asyncio.open_connection(*self.peers[v]), timeout=2.0
                )
            await asyncio.wait_for(
                tp.write_frame(self.conns[v][1], ftype, body),
                timeout=self.send_timeout_s,
            )
            self.wire_bytes += len(body) + 5
            return True
        except (OSError, asyncio.TimeoutError, KeyError):
            self.conns.pop(v, None)
            return False

    async def _on_join(self, msg: Dict):
        """Survivor side of the two-phase rejoin handshake."""
        v, ep = int(msg["worker"]), int(msg["epoch"])
        phase = msg.get("phase")
        if phase == "hello":
            if self.mem.is_live(v) and ep > self.mem.epochs[v]:
                # the supervisor relaunched v before we ever noticed the
                # death: retire the old incarnation first so detection
                # and re-admission stay paired (conservation invariant)
                self._mark_gone(v, self.cur_round, fault=True)
            st = self.mem.hello(v, ep)
            if st == "stale":
                self.counters["stale_frames_dropped"] += 1
                return
            self.peers[v] = (msg["host"], int(msg["port"]))
            self.conns.pop(v, None)  # the old incarnation's socket
            self.mem.last_seen[v] = time.monotonic()
            await self._send_ctrl(v, tp.MSG_WELCOME, tp.encode_json({
                "phase": "hello", "worker": self.wid, "epoch": self.epoch,
                "round": self.cur_round, "ok": True,
            }))
        elif phase == "commit":
            start = int(msg["start_round"])
            ok = self.mem.schedule_admit(v, ep, start, self.cur_round)
            await self._send_ctrl(v, tp.MSG_WELCOME, tp.encode_json({
                "phase": "commit", "worker": self.wid, "epoch": self.epoch,
                "round": self.cur_round, "start": start, "ok": ok,
            }))

    async def _on_state_req(self, msg: Dict):
        """Donor side of cold catch-up: ship the current own-block rows
        (the STATE body reuses the ROWS codec)."""
        v = int(msg["worker"])
        rows = await asyncio.get_running_loop().run_in_executor(
            self._pool, lambda: self.X_view[self.lo:self.hi].cpu().numpy())
        body = tp.encode_rows(
            max(self.cur_round, 0), self.wid, self.own_ids, tp.FMT_FULL_F32,
            epoch=self.epoch, rows=rows,
        )
        await self._send_ctrl(v, tp.MSG_STATE, body)

    async def _heartbeat_loop(self):
        beat = tp.encode_peer(self.wid, self.epoch)
        while True:
            await asyncio.sleep(self.hb_interval_s)
            # beacon mid-rejoin peers too: a waiting rejoiner must not
            # mistake our silence for death before its start round
            for v in self.mem.beacon_targets():
                conn = self.conns.get(v)
                if conn is None:
                    continue
                try:
                    conn[1].write(
                        tp._FRAME.pack(tp.MSG_HEARTBEAT, len(beat)) + beat
                    )
                except OSError:
                    pass

    async def _send_rows(self, v: int, rnd: int, body: bytes) -> bool:
        """Per-message send with timeout and the shared exponential
        backoff; exhausting the retry budget declares the peer dead."""
        for attempt in range(self.backoff_cap + 2):
            try:
                if v not in self.conns:
                    self.conns[v] = await asyncio.open_connection(
                        *self.peers[v]
                    )
                await asyncio.wait_for(
                    tp.write_frame(self.conns[v][1], tp.MSG_ROWS, body),
                    timeout=self.send_timeout_s,
                )
                self.wire_bytes += len(body) + 5
                return True
            except (OSError, asyncio.TimeoutError):
                self.conns.pop(v, None)
                self.counters["retry_total"] += 1
                await asyncio.sleep(
                    retry_backoff_delay(attempt, self.backoff_s,
                                        self.backoff_cap)
                )
        self._mark_gone(v, rnd, fault=True)
        return False

    async def _gather(self, rnd: int) -> Dict[int, Dict]:
        """The sync barrier: one ROWS frame per live peer for this round.
        TCP ordering + one frame per (peer, round) means the next frame
        from a peer is this round's — anything else is a protocol error.
        Waits are sliced so heartbeat silence can be detected mid-wait;
        the whole barrier is bounded by the watchdog."""
        out: Dict[int, Dict] = {}
        t0 = time.monotonic()
        for v in list(self.need_from):
            if not len(self.need_from[v]):
                continue  # no edge crosses this worker pair
            while self.mem.is_live(v) and v not in out:
                # BYE is FIFO-ordered after the peer's last ROWS frame, so
                # only honor it once the inbox is drained — a leaver's
                # final-round contribution still counts
                if v in self._pending_bye and self.inbox[v].empty():
                    self._pending_bye.discard(v)
                    self._mark_gone(v, rnd, fault=False)
                    break
                try:
                    msg = await asyncio.wait_for(
                        self.inbox[v].get(), timeout=0.25
                    )
                except asyncio.TimeoutError:
                    now = time.monotonic()
                    if now - self.mem.last_seen.get(v, t0) \
                            > self.dead_timeout_s:
                        self._mark_gone(v, rnd, fault=True)
                    if now - t0 > self.watchdog_s:
                        raise RuntimeError(
                            f"worker {self.wid}: watchdog — round {rnd} "
                            f"barrier stalled > {self.watchdog_s}s on peer "
                            f"{v}"
                        )
                    continue
                if msg["round"] < rnd:
                    continue  # pre-death stragglers of an old round
                if msg["round"] > rnd and not self.mem.is_live(v):
                    # v's old incarnation was retired (a rejoin hello)
                    # while this barrier waited on it, and the new one's
                    # first frame, of its committed start round, came in
                    # within the same wait: keep it for that round (v
                    # sends nothing more before every survivor is there)
                    self.inbox[v].put_nowait(msg)
                    break
                if msg["round"] > rnd:
                    raise RuntimeError(
                        f"worker {self.wid}: protocol error — peer {v} "
                        f"sent round {msg['round']} during round {rnd}"
                    )
                out[v] = msg
        return out

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------
    def _train_and_encode(self, rnd: int, peers: List[int]):
        """Local steps, then the round's ROWS frames for ``peers`` (host
        bytes) and, for random-k, the own payload on the device."""
        X_own = self.X_view[self.lo:self.hi]
        t0 = time.monotonic()
        self.opt_state = self._local(rnd, self.params, self.opt_state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._phase["local"] = time.monotonic() - t0
        own_pay, bodies = None, {}
        if self.payload:
            idx, val, host = self._emit(rnd, X_own)
            own_pay = (idx, val)
        else:
            rows = self._to_host(X_own)
            if self.dump_view:
                self._last_sent = rows.copy()
        for v in peers:
            ids = self.send_to[v]
            if not len(ids):
                continue
            loc = ids - self.lo
            if not self.payload:
                bodies[v] = tp.encode_rows(rnd, self.wid, ids, tp.FMT_FULL_F32,
                                           epoch=self.epoch, rows=rows[loc])
            elif self.quantize:
                bodies[v] = tp.encode_rows(rnd, self.wid, ids, tp.FMT_PAYLOAD_I8,
                                           epoch=self.epoch, idx=host["idx"][loc],
                                           codes=host["codes"][loc], scale=host["scale"][loc])
            else:
                bodies[v] = tp.encode_rows(rnd, self.wid, ids, tp.FMT_PAYLOAD_F32,
                                           epoch=self.epoch, idx=host["idx"][loc],
                                           val=host["val"][loc])
        self._phase["encode"] = time.monotonic() - t0 - self._phase["local"]
        return own_pay, bodies

    async def _round(self, rnd: int):
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        self.cur_round = rnd
        self._process_admissions(rnd)
        self._phase = {}
        own_pay, bodies = await loop.run_in_executor(
            self._pool, self._train_and_encode, rnd, self._live_peers())
        t1 = time.monotonic()
        sends = [self._send_rows(v, rnd, body) for v, body in bodies.items()]
        if sends:
            await asyncio.gather(*sends)
        t2 = time.monotonic()
        got = await self._gather(rnd)
        t3 = time.monotonic()
        await loop.run_in_executor(
            self._pool, self._merge, self.X_view[self.lo:self.hi], got, own_pay)
        # where the round went: the local step (synchronised), the wire
        # encode (random-k's draw and codec, device->host, the frames),
        # the sends, the barrier wait, and the merge (the staging of
        # received frames included)
        self.round_phases.append({**self._phase, "send": t2 - t1, "gather": t3 - t2,
                                  "merge": time.monotonic() - t3})
        # round floor: pad so wall-clock rounds are long enough for a
        # killed worker's relaunch to land mid-run (chaos harness knob)
        dt = time.monotonic() - t0
        if self.round_min_s > dt:
            await asyncio.sleep(self.round_min_s - dt)
        self.round_wall.append(time.monotonic() - t0)

    # ------------------------------------------------------------------
    # checkpoint catch-up
    # ------------------------------------------------------------------
    def _ckpt_dir(self) -> str:
        return os.path.join(self.run_dir, f"ckpt_w{self.wid}")

    def _save_checkpoint(self, rnd: int):
        save_checkpoint(self._ckpt_dir(), rnd, params=self.params,
                        opt_state=self.opt_state)

    def _restore_checkpoint(self) -> Optional[int]:
        """Restore the newest readable checkpoint of this row-block;
        returns its round or None.  Saves are atomic, but stay defensive:
        an unreadable step falls back to the one before it."""
        path = self._ckpt_dir()
        if not os.path.isdir(path):
            return None
        steps = sorted(
            (int(m.group(1)) for f in os.listdir(path)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))),
            reverse=True,
        )
        for step in steps:
            try:
                _, trees = load_checkpoint(path, step)
                if "params" not in trees:
                    continue
                params = restore_tree(self.params, trees["params"])
                # a leafless opt_state (plain SGD) saves no arrays at all
                opt_state = restore_tree(self.opt_state, trees.get("opt_state"))
            except Exception:
                continue
            self.X_view[self.lo:self.hi] = torch.cat(
                [l.reshape(self.B, -1).to(torch.float32) for l in tree_leaves(params)], 1)
            self.opt_state = opt_state
            self.counters["catchup_bytes"] += os.path.getsize(
                os.path.join(path, f"ckpt_{step:08d}.npz")
            )
            self.catchup_source = f"checkpoint:{step}"
            return step
        return None

    async def _cold_sync(self, donors: List[int]) -> bool:
        """No checkpoint: pull a live donor's current block over
        STATE_REQ/STATE and map its rows onto ours (cyclically — blocks
        are equal-sized, so this is the identity map in practice); the
        optimizer state restarts fresh."""
        req = tp.encode_json({"worker": self.wid, "epoch": self.epoch})
        for v in donors:
            if not await self._send_ctrl(v, tp.MSG_STATE_REQ, req):
                continue
            try:
                msg, nbytes = await asyncio.wait_for(
                    self._state_q.get(), timeout=self.dead_timeout_s + 2.0
                )
            except asyncio.TimeoutError:
                continue
            rows = np.asarray(msg["rows"], np.float32)
            take = rows[np.arange(self.B) % len(rows)]
            self.X_view[self.lo:self.hi] = self._to_device(take)
            self.opt_state = self.opt.init(self.params)
            self.counters["catchup_bytes"] += nbytes
            self.catchup_source = f"donor:{msg['sender']}"
            return True
        return False

    # ------------------------------------------------------------------
    # rejoiner side of the handshake
    # ------------------------------------------------------------------
    async def _rejoin_handshake(self, my_port: int,
                                have_ckpt: bool) -> Optional[int]:
        """Hello every peer, catch up (donor STATE if no checkpoint),
        then commit a start round safely past every survivor's current
        round.  Returns the committed start round, or None when there is
        nothing left to rejoin (no survivors, or the run is ending)."""
        hello = tp.encode_json({
            "phase": "hello", "worker": self.wid, "epoch": self.epoch,
            "host": "127.0.0.1", "port": my_port,
        })
        targets = self.mem.live_peers()
        for v in targets:
            await self._send_ctrl(v, tp.MSG_JOIN, hello)
        welcomes: Dict[int, Dict] = {}
        deadline = time.monotonic() + self.dead_timeout_s + 2.0
        while len(welcomes) < len(targets) and time.monotonic() < deadline:
            try:
                msg = await asyncio.wait_for(self._ctrl_q.get(), timeout=0.25)
            except asyncio.TimeoutError:
                continue
            if msg.get("phase") == "hello" and msg.get("ok"):
                welcomes[int(msg["worker"])] = msg
        for v in targets:
            if v not in welcomes:
                self._mark_gone(v, -1, fault=True)
        if not welcomes:
            return None
        if not have_ckpt:
            await self._cold_sync(sorted(welcomes))
        if self.catchup_source is None:
            self.catchup_source = "fresh"

        # commit: everyone must re-admit us at the same future round
        slack = max(4, int(2.0 / max(self.round_min_s, 0.02)))
        for _attempt in range(6):
            cur = max(int(m["round"]) for m in welcomes.values())
            start = cur + slack
            if start >= self.rounds:
                return None  # the run ends before we could participate
            commit = tp.encode_json({
                "phase": "commit", "worker": self.wid, "epoch": self.epoch,
                "start_round": start,
            })
            for v in list(welcomes):
                await self._send_ctrl(v, tp.MSG_JOIN, commit)
            acks: Dict[int, Dict] = {}
            deadline = time.monotonic() + self.dead_timeout_s + 2.0
            while len(acks) < len(welcomes) \
                    and time.monotonic() < deadline:
                try:
                    msg = await asyncio.wait_for(
                        self._ctrl_q.get(), timeout=0.25
                    )
                except asyncio.TimeoutError:
                    continue
                if msg.get("phase") == "commit" \
                        and int(msg.get("start", -1)) == start:
                    acks[int(msg["worker"])] = msg
            for v in list(welcomes):
                if v not in acks:
                    self._mark_gone(v, -1, fault=True)
                    welcomes.pop(v)
            if not welcomes:
                return None
            if all(m.get("ok") for m in acks.values() if m):
                return start
            # a nack means some survivor's round already passed start:
            # refresh our round knowledge and retry further out
            for v, m in acks.items():
                if v in welcomes:
                    welcomes[v]["round"] = max(
                        int(welcomes[v]["round"]), int(m.get("round", -1))
                    )
            slack *= 2
        return None

    # ------------------------------------------------------------------
    async def main(self):
        server = await asyncio.start_server(
            self._handle_conn, "127.0.0.1", 0
        )
        my_port = server.sockets[0].getsockname()[1]
        loop = asyncio.get_running_loop()
        # launch every kernel before joining: peers time liveness, not
        # first-use stalls
        t = time.monotonic()
        await loop.run_in_executor(self._pool, self._warmup)
        self.boot_s = {"setup": t - self._t0, "warmup": time.monotonic() - t}
        ck = None
        if self.rejoin:
            ck = await loop.run_in_executor(self._pool, self._restore_checkpoint)
        self.peers = await tp.rendezvous_register(
            self.rdv[0], self.rdv[1], self.wid, "127.0.0.1", my_port,
            timeout_s=float(self.spec.get("join_timeout_s", 30.0)),
        )
        now = time.monotonic()
        self.boot_s["registered"] = now - self._t0
        for v in range(self.K):
            if v == self.wid:
                continue
            self.mem.last_seen[v] = now
            try:
                r, w = await tp.open_with_retry(
                    *self.peers[v], attempts=10 if self.rejoin else 40
                )
                self.conns[v] = (r, w)
            except ConnectionError:
                if not self.rejoin:
                    raise
                # a fellow casualty: rejoin with whoever answers
                self._mark_gone(v, -1, fault=True)
        hb = asyncio.create_task(self._heartbeat_loop())
        start = 0
        if self.rejoin:
            start = await self._rejoin_handshake(my_port, ck is not None)
            if start is None:
                hb.cancel()
                server.close()
                self._write_results()
                return
            self.rejoined = True
        self.start_round = start
        t_start = time.monotonic()
        try:
            for rnd in range(start, self.rounds):
                await self._round(rnd)
                # checkpoint *before* the progress marker: any progress
                # the supervisor can see implies a durable checkpoint
                if self.ckpt_every and (rnd + 1) % self.ckpt_every == 0:
                    await loop.run_in_executor(
                        self._pool, self._save_checkpoint, rnd
                    )
                self._write_progress(rnd)
                if rnd % self.ev == 0 or rnd == self.rounds - 1:
                    accs = await loop.run_in_executor(
                        self._pool, self._eval_accs, self.params)
                    self.records.append({
                        "round": rnd,
                        "accs": [float(a) for a in accs],
                        "bytes_wire": float(self.wire_bytes),
                        "wall_s": time.monotonic() - t_start,
                        **{k: int(v) for k, v in self.counters.items()},
                    })
            self.completed = True
        finally:
            hb.cancel()
            bye = tp.encode_peer(self.wid, self.epoch)
            for v in self._live_peers():
                conn = self.conns.get(v)
                if conn is not None:
                    try:
                        await tp.write_frame(conn[1], tp.MSG_BYE, bye)
                    except OSError:
                        pass
            server.close()
        self._write_results()

    # ------------------------------------------------------------------
    def _write_progress(self, rnd: int):
        """Crash-consistent progress marker (the runner's kill trigger and
        liveness probe): temp + rename, like every result file here."""
        path = os.path.join(self.run_dir, f"w{self.wid}.progress")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(rnd))
        os.replace(tmp, path)

    def _save_npy(self, tag: str, arr: np.ndarray):
        fn = os.path.join(self.run_dir, f"worker_{self.wid}_{tag}.npy")
        tmp = fn + ".tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, fn)

    def _write_results(self):
        out = {
            "worker": self.wid,
            "rows": [int(self.lo), int(self.hi)],
            "n_params": int(self.P),
            "epoch": self.epoch,
            "history": self.records,
            "round_wall_s": self.round_wall,
            "round_phases_s": self.round_phases,
            "wire_bytes": float(self.wire_bytes),
            "counters": dict(self.counters),
            "detect_rounds": self.detect_rounds,
            "admit_rounds": self.admit_rounds,
            "reweight_row_err": self.reweight_row_err,
            "dead_peers": sorted(self.dead),
            "left_peers": sorted(self.left),
            "rejoined": self.rejoined,
            "start_round": int(self.start_round),
            "catchup_source": self.catchup_source,
            "completed": self.completed,
            "membership": self.mem.snapshot(),
            # where the worker ran, and its kernels' launches in the
            # rounds (warm-up apart)
            "device": str(self.device),
            "launches": {k: int(f.launches) for k, f in _kernel_wrappers().items()},
            "warmup_launches": self.warmup_launches,
            # seconds from the worker's construction: its set-up, its
            # warm-up, and its registration (the mesh's slowest peer)
            "boot_s": self.boot_s,
        }
        if self.dump_view:
            out["need_from"] = {
                str(v): [int(i) for i in ids]
                for v, ids in self.need_from.items()
            }
        atomic_write_json(
            os.path.join(self.run_dir, f"worker_{self.wid}.json"), out
        )
        self._save_npy("X", self.X_view[self.lo:self.hi].cpu().numpy())
        if self.dump_view:
            view = self.X_view.cpu().numpy()
            self._save_npy("view", view)
            self._save_npy("sent", self._last_sent if self._last_sent is not None
                           else view[self.lo:self.hi])


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        description="one row-block worker of the processes backend"
    )
    ap.add_argument("--spec", required=True, help="path to the run spec JSON")
    ap.add_argument("--worker", type=int, required=True)
    ap.add_argument("--epoch", type=int, default=0,
                    help="membership epoch (incarnation number)")
    ap.add_argument("--rejoin", action="store_true",
                    help="relaunch after a crash: restore + JOIN handshake")
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    worker = PeerWorker(spec, args.worker, epoch=args.epoch,
                        rejoin=args.rejoin)
    asyncio.run(worker.main())


if __name__ == "__main__":
    main()
