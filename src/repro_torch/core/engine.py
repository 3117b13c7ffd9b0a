"""RoundEngine: the multi-round execution core of the DL emulator (the
paper's Fig. 2 node loop) on PyTorch.

N nodes live as one node-stacked state: a flat (N, P) fp32 parameter
matrix X whose rows are each node's ``tree_vector``, with the parameter
tree as views into it.  A round takes ``local_steps`` SGD steps on every
node at once (``vmap(grad(loss))``), then gossip-merges X through the
sharing strategy — for a sparse overlay, one launch of the fused
gather-merge kernel (``kernels/gossip_mix.py``).  The dataset lives on
the device and each round's batches are gathered there by index.

The port covers the three schedulers (synchronous, neighbourhood-barrier
clocks, event-driven async gossip with its population-scale cohort path)
on one device over static overlays and the dynamic one (a new random
d-regular graph every round, ``PeerSampler``); full and quantized full sharing, the sparsified
strategies (random-k with either sampler, TopK, CHOCO-SGD with either
compressor; payload wire on or off, int8 payload codec) and secure
aggregation (with the seed-recovery pass under churn); churn (per-round
participation masks, node- or machine-level) with every sharing strategy;
fault injection (``core/faults.py`` ``FaultPlan``: message loss, crash
windows, latency spikes, payload corruption with the rollback guard);
per-node learning-rate multipliers; checkpoints of the engine state
(``save_state``/``load_state``, in the JAX package's file format).
``backend="processes"`` (K worker processes gossiping over localhost TCP)
is ``repro_torch.runtime``'s; ``RoundEngine`` refuses it and points there.

Node sharding (``shard_devices=S``): the synchronous scheduler's node axis
is block-sharded over the S ranks of a ``torch.distributed`` group, one
process per rank (``launch/shard.py`` starts them; the JAX package runs
one ``shard_map`` program instead).  Each rank builds its own engine from
the same config and holds its B = N/S rows of the state; gossip crosses
ranks through the sharded mixing operands of ``core/mixing.py``
(``shard_backend``: all-gather, or slot-permutation point-to-point
exchanges of the rows that cross ranks), each merge one launch of the
port's merge kernel.  Every rank reports the single-device engine's
``history``, ``bytes_sent`` and ``sim_time_s``; :meth:`RoundEngine.full_state`
gathers the parameters.

Device and numerics: the engine runs on the card (``device=None`` means
``"cuda"``) and raises if there is none; pass ``device="cpu"`` to run on
the CPU.  On the card it turns TF32 off for cuDNN convolutions and for
matmuls (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` set False, process-wide), so the
card computes in full fp32 as the reference does.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch import prng
from repro_torch.core import faults as faults_lib
from repro_torch.core import sharing as sharing_lib
from repro_torch.core.network import (
    NetworkModel,
    paper_testbed,
    straggler_compute_times,
    wan_deployment,
)
from repro_torch.core.mixing import (
    NodeShard,
    ShardedDense,
    shard_topology,
)
from repro_torch.core.scheduler import make_scheduler
from repro_torch.core.secure import SecureAggregation
from repro_torch.core.steps import RoundSteps
from repro_torch.core.topology import Graph, PeerSampler, SparseTopology
from repro_torch.optim import Optimizer
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unvector, tree_vector

# cap on the (R, N, N) mixing-matrix stack one span of a dense dynamic
# topology stages; such spans shrink at large N (sparse stacks are exempt)
_W_STACK_BYTES_CAP = 64 * 1024 * 1024

# above this node count, circulant topologies build the sparse table
# directly instead of the dense (N, N) Graph (tables are bitwise equal)
_DENSE_GRAPH_MAX_N = 4096

# evaluation runs over groups of nodes sized so that one group's input
# activations stay near this many elements
_EVAL_ELEMS = 1 << 25


@dataclasses.dataclass
class DLConfig:
    """Experiment specification.  Field names and defaults are the JAX
    package's, so a config carries over; :meth:`validate` says which
    values this port runs."""

    n_nodes: int = 16
    backend: str = "simulated"  # simulated | processes
    topology: str = "regular"  # ring | regular | random-regular | fully | star | dynamic | file:<path>
    degree: int = 5
    sharing: str = "full"      # full | randomk | topk | choco | quant
    budget: float = 0.1
    choco_gamma: float = 0.3
    payload: str = "auto"      # auto | on | off
    payload_quant: bool = False
    randk_sampler: str = "uniform"  # uniform | strided
    secure: bool = False
    local_steps: int = 1
    batch_size: int = 8
    rounds: int = 100
    eval_every: int = 10
    seed: int = 0
    results_dir: Optional[str] = None
    # rounds per host sync of the metrics; 0 = the legacy per-round
    # dispatch (SyncScheduler.run_legacy_round)
    chunk_rounds: int = 8
    mixing: str = "auto"       # auto | sparse | dense
    semantics: str = "sync"    # sync | local | async
    async_gossip: str = "neighborhood"  # neighborhood | pairwise
    async_slice_s: float = 0.0
    cohort_capacity: int = 0
    selection: str = "auto"    # auto | flat | hier
    segment_size: int = 0
    cold_dtype: str = "fp32"   # fp32 | bf16 | int8
    batch_keying: str = "stream"  # stream | node
    shard_devices: int = 0
    shard_backend: str = "auto"  # auto | ppermute | gather
    participation: float = 1.0
    churn_machines: int = 0
    faults: Optional[faults_lib.FaultPlan] = None
    secure_recovery: bool = False
    network: str = "none"       # none | lan | wan
    compute_time_s: float = 0.0
    straggler_factor: float = 1.0
    straggler_frac: float = 0.0
    compute_spread: float = 0.0
    parallel_sends: bool = False

    def validate(self) -> "DLConfig":
        """Raise ``ValueError`` on the first violation of the JAX
        package's rules; return self."""
        def bad(msg):
            raise ValueError(f"invalid DLConfig: {msg}")

        if self.semantics not in ("sync", "local", "async"):
            bad(f"unknown semantics {self.semantics!r} (sync|local|async)")
        if self.backend not in ("simulated", "processes"):
            bad(f"unknown backend {self.backend!r} (simulated|processes)")
        # the real-network process backend, as the JAX package checks it
        if self.backend == "processes":
            if self.shard_devices > 0:
                bad("backend='processes' shards nodes over OS processes; "
                    "shard_devices is the simulated backend's device mesh — "
                    "drop one of the two")
            if self.semantics != "sync":
                bad(f"backend='processes' implements the synchronous round "
                    f"barrier only for now (got semantics={self.semantics!r});"
                    " use the simulated backend for local/async semantics")
            if self.secure:
                bad("backend='processes' does not run secure aggregation "
                    "over the socket transport yet; set secure=False or use "
                    "the simulated backend")
            if self.faults is not None:
                bad("FaultPlan injects faults into the *simulated* step; the "
                    "processes backend takes real faults (kill a worker, see "
                    "examples/processes.py) — drop the FaultPlan")
            if self.participation < 1.0 or self.churn_machines > 0:
                bad("simulated churn masks (participation/churn_machines) "
                    "don't apply to real processes; model churn by killing "
                    "workers instead")
            if self.cohort_capacity > 0 or self.batch_keying != "stream":
                bad("cohort_capacity/batch_keying='node' are async "
                    "population-scale knobs of the simulated backend")
            if self.topology in ("fully", "star") or self.mixing == "dense":
                bad("processes workers gossip over sparse neighbor tables; "
                    "fully|star topologies / mixing='dense' have no bounded "
                    "per-peer send set — use a sparse overlay")
            if self.topology == "dynamic":
                bad("backend='processes' needs a static graph to derive "
                    "its per-peer send/receive sets; topology='dynamic' "
                    "re-draws them every round")
            if self.sharing.lower() not in ("full", "randomk", "random"):
                bad(f"backend='processes' serializes sharing='full' rows or "
                    f"sharing='randomk' (idx, val) payloads on the wire; "
                    f"{self.sharing!r} is stateful/unsupported there — use "
                    "the simulated backend")
            if self.randk_sampler != "uniform":
                bad("backend='processes' wires the uniform randomk payload "
                    "only (strided phases are a simulated fast path)")

        # sharing-strategy knob compatibility, as the JAX package checks it
        sparsified = sharing_lib.strategy_takes_budget(self.sharing)
        if self.secure:
            if self.topology == "dynamic":
                bad("secure=True needs a static graph (the pairwise-mask "
                    "PRF schedule is per-edge); topology='dynamic' has none")
            crashes = self.faults is not None and bool(getattr(self.faults, "crashes", ()))
            if (
                self.participation < 1.0 or self.churn_machines > 0 or crashes
            ) and not self.secure_recovery:
                bad("secure=True under churn (participation < 1, "
                    "churn_machines > 0, or FaultPlan crash schedules) "
                    "needs secure_recovery=True: without the Bonawitz "
                    "seed-recovery pass a dropped node's pairwise masks "
                    "would not cancel")
            if self.payload == "on" or self.payload_quant or self.randk_sampler != "uniform":
                bad("payload/payload_quant/randk_sampler do not compose with "
                    "secure=True (masked messages are full fp32 vectors)")
        else:
            if self.payload == "on" and not sparsified:
                bad(f"payload='on' needs a sparsified sharing strategy "
                    f"(randomk/topk/choco), not {self.sharing!r}")
            if self.payload_quant and not sparsified:
                bad("payload_quant applies to payload-emitting strategies "
                    "(randomk/topk/choco); use sharing='quant' for quantized "
                    "full sharing")
            if self.randk_sampler != "uniform" and self.sharing.lower() not in (
                "randomk", "random"
            ):
                bad("randk_sampler applies to sharing='randomk' only")

        if not sharing_lib.is_full_sharing(self.sharing):
            sharing_lib.make_sharing(self.sharing)  # an unknown name raises

        if self.async_gossip not in ("neighborhood", "pairwise"):
            bad(f"unknown async_gossip {self.async_gossip!r} (neighborhood|pairwise)")
        if self.payload not in ("auto", "on", "off"):
            bad(f"unknown payload mode {self.payload!r} (auto|on|off)")
        if self.mixing not in ("auto", "sparse", "dense"):
            bad(f"unknown mixing mode {self.mixing!r} (auto|sparse|dense)")
        if self.shard_backend not in ("auto", "ppermute", "gather"):
            bad(f"unknown shard_backend {self.shard_backend!r} (auto|ppermute|gather)")
        if self.randk_sampler not in ("uniform", "strided"):
            bad(f"unknown randk_sampler {self.randk_sampler!r} (uniform|strided)")
        if not 0.0 < self.participation <= 1.0:
            bad(f"participation must be in (0, 1], got {self.participation}")
        if self.churn_machines < 0:
            bad("churn_machines must be >= 0")
        if not 0.0 <= self.straggler_frac <= 1.0:
            bad(f"straggler_frac must be in [0, 1], got {self.straggler_frac}")
        if self.straggler_factor <= 0:
            bad("straggler_factor must be > 0")
        if self.compute_time_s < 0 or self.async_slice_s < 0:
            bad("compute_time_s / async_slice_s must be >= 0")
        if (
            self.straggler_frac > 0
            and self.straggler_factor != 1.0
            and self.compute_time_s == 0
        ):
            bad("straggler_factor/straggler_frac scale compute_time_s, "
                "which is 0 — set a base compute_time_s")
        if self.compute_spread < 0:
            bad(f"compute_spread must be >= 0, got {self.compute_spread}")
        if self.compute_spread > 0 and self.compute_time_s == 0:
            bad("compute_spread scales compute_time_s, which is 0 — set a "
                "base compute_time_s")
        if self.secure_recovery and not self.secure:
            bad("secure_recovery=True is the seed-recovery pass of secure "
                "aggregation; it needs secure=True")
        if self.faults is not None:
            self.faults.validate()
            for node, _, _ in self.faults.crashes:
                if node >= self.n_nodes:
                    bad(f"FaultPlan crash node {node} out of range for "
                        f"n_nodes={self.n_nodes}")
            if self.chunk_rounds <= 0:
                bad("faults need chunk_rounds > 0 (the JAX package runs "
                    "them on its scanned chunk path only)")
            if self.shard_devices > 0:
                bad("faults are single-host for now (per-edge draws and "
                    "the rollback guard are not distributed); drop "
                    "shard_devices or the FaultPlan")
            if self.cohort_capacity > 0:
                bad("faults do not compose with cohort_capacity (the cohort "
                    "gather/scatter step has no fault hooks); use the dense "
                    "async path")
            if self.secure and self.faults.msg_loss > 0:
                bad("secure=True with FaultPlan.msg_loss > 0 is not "
                    "modeled: per-edge loss would need per-edge mask "
                    "recovery (secure_recovery covers node-level churn "
                    "and crashes; latency spikes and corruption compose)")
        # multi-device constraints, as the JAX package checks them
        if self.shard_devices > 0:
            if self.chunk_rounds <= 0:
                bad("shard_devices requires the chunked path (chunk_rounds > 0); "
                    "the JAX package's legacy per-round dispatch is single-device only")
            if self.n_nodes % self.shard_devices:
                bad(f"n_nodes={self.n_nodes} must divide evenly over "
                    f"shard_devices={self.shard_devices}")
        # execution semantics, as the JAX package checks them
        if self.semantics != "sync":
            if self.chunk_rounds <= 0:
                bad(f"semantics={self.semantics!r} runs on the chunked path only "
                    "(chunk_rounds > 0)")
            if self.shard_devices > 0:
                bad(f"semantics={self.semantics!r} is single-host for now "
                    "(the virtual clock is not yet distributed); use "
                    "semantics='sync' with shard_devices")
        if self.semantics == "async":
            if self.secure:
                bad("semantics='async' rejects secure=True (pairwise masks "
                    "assume all co-neighbors mix in the same round)")
            if not sharing_lib.is_full_sharing(self.sharing):
                bad("semantics='async' models one-sided stale reads for "
                    f"sharing='full' only (got {self.sharing!r})")
            if self.async_gossip == "pairwise" and (
                self.mixing == "dense" or self.topology in ("fully", "star")
            ):
                bad("async_gossip='pairwise' samples partners from sparse "
                    "neighbor tables; use async_gossip='neighborhood' for "
                    "dense mixing / fully|star topologies")
        # population-scale cohort activation
        if self.batch_keying not in ("stream", "node"):
            bad(f"unknown batch_keying {self.batch_keying!r} (stream|node)")
        if self.batch_keying == "node":
            if self.chunk_rounds <= 0:
                bad("batch_keying='node' derives indices on the chunked path "
                    "(chunk_rounds > 0)")
            if self.shard_devices > 0:
                bad("batch_keying='node' is single-host for now; the sharded "
                    "span stages 'stream' batches per rank")
        if self.cohort_capacity < 0:
            bad(f"cohort_capacity must be >= 0, got {self.cohort_capacity}")
        if self.cohort_capacity > 0:
            if self.semantics != "async":
                bad("cohort_capacity is the async cohort gather/scatter "
                    f"path; set semantics='async' (got {self.semantics!r})")
            if self.cohort_capacity > self.n_nodes:
                bad(f"cohort_capacity={self.cohort_capacity} exceeds "
                    f"n_nodes={self.n_nodes}")
            if self.mixing == "dense" or self.topology in ("fully", "star"):
                bad("cohort_capacity gathers neighbor rows from sparse "
                    "(N, D) tables; dense mixing / fully|star topologies "
                    "have no bounded neighbor set to gather")
            if self.batch_keying != "node":
                bad("cohort_capacity requires batch_keying='node' (host "
                    "staging of (R, L, N, B) indices is O(N·B) per step)")
        if self.selection not in ("auto", "flat", "hier"):
            bad(f"unknown selection {self.selection!r} (auto|flat|hier)")
        if self.segment_size < 0:
            bad(f"segment_size must be >= 0, got {self.segment_size}")
        if self.cold_dtype not in ("fp32", "bf16", "int8"):
            bad(f"unknown cold_dtype {self.cold_dtype!r} (fp32|bf16|int8)")
        if self.cohort_capacity == 0:
            if self.selection == "hier" or self.segment_size > 0:
                bad("selection='hier'/segment_size tune the cohort selection "
                    "layer; set cohort_capacity > 0")
            if self.cold_dtype != "fp32":
                bad("cold_dtype compresses the cohort path's cold population "
                    "state; set cohort_capacity > 0")
        return self


def build_graph(cfg: DLConfig) -> Optional[Graph]:
    t = cfg.topology
    if t == "ring":
        return Graph.ring(cfg.n_nodes)
    if t == "regular":
        return Graph.regular_circulant(cfg.n_nodes, cfg.degree)
    if t == "random-regular":
        return Graph.random_regular(cfg.n_nodes, cfg.degree, cfg.seed)
    if t == "fully":
        return Graph.fully_connected(cfg.n_nodes)
    if t == "star":
        return Graph.star(cfg.n_nodes)
    if t == "dynamic":
        return None  # a new graph every round (PeerSampler)
    if t.startswith("file:"):
        return Graph.from_edge_list(t[5:], cfg.n_nodes)
    raise ValueError(f"unknown topology {t!r}")


def make_strategy(dl: DLConfig):
    """The sharing strategy of a config, with the JAX engine's kwargs."""
    kw = {"gamma": dl.choco_gamma} if dl.sharing.startswith("choco") else {}
    if sharing_lib.strategy_takes_budget(dl.sharing):
        kw["budget"] = dl.budget
        kw["payload"] = dl.payload != "off"
        if dl.payload_quant:
            kw["quantize"] = "int8"
        if dl.sharing.lower() in ("randomk", "random"):
            kw["sampler"] = dl.randk_sampler
    return sharing_lib.make_sharing(dl.sharing, **kw)


def compute_time_vector(cfg: DLConfig) -> np.ndarray:
    """The per-node (N,) compute-time vector of a config, with the
    straggler draw's seed offset of the JAX package."""
    ct = straggler_compute_times(
        cfg.n_nodes, cfg.compute_time_s, cfg.straggler_factor,
        cfg.straggler_frac, seed=cfg.seed + 31,
    )
    if cfg.compute_spread > 0:
        rng = np.random.default_rng(cfg.seed + 47)
        ct = (ct * (1.0 + cfg.compute_spread
                    * rng.random(cfg.n_nodes, dtype=np.float32))
              ).astype(np.float32)
    return ct


def build_network(cfg: DLConfig) -> Optional[NetworkModel]:
    if cfg.network in (None, "", "none"):
        return None
    if cfg.network == "lan":
        net = paper_testbed(cfg.n_nodes)
    elif cfg.network == "wan":
        net = wan_deployment(cfg.n_nodes)
    else:
        raise ValueError(f"unknown network model {cfg.network!r} (none|lan|wan)")
    net.compute_time_s = compute_time_vector(cfg)
    return net


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Asking for CUDA where there is none raises
    instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


class RoundEngine:
    """Emulates N DL nodes with node-stacked state.

    init_params_fn(generator) -> params tree on the generator's device;
    node i draws from its own ``torch.Generator`` seeded from
    ``(dl.seed, i)``.  ``init_params`` (a node-stacked tree, as
    ``convert.params_from_jax`` returns) replaces those draws.
    loss_fn(params, batch_x, batch_y) -> scalar    (single node)
    acc_fn(params, batch_x, batch_y) -> scalar     (single node)
    heterogeneous_lrs: optional (N,) per-node learning-rate multipliers
    applied to each node's optimizer updates.
    With ``dl.shard_devices=S`` the node axis is sharded over the S ranks
    of the default ``torch.distributed`` group: this rank holds rows
    [rank·B, (rank+1)·B), B = N/S, of ``X``, the optimizer state and the
    sharing state.
    """

    def __init__(
        self,
        dl: DLConfig,
        init_params_fn: Callable[[torch.Generator], Any],
        loss_fn: Callable,
        acc_fn: Callable,
        optimizer: Optimizer,
        batcher,
        heterogeneous_lrs: Optional[np.ndarray] = None,
        *,
        init_params: Optional[Dict] = None,
        device=None,
    ):
        dl.validate()
        if dl.backend == "processes":
            raise ValueError(
                "RoundEngine is the simulated backend; backend='processes' "
                "runs K real OS processes — construct "
                "repro_torch.runtime.ProcessRunner(dl, workload) directly, or "
                "pass workload= to DecentralizedRunner and it will dispatch"
            )
        self.device = dev = resolve_device(device)
        if dev.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.dl = dl
        self.loss_fn = loss_fn
        self.acc_fn = acc_fn
        self.opt = optimizer
        self.batcher = batcher
        n = dl.n_nodes
        self.shard: Optional[NodeShard] = None
        if dl.shard_devices > 0:
            self.shard = NodeShard.of_group(n)
            if self.shard.ndev != dl.shard_devices:
                raise ValueError(f"shard_devices={dl.shard_devices} but the process group "
                                 f"has {self.shard.ndev} ranks")
        self.lr_scales = None
        if heterogeneous_lrs is not None:
            lrs = np.asarray(heterogeneous_lrs, np.float32)
            if lrs.shape != (n,):
                raise ValueError(f"heterogeneous_lrs must be (n_nodes,) = ({n},), got {lrs.shape}")
            self.lr_scales = torch.as_tensor(lrs, device=dev)
        self.X = self._init_state(init_params_fn, init_params)
        self.opt_state = self.opt.init(self.params)
        self.n_params = int(self.X.shape[1])
        # secure aggregation keys its masks by the graph's neighbour table,
        # so it always builds the graph
        circulant_direct = (
            dl.topology in ("ring", "regular")
            and n > _DENSE_GRAPH_MAX_N
            and not dl.secure
            and dl.mixing != "dense"
        )
        self.graph = None if circulant_direct else build_graph(dl)
        self.sampler = (PeerSampler(n, dl.degree, dl.seed) if dl.topology == "dynamic"
                        else None)
        if dl.secure:
            self.sharing = SecureAggregation(self.graph.adj, recovery=dl.secure_recovery)
        else:
            self.sharing = make_strategy(dl)
        self.share_state = self.sharing.init_state(self.X)
        self.wire_dtype = self.sharing.wire_dtype(self.X.dtype)
        self.share_stage_bytes = int(self.sharing.stage_bytes_per_round(n, self.n_params))
        self.mix_mode = self._resolve_mix_mode()
        if self.mix_mode != "sparse":
            if dl.semantics == "async" and dl.async_gossip == "pairwise":
                raise ValueError("async_gossip='pairwise' needs sparse neighbor tables; this "
                                 "topology resolved to dense mixing — use "
                                 "async_gossip='neighborhood'")
            if dl.cohort_capacity > 0:
                raise ValueError("cohort_capacity gathers neighbor rows from sparse (N, D) "
                                 "tables; this topology resolved to dense mixing")
        self._shard_backend = self._resolve_shard_backend() if self.shard else None
        # peak host->device bytes of the mixing topology: staged once for a
        # static overlay, per span for the dynamic one (scheduler)
        self.topo_stage_bytes_peak = 0
        live_edges = None
        if self.sampler is not None:
            self._mix_static = None
            self._mean_degree = float(dl.degree)  # the sampler is d-regular
        elif self.graph is not None:
            self._mean_degree = float(self.graph.degrees().mean())
            if self.mix_mode == "sparse":
                st = SparseTopology.from_graph(self.graph)
            else:
                W_np = self.graph.metropolis_hastings().astype(np.float32)
                if self.shard is None:
                    self._mix_static = torch.as_tensor(W_np, device=dev)
                else:  # this rank's rows of W
                    self._mix_static = ShardedDense(
                        torch.as_tensor(self.shard.local(W_np), device=dev), self.shard)
                self.topo_stage_bytes_peak = int(W_np.nbytes)
                live_edges = (None, W_np * (1.0 - np.eye(n, dtype=np.float32)) > 0)
        else:
            if self._shard_backend == "ppermute":
                raise ValueError(
                    "shard_backend='ppermute' builds its slot schedule from the dense "
                    f"graph, capped at n_nodes={_DENSE_GRAPH_MAX_N}; use "
                    "shard_backend='gather' at population scale")
            deg = 2 if dl.topology == "ring" else dl.degree
            st = SparseTopology.regular_circulant(n, deg)
            self._mean_degree = float(st.dmax)
        if self.mix_mode == "sparse" and self.sampler is None:
            if self.shard is None:
                self._mix_static = st.to(dev)
            else:  # ppermute exchanges by the slot-rebalanced table's schedule
                self._mix_static = shard_topology(st, self.shard, dev, self._shard_backend)
            self.topo_stage_bytes_peak = st.stage_bytes()
            live_edges = (st.nbr, st.w > 0)
        self.network_model = build_network(dl)
        if self.network_model is not None:
            lat, gp = self.network_model.matrices()
            self._lat = torch.as_tensor(lat, device=dev)
            self._goodput = torch.as_tensor(gp, device=dev)
            compute_node = self.network_model.compute_time_s
        else:
            self._lat = self._goodput = None
            compute_node = compute_time_vector(dl)
        self._compute_node = torch.as_tensor(compute_node, device=dev)
        self._dev_x = torch.as_tensor(batcher.x, device=dev)
        self._dev_y = torch.as_tensor(batcher.y, device=dev).long()
        base_key = prng.key(dl.seed + 17)
        if dl.batch_keying == "node":
            # per-(round, node) keyed sampling from device partition tables;
            # the batch key is folded off the engine key, apart from the
            # sharing and gossip draws
            self._dev_lens, self._dev_parts_pad = batcher.device_tables(dev)
            self._batch_key = prng.fold_in(base_key, 0x0BA7)
        else:
            self._dev_lens = self._dev_parts_pad = self._batch_key = None
        if dl.chunk_rounds <= 0:  # the legacy per-round dispatch
            self.chunk = 0
        elif self.sampler is not None and self.mix_mode == "dense":
            # the dense dynamic overlay stages an (R, N, N) W stack a span
            self.chunk = max(1, min(dl.chunk_rounds, _W_STACK_BYTES_CAP // (4 * n * n)))
        else:
            self.chunk = dl.chunk_rounds
        self.steps = RoundSteps(
            loss_fn=loss_fn,
            opt=optimizer,
            sharing=self.sharing,
            template=self.template,
            mean_degree=self._mean_degree,
            compute_node=self._compute_node,
            parallel_sends=dl.parallel_sends,
            lat=self._lat,
            goodput=self._goodput,
            base_key=base_key,
            live_edges=live_edges,
            lr_scales=self.lr_scales,
            faults=dl.faults,
            fault_key=(faults_lib.fault_key(dl.faults, dl.seed)
                       if dl.faults is not None else None),
        )
        self.scheduler = make_scheduler(self)
        self.history: List[Dict] = []
        self.bytes_sent = 0.0
        self.sim_time_s = 0.0
        # the round run() starts from: load_state() moves it to the
        # checkpointed round
        self._start_round = 0
        self.rounds_done = 0

    def _init_state(self, init_params_fn, init_params) -> torch.Tensor:
        """The flat (N, P) fp32 state (this rank's (B, P) rows when
        sharded: the same draws as the single-device engine's for those
        nodes) and the single-node template tree."""
        dev = self.device
        lo, n = 0, self.dl.n_nodes
        if self.shard is not None:
            lo, n = self.shard.rank * self.shard.block, self.shard.block
        if init_params is not None:
            stacked = tree_map(lambda a: torch.as_tensor(a, device=dev), init_params)
            self.template = tree_map(lambda a: a[0].clone(), stacked)
            return torch.cat([l[lo:lo + n].reshape(n, -1).float()
                              for l in tree_leaves(stacked)], 1)
        X = None
        for i in range(n):
            gen = torch.Generator(device=dev).manual_seed(self.dl.seed * 1_000_003 + lo + i)
            p = init_params_fn(gen)
            if X is None:
                self.template = p
                X = torch.empty((n, sum(l.numel() for l in tree_leaves(p))), device=dev)
            X[i].copy_(tree_vector(p))
        return X

    @property
    def params(self) -> Dict:
        """Node-stacked parameter tree: views of the flat state X (decoded
        from the async cohort path's compressed rows, where X is None)."""
        if self.X is None:
            return self.scheduler.eval_params()
        return tree_unvector(self.X, self.template)

    def _resolve_shard_backend(self) -> str:
        """The sharded gossip's transport: 'ppermute' slot-rebalances the
        static neighbour table and moves only the rows that cross ranks
        (O(D·B·P) bytes); 'gather' all-gathers the node axis (any table,
        the dynamic overlay's per-round ones included).  'auto' takes
        ppermute where the group moves device memory directly (nccl over
        several cards) and gather otherwise: the JAX package's rule, which
        takes ppermute on the TPU's interconnect and gather where its
        collectives are emulated on the host."""
        b = self.dl.shard_backend
        static_sparse = self.sampler is None and self.mix_mode == "sparse"
        if b == "ppermute":
            if not static_sparse:
                raise ValueError(
                    "shard_backend='ppermute' needs a static sparse topology (dynamic "
                    "tables have no static schedule; dense mixing all-gathers by "
                    "construction)")
            return b
        if b == "auto" and static_sparse and self.shard.backend == "nccl":
            return "ppermute"
        return "gather"

    def _resolve_mix_mode(self) -> str:
        """'sparse' (neighbor-indexed O(N·d·P) gossip) for sparse overlays,
        'dense' (W @ X) where the graph is effectively complete."""
        m = self.dl.mixing
        if m != "auto":
            return m
        if self.dl.topology in ("fully", "star"):
            return "dense"
        if self.graph is not None and int(self.graph.degrees().max()) >= self.dl.n_nodes - 1:
            return "dense"
        return "sparse"

    @torch.no_grad()
    def _eval(self, tx, ty) -> np.ndarray:
        """(N,) per-node accuracy on the test batch, over groups of nodes
        (sharded: this rank's rows, then all-gathered)."""
        group = max(1, _EVAL_ELEMS // max(tx.numel(), 1))
        node_acc = vmap(lambda p: self.acc_fn(p, tx, ty))
        params = self.scheduler.eval_params()
        rows = tree_leaves(params)[0].shape[0]
        accs = torch.cat([
            node_acc(tree_map(lambda a: a[i:i + group], params))
            for i in range(0, rows, group)
        ]).float()
        if self.shard is not None:
            accs = self.shard.gather(accs)
        return accs.cpu().numpy()

    def _lead(self) -> bool:
        """Whether this process prints and writes results: always, except
        on the ranks other than 0 of a sharded run."""
        return self.shard is None or self.shard.rank == 0

    def full_state(self, tree=None):
        """The global node-stacked form of ``tree`` (default: the flat
        state X), each node-stacked leaf all-gathered over the ranks of a
        sharded run; the tree itself otherwise.  A collective: every rank
        calls it."""
        tree = self.X if tree is None else tree
        if self.shard is None:
            return tree
        return tree_map(self.shard.gather, tree)

    def _record(self, rnd: int, tx, ty, t0: float, log: bool):
        accs = self._eval(tx, ty)
        rec = {
            "round": rnd,
            "acc_mean": float(accs.mean()),
            "acc_std": float(accs.std()),
            "bytes_per_node": self.bytes_sent,
            "wall_s": time.time() - t0,
            "sim_time_s": self.sim_time_s,
            "wire_dtype": self.wire_dtype,
        }
        rec.update(self.scheduler.extra_metrics())
        self.history.append(rec)
        if log and self._lead():
            print(
                f"[{self.dl.topology}/{type(self.sharing).__name__}] round {rnd:4d} "
                f"acc {rec['acc_mean']:.4f}±{rec['acc_std']:.4f} "
                f"MB/node {self.bytes_sent / 1e6:.1f}"
                + (f" sim {self.sim_time_s:.1f}s" if self.network_model else "")
            )

    def run(self, rounds: Optional[int] = None, log: bool = True) -> List[Dict]:
        """Execute ``rounds`` scheduler steps (rounds, or event cohorts
        under ``semantics="async"``) with an eval every ``eval_every``
        steps and after the last: spans of ``chunk`` rounds, or with
        ``chunk == 0`` the legacy per-round dispatch, one
        ``scheduler.run_legacy_round`` a round."""
        dl = self.dl
        rounds = rounds if rounds is not None else dl.rounds
        tx, ty = self.batcher.test_batch()
        tx = torch.as_tensor(tx, device=self.device)
        ty = torch.as_tensor(ty, device=self.device).long()
        ev = max(dl.eval_every, 1)
        t0 = time.time()
        if self.chunk == 0:  # legacy per-round dispatch (sync only)
            for rnd in range(self._start_round, rounds):
                self.scheduler.run_legacy_round(rnd)
                if rnd % ev == 0 or rnd == rounds - 1:
                    self._record(rnd, tx, ty, t0, log)
        else:
            rnd = self._start_round
            while rnd < rounds:
                nxt = -(-rnd // ev) * ev  # next eval round >= rnd
                if nxt >= rounds:
                    nxt = rounds - 1
                end = nxt + 1
                while rnd < end:
                    r = min(self.chunk, end - rnd)
                    self.scheduler.run_span(rnd, r)
                    rnd += r
                self._record(nxt, tx, ty, t0, log)
        self.rounds_done = max(rounds, self._start_round)
        self._dump_results()
        return self.history

    # Batches are keyed by the absolute round and sharing draws by
    # fold_in(base_key, round), so restoring (params, opt_state,
    # share_state) and the round cursor continues the uninterrupted run.
    def save_state(self, path: str, step: Optional[int] = None) -> str:
        """Checkpoint the node-stacked engine state and the round cursor
        into the directory ``path`` (``checkpoint.save_checkpoint``'s
        format, the JAX package's).  Returns the checkpoint file."""
        from repro_torch.checkpoint import save_checkpoint

        if self.dl.semantics != "sync":
            raise ValueError(
                "save_state captures the synchronous barrier state only; "
                "the local/async virtual clocks are not checkpointed yet"
            )
        self._check_flat_state()
        step = self.rounds_done if step is None else step
        # sharded: the global state, as the JAX package saves its sharded
        # arrays; rank 0 writes it and the others wait for the file
        trees = {"params": tree_unvector(self.full_state(), self.template),
                 "opt_state": self.full_state(self.opt_state),
                 "share_state": self.full_state(self.share_state)}
        if self._lead():
            save_checkpoint(path, step, **trees)
        if self.shard is not None:
            import torch.distributed as dist

            dist.barrier()
        return os.path.join(path, f"ckpt_{step:08d}.npz")

    def load_state(self, path: str, step: Optional[int] = None) -> int:
        """Restore a checkpoint of either package (the latest in ``path``
        unless ``step`` names one) and set ``run()`` to continue from its
        round.  Returns the step."""
        from repro_torch.checkpoint import load_checkpoint, restore_tree

        def local(t):  # this rank's rows of a global tree (None: no leaves)
            return t if self.shard is None or t is None else tree_map(self.shard.local, t)

        self._check_flat_state()
        step, trees = load_checkpoint(path, step)
        params = restore_tree(self.params, local(trees.get("params")))
        n = self.X.shape[0]
        self.X = torch.cat([l.reshape(n, -1).to(torch.float32) for l in tree_leaves(params)], 1)
        self.opt_state = restore_tree(self.opt_state, local(trees.get("opt_state")))
        self.share_state = restore_tree(self.share_state, local(trees.get("share_state")))
        self._start_round = self.rounds_done = int(step)
        return int(step)

    def _check_flat_state(self):
        if self.X is None:
            raise NotImplementedError(
                "checkpoints of bf16/int8 cold rows (cold_dtype != 'fp32') are not ported")

    def _dump_results(self):
        """Per-run JSON results: the config and the history."""
        if not self.dl.results_dir or not self._lead():
            return
        os.makedirs(self.dl.results_dir, exist_ok=True)
        with open(os.path.join(self.dl.results_dir, "results.json"), "w") as f:
            json.dump({"config": dataclasses.asdict(self.dl), "history": self.history}, f, indent=1)
