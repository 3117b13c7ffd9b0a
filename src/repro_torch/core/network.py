"""Network emulation: the simulated wall-clock of a round.

    round_time(node) = compute_time
                     + sum_over_neighbors(message_bytes * 8 / goodput + latency)
    round_time       = max over nodes (synchronous rounds, stragglers bind)

Links are classified by the Mapping (same machine -> loopback, else
LAN/WAN).  Host math in numpy; :func:`node_round_times` also runs on
tensors, where the engine evaluates it on the device in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.topology import Graph


# edges per row up to which node_round_times sums them one by one
_SUM_IN_ORDER = 64


def node_round_times(A, lat, goodput, per_edge_bytes, compute_time,
                     parallel_sends: bool = False):
    """Per-node round time, on numpy arrays or tensors alike:

        t_edge  = latency + bytes * 8 / goodput          per live edge
        comm_i  = sum_j t_edge[i,j]   (serialized uplink sends)
                | max_j t_edge[i,j]   (parallel_sends: dedicated NICs)
        time_i  = compute_time_i + comm_i

    A: (N, E) {0,1} live-edge mask; lat/goodput: matching link matrices
    (dense (N, N) or neighbor-gathered (N, D)); per_edge_bytes: scalar;
    compute_time: scalar or (N,) seconds.
    """
    t_edge = lat + per_edge_bytes * 8.0 / goodput
    masked = A * t_edge
    if not parallel_sends and isinstance(masked, torch.Tensor) and masked.shape[1] <= _SUM_IN_ORDER:
        # a neighbour table's few slots summed in slot order, so the card
        # adds them as the CPU does (a reduction kernel may pair them up)
        comm = masked[:, 0]
        for k in range(1, masked.shape[1]):
            comm = comm + masked[:, k]
    elif not parallel_sends:
        comm = masked.sum(1)
    elif isinstance(masked, torch.Tensor):
        comm = masked.amax(1)
    else:
        comm = masked.max(axis=1)
    return compute_time + comm


def gathered_round_times(lat, goodput, rows, nbr, A, per_edge_bytes, compute_time,
                         parallel_sends: bool = False):
    """:func:`node_round_times` for a gathered row subset (the cohort
    path): ``rows`` (C,) global ids, ``nbr`` their (C, D) global neighbour
    ids; the link entries are gathered as ``lat[rows[:, None], nbr]``,
    elementwise the dense neighbour gather at those rows, so the result
    is the (C,)-row slice of the dense formula.  A: (C, D) {0,1} live
    edges; compute_time: (C,) seconds."""
    r = rows[:, None]
    return node_round_times(A, lat[r, nbr], goodput[r, nbr], per_edge_bytes, compute_time,
                            parallel_sends)


def straggler_compute_times(
    n: int,
    base_s: float,
    factor: float = 1.0,
    frac: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """(N,) float32 per-node compute times: a seeded ``frac`` of the nodes
    are stragglers at ``factor`` x the base time."""
    ct = np.full((n,), base_s, np.float32)
    k = int(round(frac * n))
    if k > 0 and factor != 1.0:
        idx = np.random.default_rng(seed).choice(n, size=k, replace=False)
        ct[idx] = base_s * factor
    return ct


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    bandwidth_bps: float    # payload bandwidth
    latency_s: float
    drop_rate: float = 0.0  # fraction; derates goodput ~1/(1-p)

    def __post_init__(self):
        if not 0.0 <= self.drop_rate < 1.0:
            raise ValueError(
                f"LinkSpec.drop_rate must be in [0, 1), got {self.drop_rate}: "
                "a drop rate of 1 means the link never delivers — remove the "
                "edge instead"
            )

    def goodput_bps(self) -> float:
        """Payload goodput after drop-rate derating (TCP retransmission)."""
        return self.bandwidth_bps * (1.0 - self.drop_rate)

    def transfer_time(self, nbytes: float) -> float:
        return self.latency_s + nbytes * 8.0 / self.goodput_bps()


LOOPBACK = LinkSpec(bandwidth_bps=20e9, latency_s=20e-6)
LAN = LinkSpec(bandwidth_bps=1e9, latency_s=200e-6)          # paper's cluster
WAN = LinkSpec(bandwidth_bps=100e6, latency_s=30e-3, drop_rate=0.001)


@dataclasses.dataclass
class Mapping:
    """Node -> machine assignment: round-robin over ``n_machines``."""

    n_nodes: int
    n_machines: int = 16

    def machine(self, node: int) -> int:
        return node % self.n_machines

    def same_machine(self, a: int, b: int) -> bool:
        return self.machine(a) == self.machine(b)


@dataclasses.dataclass
class NetworkModel:
    mapping: Mapping
    local: LinkSpec = LOOPBACK
    remote: LinkSpec = LAN
    # (N,) per-node local compute seconds; None means zero
    compute_time_s: Optional[np.ndarray] = None
    # per-round runtime overhead, added once in round_time()
    overhead_s: float = 0.0

    def link(self, a: int, b: int) -> LinkSpec:
        """The link between nodes ``a`` and ``b``: loopback on one machine."""
        return self.local if self.mapping.same_machine(a, b) else self.remote

    def matrices(self, dtype=np.float32):
        """(latency_s, goodput_bps) as (N, N) matrices over ordered pairs."""
        n = self.mapping.n_nodes
        machines = np.array([self.mapping.machine(i) for i in range(n)])
        same = machines[:, None] == machines[None, :]
        lat = np.where(same, self.local.latency_s, self.remote.latency_s)
        gp = np.where(same, self.local.goodput_bps(), self.remote.goodput_bps())
        return lat.astype(dtype), gp.astype(dtype)

    def node_times(
        self,
        graph: Graph,
        bytes_per_edge: float,
        compute_time_s: Union[float, np.ndarray, None] = None,
        parallel_sends: bool = False,
    ) -> np.ndarray:
        """(N,) per-node round times in float64 host arithmetic."""
        if compute_time_s is None:
            compute_time_s = (
                0.0 if self.compute_time_s is None
                else np.asarray(self.compute_time_s, np.float64)
            )
        lat, gp = self.matrices(dtype=np.float64)
        A = graph.adj.astype(np.float64)
        return node_round_times(
            A, lat, gp, float(bytes_per_edge), compute_time_s, parallel_sends
        )

    def round_time(
        self,
        graph: Graph,
        bytes_per_edge: float,
        compute_time_s: Union[float, np.ndarray, None] = None,
        parallel_sends: bool = False,
    ) -> float:
        """Synchronous-round wall-clock: the max of :meth:`node_times`."""
        return float(
            self.node_times(graph, bytes_per_edge, compute_time_s,
                            parallel_sends).max()
        ) + self.overhead_s

    def experiment_time(self, graph: Graph, bytes_per_edge: float,
                        compute_time_s, rounds: int) -> float:
        """``rounds`` synchronous rounds of :meth:`round_time` each."""
        return rounds * self.round_time(graph, bytes_per_edge, compute_time_s)


def paper_testbed(n_nodes: int) -> NetworkModel:
    """The paper's 16-machine LAN cluster."""
    return NetworkModel(Mapping(n_nodes, 16), LOOPBACK, LAN)


def wan_deployment(n_nodes: int) -> NetworkModel:
    """Geo-distributed deployment (every node its own machine, WAN links)."""
    return NetworkModel(Mapping(n_nodes, n_nodes), LOOPBACK, WAN)


#: the port's calibration record (``runtime.calibrate``): measured on the
#: port's workers, apart from the JAX package's ``results/calibration.json``
CALIBRATION_PATH = "results/torch_calibration.json"


def localhost_deployment(n_nodes: int) -> NetworkModel:
    """Every node on one machine, all links loopback: the modeled twin of
    the ``backend='processes'`` localhost runs, whose measured round walls
    ``runtime.calibrate`` holds against :meth:`NetworkModel.round_time`."""
    return NetworkModel(Mapping(n_nodes, 1), LOOPBACK, LOOPBACK)


def load_calibration_fit(path: str = CALIBRATION_PATH) -> Optional[dict]:
    """The ``fit`` block ``runtime.calibrate`` recorded (``alpha_s`` per-
    round constant, ``beta_s_per_byte`` residual slope), or None when no
    sweep has been run."""
    import json
    import os

    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f).get("fit")
    except (OSError, ValueError):
        return None


def calibrated_localhost(n_nodes: int, path: str = CALIBRATION_PATH) -> NetworkModel:
    """:func:`localhost_deployment` with the measured per-round overhead
    constant folded in (the plain model when no calibration file exists)."""
    fit = load_calibration_fit(path)
    model = localhost_deployment(n_nodes)
    if fit:
        model.overhead_s = float(fit.get("alpha_s", 0.0))
    return model
