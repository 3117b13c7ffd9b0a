"""Real-network execution backend (``DLConfig.backend="processes"``).

The simulated engine emulates N nodes inside one process on a virtual
clock; this package runs the same experiment as K real OS processes
gossiping over real TCP sockets on real clocks — the paper's *emulation*
claim made measurable.  On the card the K workers share the one device,
each with its own CUDA context, and run the simulator's merge kernels on
their row blocks.

* ``transport``  — length-prefixed frame protocol carrying the payload
  wire format (full fp32 rows, or (idx, val) payloads with optional
  int8 + scale header), the JOIN/WELCOME/STATE rejoin control plane,
  plus the rendezvous registry protocol; byte for byte the JAX
  package's frames.  Every frame is stamped with the sender's
  membership epoch.
* ``membership`` — one worker's epoch-stamped view of the mesh: the
  failure detector's bookkeeping, zombie-frame rejection, and the
  two-phase rejoin admission state machine (socket-free, tested in
  isolation).
* ``peer``       — one worker process owning a contiguous row-block of
  nodes: asyncio gossip with heartbeat failure detection, send retry
  with the shared exponential-backoff policy, graceful degradation
  (dead peers' edges reweighted via ``sharing.edge_reweight_sparse`` so
  surviving rows stay row-stochastic), and crash-rejoin: checkpoint or
  donor-STATE catch-up plus pristine edge-weight restoration on
  re-admission (``sharing.edge_readmit_sparse``).
* ``runner``     — ``ProcessRunner``: spawns/monitors/kills workers,
  hosts the rendezvous, supervises crash-relaunch (``chaos_plan``,
  ``supervise=True``), merges per-worker results into an engine-shaped
  history, and checks the detection/rejoin conservation invariant.
* ``calibrate``  — measured per-round wall-clock vs ``NetworkModel``
  predictions over an (N, K, payload) sweep, with a fitted per-round
  overhead constant recorded into ``results/torch_calibration.json``.
"""
from repro_torch.runtime.membership import (  # noqa: F401
    Membership,
    RUNTIME_COUNTER_KEYS,
    zero_counters,
)
from repro_torch.runtime.runner import ProcessRunner, build_workload  # noqa: F401
