"""Node and runner (paper §2.2 *Node*): the skeleton that builds the other
modules and drives the DL loop of the paper's Fig. 2.  One node is one row
of the node-stacked state; :class:`DecentralizedRunner` is the thin
wrapper over :class:`repro_torch.core.engine.RoundEngine` that the
examples drive, with the JAX package's names.  The process backend
(``backend="processes"``, one OS process per node) is not ported."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.engine import DLConfig, RoundEngine, build_graph, build_network  # noqa: F401
from repro_torch.optim import Optimizer


class DecentralizedRunner:
    """Thin wrapper over :class:`RoundEngine` (the simulated backend).

    loss_fn(params, batch_x, batch_y) -> scalar    (single node)
    acc_fn(params, batch_x, batch_y) -> scalar     (single node)
    heterogeneous_lrs: optional (N,) per-node learning-rate multipliers.
    device: as ``RoundEngine``'s (None: the card).
    """

    def __init__(
        self,
        dl: DLConfig,
        init_params_fn: Optional[Callable] = None,
        loss_fn: Optional[Callable] = None,
        acc_fn: Optional[Callable] = None,
        optimizer: Optional[Optimizer] = None,
        batcher=None,
        heterogeneous_lrs: Optional[np.ndarray] = None,
        *,
        device=None,
    ):
        if dl.backend == "processes":
            raise NotImplementedError(
                "backend='processes' is not ported yet (ROADMAP Queue 1 item 7)")
        self.dl = dl
        self.engine = RoundEngine(dl, init_params_fn, loss_fn, acc_fn, optimizer, batcher,
                                  heterogeneous_lrs, device=device)

    def run(self, rounds: Optional[int] = None, log: bool = True) -> List[Dict]:
        return self.engine.run(rounds, log)

    # state and metrics live on the engine; the JAX package's surface
    @property
    def params(self):
        return self.engine.params

    @property
    def opt_state(self):
        return self.engine.opt_state

    @property
    def share_state(self):
        return self.engine.share_state

    @property
    def history(self) -> List[Dict]:
        return self.engine.history

    @property
    def bytes_sent(self) -> float:
        return self.engine.bytes_sent

    @property
    def sim_time_s(self) -> float:
        return self.engine.sim_time_s

    @property
    def sharing(self):
        return self.engine.sharing

    @property
    def graph(self):
        return self.engine.graph

    @property
    def template(self):
        return self.engine.template

    @property
    def n_params(self) -> int:
        return self.engine.n_params
