"""Node and runner (paper §2.2 *Node*): the skeleton that builds the other
modules and drives the DL loop of the paper's Fig. 2.  One node is one row
of the node-stacked state; :class:`DecentralizedRunner` is the thin
wrapper over :class:`repro_torch.core.engine.RoundEngine` that the
examples drive, with the JAX package's names.  With
``backend="processes"`` it runs the experiment as K worker processes
gossiping over localhost TCP instead (``repro_torch.runtime.ProcessRunner``),
rebuilt in each worker from a declarative ``workload``."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.engine import DLConfig, RoundEngine, build_graph, build_network  # noqa: F401
from repro_torch.optim import Optimizer


class DecentralizedRunner:
    """Thin wrapper over :class:`RoundEngine` (the simulated backend) or,
    for ``backend="processes"``, ``repro_torch.runtime.ProcessRunner``.

    loss_fn(params, batch_x, batch_y) -> scalar    (single node)
    acc_fn(params, batch_x, batch_y) -> scalar     (single node)
    heterogeneous_lrs: optional (N,) per-node learning-rate multipliers.
    device: as ``RoundEngine``'s (None: the card).
    workload: the process backend's declarative experiment
    (``runtime.build_workload``), which replaces the callables there;
    ``runner_kw`` go to ``ProcessRunner``.
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
        workload: Optional[Dict] = None,
        *,
        device=None,
        **runner_kw,
    ):
        self.dl = dl
        if dl.backend == "processes":
            # callables cannot cross the process boundary: each worker
            # rebuilds the experiment from the declarative workload
            if workload is None:
                raise ValueError(
                    "backend='processes' rebuilds the experiment inside "
                    "each worker process; pass workload={'dataset': ..., "
                    "'model': ..., 'lr': ...} instead of callables"
                )
            from repro_torch.runtime import ProcessRunner

            self.engine = ProcessRunner(dl, workload, device=device, **runner_kw)
        else:
            if runner_kw:
                raise TypeError(f"unknown arguments for the simulated backend: {sorted(runner_kw)}")
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
