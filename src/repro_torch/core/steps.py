"""Step layer: what one node-stacked round does.

``RoundSteps`` holds the static pieces of an experiment (loss, optimizer,
sharing strategy, per-node compute times, link matrices) and no mutable
state.  The caller threads the flat (N, P) parameter matrix X through
:meth:`RoundSteps.train_and_mix`.  Only full participation without fault
injection is ported; no ported strategy draws random numbers, so the
share step passes ``key=None``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.core.network import node_round_times
from repro_torch.core.topology import SparseTopology
from repro_torch.optim.optimizers import apply_updates_
from repro_torch.utils.pytree import tree_unvector


@dataclasses.dataclass(eq=False)
class RoundSteps:
    """The per-round step functions of the synchronous scheduler.

    compute_node: (N,) fp32 per-node local compute seconds.
    lat/goodput: (N, N) fp32 link matrices of the simulated network, or None.
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

    def local_train(self, params, opt_state, bx, by):
        """``bx.shape[0]`` SGD steps on every node at once: per-node
        gradients by ``vmap(grad(loss_fn))``.  ``params`` are views of the
        flat state and are updated in place."""
        node_grad = vmap(grad(self.loss_fn))
        for s in range(bx.shape[0]):
            grads = node_grad(params, bx[s], by[s])
            updates, opt_state = self.opt.update(grads, opt_state, params)
            apply_updates_(params, updates)
        return params, opt_state

    def round_time(self, Wm, nbytes: float, deg_eff: float):
        """Simulated synchronous round wall-clock, fp32 on the device: the
        max over nodes of ``network.node_round_times``.  For a
        SparseTopology the per-edge latency and goodput are gathered
        through the neighbor table."""
        dev = self.lat.device
        nb = torch.tensor(nbytes, dtype=torch.float32, device=dev)
        per_edge = nb / max(deg_eff, 1e-9) if deg_eff > 0 else torch.zeros_like(nb)
        if isinstance(Wm, SparseTopology):
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
        node_t = node_round_times(A, lat, gp, per_edge, self.compute_node,
                                  self.parallel_sends)
        return node_t.max()

    def train_and_mix(self, X, opt_state, share_state, bx, by, W, rnd: int = 0):
        """One round: local steps (in place on X), then the share/mix step.
        Returns ``(X', opt_state, share_state, nbytes, sim_t)``: the bytes
        each node sent as an fp32-rounded float, and the simulated round
        time as a 0-d device tensor."""
        params = tree_unvector(X, self.template)
        _, opt_state = self.local_train(params, opt_state, bx, by)
        deg = self.mean_degree
        X2, share_state, nbytes = self.sharing.round(
            X, W, share_state, key=None, degree=deg, rnd=rnd
        )
        nbytes = float(np.float32(nbytes))
        if self.lat is not None:
            sim_t = self.round_time(W, nbytes, deg)
        else:
            sim_t = torch.zeros((), dtype=torch.float32, device=X.device)
        return X2, opt_state, share_state, nbytes, sim_t
