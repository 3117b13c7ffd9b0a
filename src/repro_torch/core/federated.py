"""Specialized nodes (paper Fig. 1): an FL server built from the same
modules; the node role is who aggregates.

:class:`FederatedRunner` is FedAvg: the server broadcasts one global
model, a client subset trains locally from it, and the server averages
the returned models.  Client selection and batches are numpy draws,
bitwise the JAX package's; the clients train at once, by
``vmap(grad(loss))`` over the selected clients' stacked copies.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.core.engine import resolve_device
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import apply_updates_
from repro_torch.utils.pytree import tree_map


@dataclasses.dataclass
class FLConfig:
    n_clients: int = 16
    clients_per_round: int = 8
    local_steps: int = 1
    rounds: int = 100
    eval_every: int = 10
    seed: int = 0


class FederatedRunner:
    """FedAvg over ``fl.n_clients`` clients.

    init_params_fn(generator) -> the global model's params tree, drawn
    from a ``torch.Generator`` seeded with ``fl.seed``; ``init_params`` (a
    single-model tree) replaces that draw.  loss_fn / acc_fn as
    ``RoundEngine``'s (single node).  device: None means the card, as for
    ``RoundEngine``; pass ``"cpu"`` to run on the CPU.
    """

    def __init__(self, fl: FLConfig, init_params_fn: Optional[Callable], loss_fn: Callable,
                 acc_fn: Callable, optimizer: Optimizer, batcher, *,
                 init_params: Optional[Dict] = None, device=None):
        self.device = dev = resolve_device(device)
        if dev.type == "cuda":  # full fp32, as RoundEngine computes
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.fl = fl
        self.loss_fn, self.acc_fn, self.opt = loss_fn, acc_fn, optimizer
        self.batcher = batcher
        if init_params is None:
            self.params = init_params_fn(torch.Generator(device=dev).manual_seed(fl.seed))
        else:
            self.params = tree_map(lambda a: torch.as_tensor(a, device=dev), init_params)
        self.history: List[dict] = []

    def _round(self, bx, by) -> None:
        """Broadcast, local training of the M selected clients (bx: (M, L,
        B, ...)), each with a fresh optimizer state, and the fp32 average
        of their models."""
        m = bx.shape[0]
        clients = tree_map(lambda a: a.expand((m,) + a.shape).clone(), self.params)
        state = self.opt.init(clients)
        node_grad = vmap(grad(self.loss_fn))
        for s in range(bx.shape[1]):
            grads = node_grad(clients, bx[:, s], by[:, s])
            updates, state = self.opt.update(grads, state, clients)
            apply_updates_(clients, updates)
        self.params = tree_map(lambda a: a.to(torch.float32).mean(0).to(a.dtype), clients)

    def run(self, rounds: Optional[int] = None, log: bool = True) -> List[dict]:
        fl = self.fl
        rounds = rounds if rounds is not None else fl.rounds
        tx, ty = self.batcher.test_batch()
        tx = torch.as_tensor(tx, device=self.device)
        ty = torch.as_tensor(ty, device=self.device).long()
        rng = np.random.default_rng(fl.seed)
        for rnd in range(rounds):
            sel = rng.choice(fl.n_clients, fl.clients_per_round, replace=False)
            bxs, bys = [], []
            for s in range(fl.local_steps):
                x, y = self.batcher.batch(rnd, s)
                bxs.append(x[sel])
                bys.append(y[sel])
            bx = torch.as_tensor(np.stack(bxs, axis=1), device=self.device)  # (M, L, B, ...)
            by = torch.as_tensor(np.stack(bys, axis=1), device=self.device).long()
            self._round(bx, by)
            if rnd % fl.eval_every == 0 or rnd == rounds - 1:
                with torch.no_grad():
                    acc = float(self.acc_fn(self.params, tx, ty))
                self.history.append({"round": rnd, "acc": acc})
                if log:
                    print(f"[fedavg] round {rnd:4d} acc {acc:.4f}")
        return self.history
