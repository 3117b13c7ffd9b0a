"""Optimizers as (init, update) pairs over node-stacked parameter trees.

Every leaf carries the node axis first, so one call updates every node,
as ``jax.vmap`` of the JAX package's per-node optimizer does.  The paper
tunes plain SGD without momentum, the D-PSGD default; momentum (with
Nesterov's variant) and AdamW serve the trainer and the optimizer
studies.  AdamW's step count ``t`` is per node, (N,) int32, as the JAX
engine's ``vmap(init)`` makes it, so a node that sits out a round (churn)
keeps its own count.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def _per_node(v, like):
    """An (N,) per-node vector shaped to broadcast over the leaf ``like``."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum: buf = beta·buf + g; the update is -lr·buf, or
    -lr·(beta·buf + g) with ``nesterov``."""
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        buf = tree_map(lambda m, g: beta * m + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr * (beta * m + g), buf, grads)
        else:
            upd = tree_map(lambda m: -lr * m, buf)
        return upd, buf

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with bias correction and decoupled weight decay; the moments
    are fp32 whatever the parameters' dtype."""
    def init(params):
        z = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        lead = tree_leaves(params)[0]
        t = torch.zeros(lead.shape[:1], dtype=torch.int32, device=lead.device)
        return {"mu": z, "nu": tree_map(torch.clone, z), "t": t}

    def update(grads, state, params):
        t = state["t"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32), state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.to(torch.float32).square(),
                      state["nu"], grads)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(b1, tf)
        bc2 = 1 - torch.pow(b2, tf)

        def upd(m, v, p):
            step = (m / _per_node(bc1, m)) / (torch.sqrt(v / _per_node(bc2, v)) + eps)
            return (-lr * (step + weight_decay * p.to(torch.float32))).to(p.dtype)

        return tree_map(upd, mu, nu, params), {"mu": mu, "nu": nu, "t": t}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def apply_updates_(params, updates) -> None:
    """In-place :func:`apply_updates`: the engine's parameters are views of
    its flat (N, P) state, so this writes straight into it."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u.to(p.dtype))


def global_norm(tree) -> torch.Tensor:
    """(N,) per-node L2 norm over every leaf, in fp32."""
    return torch.sqrt(sum(l.to(torch.float32).square().reshape(l.shape[0], -1).sum(1)
                          for l in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Each node's gradients scaled down to a global norm of at most
    ``max_norm``."""
    scale = torch.clamp(max_norm / torch.clamp_min(global_norm(grads), 1e-9), max=1.0)
    return tree_map(lambda g: g * _per_node(scale, g).to(g.dtype), grads)


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    name = name.lower()
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
