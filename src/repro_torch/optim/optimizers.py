"""Optimizers as (init, update) pairs over parameter trees.

The paper tunes plain SGD without momentum, the D-PSGD default; momentum
and AdamW are not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.utils.pytree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def apply_updates_(params, updates) -> None:
    """In-place :func:`apply_updates`: the engine's parameters are views of
    its flat (N, P) state, so this writes straight into it."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u.to(p.dtype))


def make_optimizer(name: str, lr: float, **kw) -> Optimizer:
    name = name.lower()
    if name == "sgd":
        return sgd(lr)
    if name in ("momentum", "adamw"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    raise ValueError(f"unknown optimizer {name!r}")
