"""Large-model D-PSGD trainer, the port of the JAX package's
``training/trainer.py``: gossip as a step of node-stacked training.

``make_train_step`` builds the per-round function for N emulated DL nodes
stacked on the leading axis:

    grads   = vmap(grad(loss))          # local step, per node
    grads   = clip(grads)               # per-node global norm
    params  = optimizer(params, grads)
    params  = gossip(params)            # ring / regular / fully / dense

The node-stacked parameters are views of one flat (N, P) buffer
(:func:`stack_node_params`), as ``RoundEngine`` holds its state, so the
circulant gossip of a whole step is one launch of the gather-merge kernel
(``core/mixing.py mix_circulant``) and the update is written in place.

The reference cannot differentiate its two LM Pallas kernels (the
sliding-window attention and the SSD chunk), so its step fails wherever
a pass would take one; the port's step raises there too, on every device,
and never trains through the kernels' plain twins instead.  The sharded
mixings (``shard_map`` and the compressed ones) wait for ROADMAP Queue 1
item 6.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.mixing import mix_circulant, mix_dense, mix_fully
from repro_torch.models.api import loss_fn as model_loss_fn
from repro_torch.models.attention import swa_route
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import apply_updates_, clip_by_global_norm
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unvector

SHARDED_MIXINGS = ("shard_map", "sparse", "quant", "sparse+quant")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_nodes: int = 16
    topology: str = "regular"       # ring | regular | fully | dense (W given per step)
    degree: int = 5
    mixing_impl: str = "roll"        # roll (the merge kernel) | dense; shard_map, sparse,
    #                                  quant, sparse+quant raise (ROADMAP Queue 1 item 6)
    budget: float = 0.1              # compression budget of the sharded sparse mixings
    grad_clip: Optional[float] = 1.0
    gossip_every: int = 1            # kept for parity: the reference's step ignores it too
    gossip_in_fp32: bool = True      # kept for parity: every mixing accumulates in fp32


def _gossip(params, tc: TrainConfig, W=None):
    """One gossip step over a node-stacked tree (or a flat (N, P) tensor)."""
    if tc.topology == "fully":
        return mix_fully(params)
    if tc.mixing_impl == "dense" or tc.topology == "dense":
        if W is None:
            raise ValueError("dense mixing needs a mixing matrix W")
        return mix_dense(params, W)
    if tc.mixing_impl in SHARDED_MIXINGS:
        raise NotImplementedError(
            f"mixing_impl={tc.mixing_impl!r} is the node-sharded gossip, not ported yet "
            "(ROADMAP Queue 1 item 6)")
    degree = 2 if tc.topology == "ring" else tc.degree
    return mix_circulant(params, tc.n_nodes, degree)


def refuse_kernel_routes(cfg: ModelConfig, seq_len: int) -> None:
    """Raise where the reference's training step fails: a pass that takes
    the sliding-window attention kernel (``swa_route``) or the SSD chunk
    kernel (``ssm_impl="pallas"``)."""
    what = None
    if cfg.family in ("dense", "moe", "hybrid") and swa_route(cfg, seq_len):
        what = (f"attn_impl='pallas_swa' at window {cfg.sliding_window} and {seq_len} "
                "positions takes the sliding-window attention kernel")
    elif cfg.family in ("ssm", "hybrid") and cfg.ssm_impl == "pallas":
        what = "ssm_impl='pallas' takes the SSD chunk kernel"
    if what:
        raise NotImplementedError(
            f"{what}; the reference cannot differentiate its Pallas kernels (its training "
            "step fails there), so the trainer refuses this route rather than train "
            "through the kernel's plain twin; use attn_impl='naive' or ssm_impl='jnp'")


# ---------------------------------------------------------------------------
# the flat node-stacked parameter buffer
# ---------------------------------------------------------------------------

def stack_node_params(params):
    """A node-stacked tree copied into one flat (N, P) buffer of the
    leaves' common dtype: the returned tree's leaves are views of it, in
    sorted-key order (:func:`flat_buffer` finds it again)."""
    leaves = tree_leaves(params)
    dtypes = {l.dtype for l in leaves}
    if len(dtypes) != 1:
        raise ValueError(f"stack_node_params: leaves of several dtypes {sorted(map(str, dtypes))}")
    n = leaves[0].shape[0]
    X = torch.cat([l.reshape(n, -1) for l in leaves], 1)
    return tree_unvector(X, tree_map(lambda a: a[0], params))


def init_node_params(init_fn, n: int, device, seed: int = 0):
    """``n`` nodes' parameters, node i drawn by ``init_fn(generator)`` from
    a ``torch.Generator`` on ``device`` seeded ``seed * 1_000_003 + i``
    (``RoundEngine``'s seeding), written row by row into one flat (N, P)
    buffer; returns the tree of its views."""
    X = template = None
    for i in range(n):
        p = init_fn(torch.Generator(device=device).manual_seed(seed * 1_000_003 + i))
        leaves = tree_leaves(p)
        if X is None:
            template = p
            X = torch.empty((n, sum(l.numel() for l in leaves)), dtype=leaves[0].dtype,
                            device=device)
        torch.cat([l.reshape(-1).to(X.dtype) for l in leaves], out=X[i])
        del p, leaves
    return tree_unvector(X, template)


def flat_buffer(params) -> Optional[torch.Tensor]:
    """The (N, P) buffer whose views ``params``' leaves are, in sorted-key
    order and back to back, or None where they are not."""
    leaves = tree_leaves(params)
    X = leaves[0]._base
    if X is None or X.dim() != 2 or not X.is_contiguous():
        return None
    off = 0
    for l in leaves:
        k = math.prod(l.shape[1:])
        if (l._base is not X or l.shape[0] != X.shape[0]
                or l.data_ptr() != X.data_ptr() + off * X.element_size()):
            return None
        off += k
    return X if off == X.shape[1] else None


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def make_node_train_step(cfg: ModelConfig, optimizer: Optimizer, tc: TrainConfig):
    """The local step of every node at once, no gossip: per-node
    ``grad(loss)`` under ``vmap``, the per-node global-norm clip and the
    node-stacked optimizer.  ``step(params, opt_state, batch)`` with batch
    leaves (N, B, S) -> (params, opt_state, per-node losses (N,)); the
    update is written into ``params``' leaves in place."""
    node_grad = vmap(grad_and_value(lambda p, b: model_loss_fn(p, cfg, b)))

    def step(params, opt_state, batch):
        refuse_kernel_routes(cfg, batch["tokens"].shape[-1])
        grads, losses = node_grad(params, batch)
        if tc.grad_clip:
            grads = clip_by_global_norm(grads, tc.grad_clip)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates_(params, updates)
        return params, opt_state, losses

    return step


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, tc: TrainConfig):
    """Node-stacked D-PSGD round: ``train_step(params, opt_state, batch,
    W=None) -> (params, opt_state, mean loss over nodes)``.  batch leaves
    have shape (N, B, S); W is the (N, N) mixing matrix of
    ``topology="dense"``.  ``params`` whose leaves are not yet views of
    one flat buffer are copied into one first; the returned ``params`` are
    views of the mixed buffer (a fresh one for the circulant and dense
    mixings, the same one, mixed in place, for ``fully``)."""
    node_step = make_node_train_step(cfg, optimizer, tc)

    def train_step(params, opt_state, batch, W=None):
        if flat_buffer(params) is None:
            params = stack_node_params(params)
        params, opt_state, losses = node_step(params, opt_state, batch)
        X = flat_buffer(params)
        mixed = _gossip(X, tc, W=W)
        if tc.topology == "fully":
            X.copy_(mixed)
            return params, opt_state, losses.mean()
        return tree_unvector(mixed, tree_map(lambda a: a[0], params)), opt_state, losses.mean()

    return train_step
