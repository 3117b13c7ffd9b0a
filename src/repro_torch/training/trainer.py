"""Large-model D-PSGD trainer, the port of the JAX package's
``training/trainer.py``: gossip as a step of node-stacked training.

``make_train_step`` builds the per-round function for N emulated DL nodes
stacked on the leading axis:

    grads   = vmap(grad(loss))          # local step, per node
    grads   = clip(grads)               # per-node global norm
    params  = optimizer(params, grads)
    params  = gossip(params)            # ring / regular / fully / dense

The node-stacked parameters are views of one flat (N, P) buffer
(:func:`stack_node_params`; one per dtype where the leaves mix dtypes, as
an SSM's fp32 decay beside bf16 weights), as ``RoundEngine`` holds its
state, so the circulant gossip of a whole step is one launch of the
gather-merge kernel per buffer (``core/mixing.py mix_circulant``) and the
update is written in place.

The reference cannot differentiate its two LM Pallas kernels (the
sliding-window attention and the SSD chunk), so its step fails wherever
a pass would take one; the port's step raises there too, on every device,
and never trains through the kernels' plain twins instead.

The sharded mixings (``mixing_impl`` ``shard_map``, ``sparse``, ``quant``
and ``sparse+quant``) run one node per rank of a ``torch.distributed``
group of ``n_nodes`` ranks (``launch/shard.py`` starts them), as the JAX
package's ``shard_map`` runs one node per device of its node axis: each
rank's ``params`` are its own (1, ...) node, gossip crosses ranks by
point-to-point exchanges (``core/mixing.py mix_circulant_shmap``; the
compressed wire of ``mix_compressed_circulant_shmap``), and the mean loss
is summed over the ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.mixing import (
    NodeShard,
    ShardedDense,
    mix_circulant,
    mix_circulant_shmap,
    mix_compressed_circulant_shmap,
    mix_dense,
    mix_fully,
)
from repro_torch.models.api import loss_fn as model_loss_fn
from repro_torch.models.attention import swa_route
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import apply_updates_, clip_by_global_norm
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unvector

SHARDED_MIXINGS = ("shard_map", "sparse", "quant", "sparse+quant")
COMPRESSED_MIXINGS = ("sparse", "quant", "sparse+quant")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_nodes: int = 16
    topology: str = "regular"       # ring | regular | fully | dense (W given per step)
    degree: int = 5
    mixing_impl: str = "roll"        # roll (the merge kernel) | dense | shard_map | sparse |
    #                                  quant | sparse+quant (one node per rank, compressed wire)
    budget: float = 0.1              # compression budget of the sharded sparse mixings
    grad_clip: Optional[float] = 1.0
    gossip_every: int = 1            # kept for parity: the reference's step ignores it too
    gossip_in_fp32: bool = True      # kept for parity: every mixing accumulates in fp32


def _gossip(params, tc: TrainConfig, W=None, shard: Optional[NodeShard] = None):
    """One gossip step over a node-stacked tree (or a flat (N, P) tensor);
    with ``shard`` (the sharded mixings), over this rank's node."""
    if tc.topology == "fully":
        if shard is not None:
            return tree_map(lambda a: (shard.psum(a.float()) / shard.n).to(a.dtype), params)
        return mix_fully(params)
    if tc.mixing_impl == "dense" or tc.topology == "dense":
        if W is None:
            raise ValueError("dense mixing needs a mixing matrix W")
        if shard is not None:
            Ws = ShardedDense(shard.local(W), shard)
            return tree_map(lambda a: Ws.apply(a.float()).to(a.dtype), params)
        return mix_dense(params, W)
    degree = 2 if tc.topology == "ring" else tc.degree
    if tc.mixing_impl in COMPRESSED_MIXINGS:
        return mix_compressed_circulant_shmap(params, shard, degree, budget=tc.budget,
                                              mode=tc.mixing_impl)
    if tc.mixing_impl == "shard_map":
        return mix_circulant_shmap(params, shard, degree)
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

def _views(bufs, like):
    """``like``'s tree of views into ``bufs`` (dtype -> (N, P_d) buffer):
    each leaf cut from its dtype's buffer, in sorted-key order."""
    off = dict.fromkeys(bufs, 0)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        X = bufs[t.dtype]
        k = math.prod(t.shape)
        view = X[:, off[t.dtype]:off[t.dtype] + k].reshape(X.shape[0], *t.shape)
        off[t.dtype] += k
        return view

    return walk(like)


def stack_node_params(params):
    """A node-stacked tree copied into one flat (N, P_d) buffer per leaf
    dtype (one buffer where the leaves share a dtype): the returned tree's
    leaves are views of them, each buffer holding its dtype's leaves in
    sorted-key order (:func:`flat_buffers` finds them again)."""
    leaves = tree_leaves(params)
    n = leaves[0].shape[0]
    bufs = {dt: torch.cat([l.reshape(n, -1) for l in leaves if l.dtype == dt], 1)
            for dt in dict.fromkeys(l.dtype for l in leaves)}
    return _views(bufs, tree_map(lambda a: a[0], params))


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


def flat_buffers(params) -> Optional[List[torch.Tensor]]:
    """The (N, P_d) buffers whose views ``params``' leaves are, one per
    dtype in the order the dtypes first come in sorted-key order, each
    holding its leaves back to back; or None where they are not."""
    bufs, off = {}, {}
    for l in tree_leaves(params):
        X = l._base
        if X is None or X.dim() != 2 or not X.is_contiguous() or X.dtype != l.dtype:
            return None
        if bufs.setdefault(l.dtype, X) is not X:
            return None
        o = off.get(l.dtype, 0)
        if l.shape[0] != X.shape[0] or l.data_ptr() != X.data_ptr() + o * X.element_size():
            return None
        off[l.dtype] = o + math.prod(l.shape[1:])
    if any(off[dt] != X.shape[1] for dt, X in bufs.items()):
        return None
    return list(bufs.values())


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
        refuse_kernel_routes(cfg, batch["labels"].shape[-1])
        grads, losses = node_grad(params, batch)
        if tc.grad_clip:
            grads = clip_by_global_norm(grads, tc.grad_clip)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        apply_updates_(params, updates)
        return params, opt_state, losses

    return step


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, tc: TrainConfig,
                    shard: Optional[NodeShard] = None):
    """Node-stacked D-PSGD round: ``train_step(params, opt_state, batch,
    W=None) -> (params, opt_state, mean loss over nodes)``.  batch leaves
    have shape (N, B, S); W is the (N, N) mixing matrix of
    ``topology="dense"``.  ``params`` whose leaves are not yet views of
    flat buffers (one per dtype) are copied into them first; the returned
    ``params`` are views of the mixed buffers (fresh ones for the
    circulant and dense mixings, the same ones, mixed in place, for
    ``fully``).

    The sharded mixings run on each of ``tc.n_nodes`` ranks (``shard``,
    default: the default group's), with this rank's node as N = 1: its
    (1, ...) params and its (1, B, S) batch; the loss is the mean over
    all nodes on every rank."""
    node_step = make_node_train_step(cfg, optimizer, tc)
    if tc.mixing_impl in SHARDED_MIXINGS:
        shard = shard or NodeShard.of_group(tc.n_nodes)
        if shard.n != tc.n_nodes or shard.block != 1:
            raise ValueError(f"mixing_impl={tc.mixing_impl!r} runs one node per rank: "
                             f"n_nodes={tc.n_nodes} over {shard.ndev} ranks")
    else:
        shard = None

    def mean_loss(losses):
        if shard is None:
            return losses.mean()
        return shard.psum(losses.sum()) / shard.n

    def train_step(params, opt_state, batch, W=None):
        if flat_buffers(params) is None:
            params = stack_node_params(params)
        params, opt_state, losses = node_step(params, opt_state, batch)
        if tc.mixing_impl in COMPRESSED_MIXINGS and tc.topology not in ("fully", "dense"):
            # the compressed wire selects per leaf, as the JAX package's
            # per-leaf shard_map does
            return stack_node_params(_gossip(params, tc, shard=shard)), opt_state, \
                mean_loss(losses)
        bufs = flat_buffers(params)
        mixed = [_gossip(X, tc, W=W, shard=shard) for X in bufs]
        if tc.topology == "fully":
            for X, m in zip(bufs, mixed):
                X.copy_(m)
            return params, opt_state, mean_loss(losses)
        like = tree_map(lambda a: a[0], params)
        return _views({m.dtype: m for m in mixed}, like), opt_state, mean_loss(losses)

    return train_step
