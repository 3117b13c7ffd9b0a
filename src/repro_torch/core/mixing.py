"""Gossip mixing: x_i' = sum_j W_ij x_j, W the overlay's Metropolis-Hastings
weights.

* :func:`apply_W` — the strategy-facing primitive, one W @ Y.  On a
  :class:`SparseTopology` it is the fused gather-merge kernel
  (``kernels/gossip_mix.py``), which reads neighbour rows by index and so
  never builds the (N, D, P) gather of the JAX package's ``apply_W``; on a
  dense (N, N) W it is ``torch.matmul``.
* :func:`mix_sparse` / :func:`mix_dense` — the same over a node-stacked
  parameter tree.

Summation order: the kernel adds the self slot first and then the
neighbour slots in order; the JAX ``apply_W`` adds ``w_self * x`` after the
neighbour contraction.  The two agree to fp32 rounding, not bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.core.topology import SparseTopology
from repro_torch.kernels.gossip_mix import gossip_mix_rows
from repro_torch.utils.pytree import tree_map


def mix_dense(stacked, W):
    """x_i' = sum_j W_ij x_j per leaf; W (N, N)."""
    W = W.to(torch.float32)
    return tree_map(
        lambda a: (W @ a.float().reshape(a.shape[0], -1)).reshape(a.shape).to(a.dtype),
        stacked,
    )


def apply_W(W, Y):
    """Row-stochastic mix Y' = W @ Y with fp32 accumulation, Y (N, ...).

    W: a dense (N, N) tensor or a ``SparseTopology`` whose tables live on
    Y's device.
    """
    Yf = Y.to(torch.float32)
    flat = Yf.reshape(Yf.shape[0], -1)
    if isinstance(W, SparseTopology):
        return gossip_mix_rows(flat, *W.merge_tables()).reshape(Yf.shape)
    return (W.to(torch.float32) @ flat).reshape(Yf.shape)


def mix_sparse(stacked, topo: SparseTopology):
    """Neighbor-indexed gossip over a tree: x_i' = w_self_i x_i +
    sum_k w[i,k] x_nbr[i,k] per leaf, through the fused merge kernel."""
    return tree_map(lambda a: apply_W(topo, a).to(a.dtype), stacked)
