"""Parameter tree <-> flat-vector utilities.

A parameter tree is a nested dict of tensors.  The flat vector orders its
leaves by sorted dict keys at every level (the order JAX flattens dicts
in), each leaf in row-major order, so the same parameters give the same
vector in both packages.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts, tuples and lists of the
    same structure (an empty tuple, an optimizer state without leaves,
    maps to itself)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_size(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(math.prod(l.shape) for l in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of a tree's leaves."""
    return sum(l.numel() * l.element_size() for l in tree_leaves(tree))


def tree_map_with_path_names(fn, tree):
    """:func:`tree_map` where ``fn(name, leaf)`` also receives the leaf's
    path: its dict keys and sequence indices joined by ``/``."""
    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(t[k], path + (str(k),)) for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, path + (str(i),)) for i, v in enumerate(t))
        return fn("/".join(path), t)

    return walk(tree, ())


def segment_starts(sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments,) int32 start offset of each segment id in a sorted
    id vector, on its device.  Ids past the last segment are not counted
    and negative ids count as segment 0, as in ``jnp.bincount``."""
    ids = sorted_ids.long().clamp(0, num_segments)
    counts = torch.bincount(ids, minlength=num_segments + 1)[:num_segments]
    starts = torch.zeros((num_segments,), dtype=torch.int32, device=sorted_ids.device)
    starts[1:] = torch.cumsum(counts, 0)[:-1]
    return starts


def tree_vector(tree) -> torch.Tensor:
    """Flatten a tree of tensors into a single 1-D fp32 vector."""
    return torch.cat([l.reshape(-1).to(torch.float32) for l in tree_leaves(tree)])


def tree_unvector(vec: torch.Tensor, like) -> Dict:
    """Inverse of :func:`tree_vector` given a template tree ``like``.

    ``vec`` may carry leading axes (a node-stacked (N, P) matrix): each
    leaf then gets them in front of its template shape.  Where the dtype
    already matches, the leaves are views of ``vec``, so writing to a leaf
    writes to ``vec``.
    """
    lead = tuple(vec.shape[:-1])
    off = 0

    def cut(l):
        nonlocal off
        n = math.prod(l.shape)
        out = vec[..., off:off + n].reshape(lead + tuple(l.shape)).to(l.dtype)
        off += n
        return out

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return cut(t)

    return walk(like)
