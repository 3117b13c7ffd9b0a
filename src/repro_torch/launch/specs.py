"""Dry-run input specs, the port of the JAX package's ``launch/specs.py``:
``meta`` tensors stand in for the reference's ``ShapeDtypeStruct``s (the
shapes and dtypes of every input, no storage), and partition specs are
plain tuples of mesh-axis names or None per dim.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs import InputShape
from repro_torch.models.api import _MetaGenerator, init_cache, init_params, param_specs
from repro_torch.models.config import ModelConfig
from repro_torch.utils.pytree import tree_map

META = torch.device("meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def plan_nodes(shape: InputShape, n_slots: int) -> Tuple[int, int]:
    """(n_nodes, batch_per_node): emulated-DL-node count for this input.

    The node axis carries DL nodes; if the global batch cannot fill every
    slot (long-context decode), the surplus slots replicate."""
    n_nodes = min(n_slots, shape.global_batch)
    assert shape.global_batch % n_nodes == 0
    return n_nodes, shape.global_batch // n_nodes


def node_spec(n_nodes: int, n_slots: int, node_axes: tuple):
    """Leading partition-spec entry for the node-stacked dimension."""
    if n_nodes == n_slots:
        return node_axes if len(node_axes) > 1 else node_axes[0]
    if n_nodes == 1:
        return None
    # partial fill: shard over the first node axis
    return node_axes[0]


def batch_specs(cfg: ModelConfig, shape: InputShape, n_nodes: int, B: int):
    """The *stacked* train batch as ``meta`` tensors, (n_nodes, B, ...)
    each (the leading node axis is the caller's vmap axis)."""
    S = shape.seq_len
    tok = _meta((n_nodes, B, S), torch.int32)
    if cfg.family == "vlm":
        return {
            "embeddings": _meta((n_nodes, B, S, cfg.d_model), cfg.tdtype),
            "positions": _meta((n_nodes, 3, B, S), torch.int32),
            "labels": tok,
        }
    if cfg.family == "encdec":
        return {
            "frames": _meta((n_nodes, B, cfg.enc_seq, cfg.d_model), cfg.tdtype),
            "tokens": tok,
            "labels": tok,
        }
    if cfg.family == "cnn":
        return {
            "images": _meta((n_nodes, B, 32, 32, 3), cfg.tdtype),
            "labels": _meta((n_nodes, B), torch.int32),
        }
    return {"tokens": tok, "labels": tok}


def batch_partition_specs(batch, node_entry):
    """The node entry in front, every other dim replicated."""
    return tree_map(lambda l: (node_entry, *(None,) * (l.dim() - 1)), batch)


def stacked_param_specs(cfg: ModelConfig, node_entry):
    return param_specs(cfg, leading=(node_entry,))


def stacked_param_shapes(cfg: ModelConfig, n_nodes: int):
    """``init_params``' tree with a leading node axis, as ``meta`` tensors."""
    return tree_map(lambda l: _meta((n_nodes, *l.shape), l.dtype),
                    init_params(cfg, _MetaGenerator()))


def decode_specs(cfg: ModelConfig, shape: InputShape, n_nodes: int, B: int):
    """(cache, tokens) as ``meta`` tensors for one-token decode with a
    seq_len-deep cache, node-stacked."""
    cache = tree_map(lambda l: _meta((n_nodes, *l.shape), l.dtype),
                     init_cache(cfg, B, shape.seq_len, device=META))
    return cache, _meta((n_nodes, B, 1), torch.int32)
