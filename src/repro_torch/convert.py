"""Parameters from the JAX package into the port."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    """One array, bitwise, with its own dtype.  numpy has no bfloat16: the
    JAX package's bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
    torch cannot read, so their 16-bit words travel as int16 and are
    reinterpreted as torch.bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        words = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).view(np.int16).copy())
        return words.view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def params_from_jax(tree, device="cpu") -> Dict:
    """A parameter tree of (numpy or JAX) arrays, as the JAX package holds
    it, as the same nested dict of tensors on ``device``.  Layouts are kept
    (HWIO conv weights, (in, out) dense weights, stacked layer axes) and
    every leaf is copied bitwise with its own dtype (fp32, bf16, integers)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _leaf(tree, device)


def mlp_params_from_jax(tree, device="cpu") -> Dict:
    """The JAX package's ``models/mlp.py`` parameters (fc1..fc3, each a
    (in, out) weight ``w`` and a bias ``b``; node-stacked or not) as
    ``models/mlp.py``'s tensors on ``device``, bitwise."""
    want = {"fc1", "fc2", "fc3"}
    if set(tree) != want or any(set(tree[k]) != {"w", "b"} for k in want):
        raise ValueError(f"not an MLP parameter tree: {sorted(tree)}")
    return params_from_jax(tree, device)


def opt_state_from_jax(state, device="cpu"):
    """A node-stacked optimizer state of the JAX package (``vmap(opt.init)``
    or a trainer's) as the port's optimizers hold it, bitwise: SGD's ``()``
    stays ``()``, momentum's buffer tree and AdamW's ``{"mu", "nu", "t"}``
    (``t`` the per-node (N,) int32 step count) become tensors on
    ``device``."""
    if isinstance(state, (tuple, list)):
        return type(state)(opt_state_from_jax(s, device) for s in state)
    return params_from_jax(state, device)
