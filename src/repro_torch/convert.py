"""Parameters from the JAX package into the port."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_jax(tree, device="cpu") -> Dict:
    """A (node-stacked) parameter tree of numpy arrays, as the JAX package
    holds it, as the same nested dict of tensors on ``device``.  Layouts
    are kept (HWIO conv weights, (in, out) dense weights), values copied
    bitwise."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)
