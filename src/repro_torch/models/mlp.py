"""Small MLP classifier, the model of the topology and sparsification
studies (paper §3.2, §3.3) and of the scalability study, where the CNN
would make emulating a thousand nodes needlessly slow.  The parameters are
a plain dict in the JAX package's layout ((in, out) dense weights), so
both packages take the same arrays."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.common import dense_init


def mlp_init(gen: torch.Generator, in_dim: int = 32 * 32 * 3, hidden: int = 128,
             num_classes: int = 10, dtype=torch.float32) -> Dict:
    """Three dense layers drawn from ``gen`` on its device (fan-in
    truncated-normal weights, zero biases)."""
    dev = gen.device

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    return {
        "fc1": {"w": dense_init(gen, (in_dim, hidden), dtype), "b": zeros(hidden)},
        "fc2": {"w": dense_init(gen, (hidden, hidden), dtype), "b": zeros(hidden)},
        "fc3": {"w": dense_init(gen, (hidden, num_classes), dtype), "b": zeros(num_classes)},
    }


def mlp_apply(params, images):
    """images (B, ...) -> logits (B, num_classes); each image flattened."""
    x = images.reshape(images.shape[0], -1)
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    x = torch.relu(x @ params["fc2"]["w"] + params["fc2"]["b"])
    return x @ params["fc3"]["w"] + params["fc3"]["b"]
