"""GN-LeNet: the paper's CIFAR-10 workload, a small conv net with GroupNorm.

Parameters are a plain dict in the JAX package's layout — HWIO conv
weights, (in, out) dense weights — and images are NHWC, so both packages
take the same arrays.  ``cnn_apply`` permutes to ``F.conv2d``'s NCHW/OIHW
inside and flattens in NHWC order, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense_init


def group_norm(x, gamma, beta, groups: int = 8, eps: float = 1e-5):
    """GroupNorm over NCHW ``x``: contiguous channel groups, population
    variance, computed in fp32.  Written out rather than ``F.group_norm``,
    which ``vmap`` cannot batch over per-node weights with shared inputs."""
    B, C, H, W = x.shape
    xg = x.float().reshape(B, groups, C // groups, H, W)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    y = xg.reshape(B, C, H, W) * gamma[:, None, None] + beta[:, None, None]
    return y.to(x.dtype)


def conv(x, w, b):
    """5x5 SAME convolution of NCHW ``x`` with an HWIO weight."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=w.shape[0] // 2)


def cnn_init(gen: torch.Generator, num_classes: int = 10, channels: int = 3,
             width: int = 32, dtype=torch.float32) -> Dict:
    """GN-LeNet parameters on ``gen``'s device; ``width`` must be a
    multiple of 8 (the GroupNorm groups)."""
    dev = gen.device
    c1, c2 = width, 2 * width

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=dev)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=dev)

    return {
        "conv1": {"w": dense_init(gen, (5, 5, channels, c1), dtype, scale=(25 * channels) ** -0.5),
                  "b": zeros(c1), "g": ones(c1), "be": zeros(c1)},
        "conv2": {"w": dense_init(gen, (5, 5, c1, c2), dtype, scale=(25 * c1) ** -0.5),
                  "b": zeros(c2), "g": ones(c2), "be": zeros(c2)},
        "fc1": {"w": dense_init(gen, (c2 * 8 * 8, 128), dtype), "b": zeros(128)},
        "fc2": {"w": dense_init(gen, (128, num_classes), dtype), "b": zeros(num_classes)},
    }


def cnn_apply(params, images):
    """images: (B, 32, 32, C) NHWC -> logits (B, num_classes)."""
    x = images.permute(0, 3, 1, 2)
    for name in ("conv1", "conv2"):
        p = params[name]
        x = conv(x, p["w"], p["b"])
        x = torch.relu(group_norm(x, p["g"], p["be"]))
        x = F.max_pool2d(x, 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten order
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


class GNLeNet(nn.Module):
    """One node's GN-LeNet as a module; ``param_tree()`` gives the dict
    that :func:`cnn_apply` takes."""

    def __init__(self, params: Optional[Dict] = None, *, gen: Optional[torch.Generator] = None,
                 width: int = 32, num_classes: int = 10, channels: int = 3):
        super().__init__()
        if params is None:
            params = cnn_init(gen if gen is not None else torch.Generator(),
                              num_classes, channels, width)
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({k: nn.Parameter(v) for k, v in leaf.items()})
            for name, leaf in params.items()
        })

    def param_tree(self) -> Dict:
        return {name: dict(pd.items()) for name, pd in self.layers.items()}

    def forward(self, images):
        return cnn_apply(self.param_tree(), images)
