"""GN-LeNet over a block of nodes in plain PyTorch: each node's own
weights, every node's forward in one grouped convolution per layer and
one batched product per dense layer.  Leaves are node-stacked in the
layout of ``portbench/inputs.py gnlenet_plan`` (HWIO convolutions, (in,
out) dense weights, NHWC images flattened in NHWC order)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.precision import Products


def group_norm(h, gamma, beta, groups: int, eps: float = 1e-5):
    """h (B, nb, C, H, W): contiguous channel groups per node and sample,
    population variance; gamma, beta (nb, C)."""
    B, nb, C, H, W = h.shape
    hg = h.reshape(B, nb, groups, C // groups, H, W)
    mean = hg.mean(dim=(3, 4, 5), keepdim=True)
    var = ((hg - mean) ** 2).mean(dim=(3, 4, 5), keepdim=True)
    hg = (hg - mean) * torch.rsqrt(var + eps)
    return hg.reshape(B, nb, C, H, W) * gamma[None, :, :, None, None] + beta[None, :, :, None, None]


def forward(p, x, groups: int, prod: Products):
    """Logits (nb, B, classes) of every node of the block: ``p``'s leaves
    (nb, ...); ``x`` (nb, B, H, W, C) or (B, H, W, C), one batch for all."""
    nb = p["conv1"]["w"].shape[0]
    if x.dim() == 4:
        x = x.expand(nb, *x.shape)
    _, B, H, W, C = x.shape
    h = x.permute(1, 0, 4, 2, 3).reshape(B, nb * C, H, W)
    for name in ("conv1", "conv2"):
        q = p[name]
        k, cin, cout = q["w"].shape[1], q["w"].shape[3], q["w"].shape[4]
        w = q["w"].permute(0, 4, 3, 1, 2).reshape(nb * cout, cin, k, k)
        h = prod.out(F.conv2d(prod.op(h), prod.op(w), q["b"].reshape(-1), padding=k // 2,
                              groups=nb))
        hh, ww = h.shape[-2:]
        h = group_norm(h.reshape(B, nb, cout, hh, ww), q["g"], q["be"], groups)
        h = F.max_pool2d(torch.relu(h).reshape(B, nb * cout, hh, ww), 2, 2)
    c2, hh, ww = p["conv2"]["w"].shape[4], h.shape[-2], h.shape[-1]
    h = h.reshape(B, nb, c2, hh, ww).permute(1, 0, 3, 4, 2).reshape(nb, B, hh * ww * c2)
    h = torch.relu(prod.out(torch.bmm(prod.op(h), prod.op(p["fc1"]["w"])))
                   + p["fc1"]["b"][:, None])
    return prod.out(torch.bmm(prod.op(h), prod.op(p["fc2"]["w"]))) + p["fc2"]["b"][:, None]


def node_losses(p, x, y, groups: int, prod: Products):
    """(nb,) mean cross-entropy of each node over its batch: x (nb, B,
    H, W, C), y (nb, B)."""
    logits = forward(p, x, groups, prod)
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, y[..., None])[..., 0]
    return (lse - gold).mean(-1)


def node_accuracy(p, x, y, groups: int, prod: Products):
    """(nb,) float32 share of the shared test batch (x, y) each node
    classifies right."""
    with torch.no_grad():
        return (forward(p, x, groups, prod).argmax(-1) == y[None]).float().mean(-1)
