"""Plain reference of decentralized language-model training (D-PSGD):
each node's Llama-style decoder (RMSNorm, rotary positions on the two
halves of each head, grouped-query causal attention, SwiGLU, a tied
head) on its own token rows, the mean cross-entropy, the gradient by
autograd, clipped to a global norm per node, an SGD step, then one
gossip step over the static circulant overlay with Metropolis-Hastings
weights.  Float32, one node at a time."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench import inputs
from portbench.reference.dpsgd import circulant
from portbench.reference.precision import Products


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x (B, S, H, hd): pairs (i, i + hd/2) rotated by position / theta^(2i/hd)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def loss(p, m: dict, tokens, labels, prod: Products):
    """Mean next-token cross-entropy of one node over its (B, S) rows."""
    H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
    eps, theta = m["rms_norm_eps"], m["rope_theta"]
    x = p["embed"][tokens]
    B, S, d = x.shape
    hd = d // H
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    lay = p["dense_layers"]
    for i in range(m["num_hidden_layers"]):
        h = rms(x, lay["ln1"][i], eps)
        q = prod.out(prod.op(h) @ prod.op(lay["attn"]["w_q"][i])).reshape(B, S, H, hd)
        k = prod.out(prod.op(h) @ prod.op(lay["attn"]["w_k"][i])).reshape(B, S, Hkv, hd)
        v = prod.out(prod.op(h) @ prod.op(lay["attn"]["w_v"][i])).reshape(B, S, Hkv, hd)
        q, k = rope(q, theta), rope(k, theta)
        k = k.repeat_interleave(H // Hkv, 2)
        v = v.repeat_interleave(H // Hkv, 2)
        s = prod.out(prod.op(q.transpose(1, 2)) @ prod.op(k.transpose(1, 2).transpose(-1, -2)))
        w = torch.softmax(torch.where(mask, s / math.sqrt(hd), -math.inf), -1)
        o = prod.out(prod.op(w) @ prod.op(v.transpose(1, 2))).transpose(1, 2).reshape(B, S, d)
        x = x + prod.out(prod.op(o) @ prod.op(lay["attn"]["w_o"][i]))
        h = rms(x, lay["ln2"][i], eps)
        gate = prod.out(prod.op(h) @ prod.op(lay["mlp"]["w_gate"][i]))
        up = prod.out(prod.op(h) @ prod.op(lay["mlp"]["w_up"][i]))
        x = x + prod.out(prod.op(F.silu(gate) * up) @ prod.op(lay["mlp"]["w_down"][i]))
    logits = prod.out(prod.op(rms(x, p["final_norm"], eps)) @ prod.op(p["embed"]).T)
    return F.cross_entropy(logits.reshape(B * S, -1), labels.reshape(-1).long())


class Follow:
    """The reference run of the trainer's cell from its seed; ``tf32`` and
    ``fault`` ('half_batch', 'no_exchange', 'answer') as in
    ``reference/dpsgd.py``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, tf32=False, fault=None):
        self.m, self.cfg, self.traffic = cfg["model"], cfg, traffic
        self.device, self.fault, self.prod = device, fault, Products(tf32)
        self.n = cfg["n_nodes"]
        init = inputs.init_weights(inputs.lm_plan(self.m), seed, device)
        self.names = [k for k, _ in inputs.leaf_items(init)]
        self.x0 = dict(inputs.leaf_items(init))
        self.p = {k: v[None].repeat(self.n, *([1] * v.dim())) for k, v in self.x0.items()}
        self.stream = inputs.TokenStream(traffic, self.n, seed)
        nbr, w, ws = circulant(self.n, cfg["degree"])
        self.nbr = torch.as_tensor(nbr, device=device)
        self.w = torch.as_tensor(w, device=device)
        self.w_self = torch.as_tensor(ws, device=device)

    def tree(self, i: int, leaves):
        out = {}
        for name in self.names:
            node = out
            parts = name.split(".")
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = leaves[name]
        return out

    def step(self, step: int) -> float:
        """One trainer step of every node; the mean loss over nodes."""
        b = self.stream.batch(step)
        tokens = torch.as_tensor(b["tokens"], device=self.device)
        labels = torch.as_tensor(b["labels"], device=self.device)
        if self.fault == "half_batch":
            tokens, labels = tokens[:, :tokens.shape[1] // 2], labels[:, :labels.shape[1] // 2]
        lr, clip = self.cfg["lr"], self.cfg["grad_clip"]
        losses = []
        for i in range(self.n):
            leaves = {k: self.p[k][i].clone().requires_grad_(True) for k in self.names}
            value = loss(self.tree(i, leaves), self.m, tokens[i], labels[i], self.prod)
            grads = torch.autograd.grad(value, [leaves[k] for k in self.names])
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(clip / torch.clamp_min(norm, 1e-9), max=1.0)
            for k, g in zip(self.names, grads):
                self.p[k][i] += -lr * (g * scale)
            losses.append(float(value.detach()))
        if self.fault != "no_exchange":
            for k in self.names:
                a = self.p[k]
                shape = (-1,) + (1,) * (a.dim() - 1)
                out = self.w_self.reshape(shape) * a
                for s in range(self.nbr.shape[1]):
                    out += self.w[:, s].reshape(shape) * a[self.nbr[:, s]]
                self.p[k] = out
        if self.fault == "answer":
            losses[0] = losses[1]
        return float(np.float32(np.mean(np.float32(losses))))

    def change_norms(self):
        return {k: float((self.p[k] - self.x0[k][None]).double().norm()) for k in self.names}


def readings(cfg: dict, traffic: dict, seed: int, device, warm: int, tf32=False, fault=None):
    """The reference's readings of the set-up's warm steps: step 0, then
    ``warm`` steps."""
    ref = Follow(cfg, traffic, seed, device, tf32, fault)
    losses = [ref.step(0)]
    first = ref.change_norms()
    losses += [ref.step(s) for s in range(1, warm + 1)]
    return {"loss": losses, "first_change": first, "change": ref.change_norms()}
