"""Shared layers: inits, RMSNorm, RoPE / M-RoPE, SwiGLU MLP."""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style): a standard normal cut at
    ±2, times ``scale`` or fan_in^-1/2, drawn from ``gen`` on its device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in**-0.5
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)  # in place: one fp32 temporary per leaf


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype=torch.float32) -> torch.Tensor:
    """Normal(0, 0.02) embedding table drawn from ``gen`` on its device."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    t.normal_(0.0, 1.0, generator=gen)
    return t.mul_(0.02).to(dtype)


def rms_norm(x, weight, eps: float = 1e-5):
    """RMSNorm in fp32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x, positions, theta: float):
    """Rotate pairs (first half against second half). x: (..., S, H, D);
    positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., None].float() * inv                       # (..., S, d/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections):
    """Multimodal RoPE (qwen2-vl): three position streams (t, h, w), each
    rotating its own band of the d/2 frequencies (stream i the next
    ``sections[i]`` of them), in ``apply_rope``'s fp32 rotate-half layout.
    x: (B, S, H, D); positions3: (3, B, S); sum(sections) == D // 2."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must cover {d // 2} frequencies")
    inv = rope_freqs(d, theta, x.device)
    # each frequency's position stream: (B, S, d/2)
    pos = torch.cat([positions3[i][..., None].expand(*positions3.shape[1:], n)
                     for i, n in enumerate(sections)], dim=-1).float()
    ang = pos * inv
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), dtype),
        "w_up": dense_init(gen, (d_model, d_ff), dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype),
    }


def mlp_apply(p, x):
    """SwiGLU: silu(x W_gate) * (x W_up), then W_down."""
    return (torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
