"""Shared layer initialisation."""
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
    return (t * std).to(dtype)
