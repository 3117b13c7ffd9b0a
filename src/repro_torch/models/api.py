"""Model API: the loss the engine trains with."""
from __future__ import annotations

import torch


def cross_entropy(logits, labels, ignore: int = -1):
    """Mean CE over valid labels. logits (..., V), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    valid = labels != ignore
    ce = torch.where(valid, lse - gold, torch.zeros_like(lse))
    return ce.sum() / valid.sum().clamp(min=1)
