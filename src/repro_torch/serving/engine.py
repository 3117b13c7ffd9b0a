"""Batched serving runtime, the port of the JAX package's
``serving/engine.py``.

``make_serve_step`` is the one-token decode function; ``ServingEngine``
drives it on one device: a batch of requests, a one-shot prefill for the
transformer families, dense, MoE and VLM (the sliding-window kernel's path
under ``attn_impl="pallas_swa"``), token-by-token prefill over
``init_cache`` for the recurrent families and encdec, then greedy or
temperature decoding with EOS tracking.

For encdec, as in the reference's engine, ``init_cache`` is the zero
cache: the decoder attends to zero cross k/v, not to an encoded input
(``encdec.encdec_cache_init`` and ``decode_step`` are the real path).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.api import decode_step, init_cache, prefill
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int = 8
    max_len: int = 1024
    temperature: float = 0.0  # 0 = greedy
    eos_id: int = 0


def make_serve_step(cfg: ModelConfig):
    """(params, cache, tokens (B,1), index) -> (logits (B,1,V), cache)."""

    def serve_step(params, cache, tokens, index):
        return decode_step(params, cfg, cache, tokens, index)

    return serve_step


class ServingEngine:
    """Serves ``params`` (already on ``device``) under ``cfg``.  The
    device is the parameters' own; prompts are moved there."""

    def __init__(self, cfg: ModelConfig, sc: ServeConfig, params, device):
        self.cfg, self.sc, self.params = cfg, sc, params
        self.device = torch.device(device)
        self._step = make_serve_step(cfg)

    @torch.no_grad()
    def prefill(self, prompts):
        """prompts (B, S0) int -> (logits (B, 1, V) at the last prompt
        position, cache)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        B, S0 = prompts.shape
        if self.cfg.family in ("dense", "moe", "vlm"):
            last, cache = prefill(self.params, self.cfg, {"tokens": prompts}, self.sc.max_len)
            return last[:, None, :], cache
        cache = init_cache(self.cfg, B, self.sc.max_len, device=self.device)
        for i in range(S0):
            logits, cache = self._step(self.params, cache, prompts[:, i:i + 1], i)
        return logits, cache

    @torch.no_grad()
    def decode(self, logits, cache, start: int, max_new: int,
               generator: Optional[torch.Generator] = None):
        """``max_new`` tokens from the prefill's logits and cache, the
        first at position ``start``.  Greedy (the reference's argmax, first
        index on ties) at temperature 0; otherwise sampled from ``generator``
        (``torch.multinomial``: the draws cannot match
        ``jax.random.categorical``'s).  Returns (B, max_new) int32."""
        sc = self.sc
        B = logits.shape[0]
        out = []
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        for t in range(max_new):
            last = logits[:, -1].float()
            if sc.temperature > 0:
                probs = torch.softmax(last / sc.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)
            else:
                nxt = last.argmax(-1)[:, None]
            nxt = torch.where(done[:, None], torch.full_like(nxt, sc.eos_id), nxt).to(torch.int32)
            out.append(nxt)
            done = done | (nxt[:, 0] == sc.eos_id)
            logits, cache = self._step(self.params, cache, nxt, start + t)
        return torch.cat(out, dim=1)

    def generate(self, prompts, max_new: int = 32, generator: Optional[torch.Generator] = None):
        """prompts (B, S0) int (right-aligned, no padding) -> (B, max_new)
        generated ids (int32)."""
        logits, cache = self.prefill(prompts)
        return self.decode(logits, cache, int(prompts.shape[1]), max_new, generator)
