"""Decoder-only transformer assembly, the dense half of the JAX package's
``models/transformer.py``.

Layers are stacked on a leading L axis, as in the reference (so its
parameter trees convert leaf for leaf), and applied by a Python loop over
that axis where the reference scans.  MoE layers raise
``NotImplementedError`` until ``moe.py`` is ported (ROADMAP Queue 1
item 8).
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_apply, attn_cache_init, attn_init
from repro_torch.models.common import dense_init, embed_init, mlp_apply, mlp_init, rms_norm
from repro_torch.models.config import ModelConfig
from repro_torch.utils.pytree import tree_map


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, moe: bool = False):
    if moe:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP Queue 1 item 8)")
    dev = gen.device
    return {
        "ln1": torch.ones((cfg.d_model,), dtype=cfg.tdtype, device=dev),
        "attn": attn_init(gen, cfg),
        "ln2": torch.ones((cfg.d_model,), dtype=cfg.tdtype, device=dev),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.tdtype),
    }


def block_apply(p, cfg: ModelConfig, x, positions, cache=None, cache_index=None):
    """Pre-norm block. Returns (x, aux_loss, new_attn_cache)."""
    if "moe" in p:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP Queue 1 item 8)")
    h, new_cache = attn_apply(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps), positions,
                              cache=cache, cache_index=cache_index)
    x = x + h
    x = x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, torch.zeros((), dtype=torch.float32, device=x.device), new_cache


# ---------------------------------------------------------------------------
# layer stacking helpers
# ---------------------------------------------------------------------------

def stacked_init(fn, gen: torch.Generator, n: int):
    """``n`` draws of ``fn(gen)`` stacked leafwise on a new leading axis."""
    layers = [fn(gen) for _ in range(n)]
    return tree_map(lambda *ls: torch.stack(ls), *layers)


def layer(stacked, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda a: a[i], stacked)


def _layer_plan(cfg: ModelConfig):
    """(n_prefix_dense, n_groups, dense_per_group); MoE plans raise."""
    if cfg.family == "moe":
        raise NotImplementedError("MoE layer plans are not ported yet (ROADMAP Queue 1 item 8)")
    return cfg.n_layers, 0, 0


def transformer_init(gen: torch.Generator, cfg: ModelConfig):
    n_pre, _, _ = _layer_plan(cfg)
    params = {
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.tdtype, device=gen.device),
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), cfg.tdtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.tdtype)
    params["dense_layers"] = stacked_init(lambda g: block_init(g, cfg), gen, n_pre)
    return params


def transformer_apply(params, cfg: ModelConfig, x, positions):
    """x: (B,S,D) embedded input -> (hidden (B,S,D), aux)."""
    n_pre, _, _ = _layer_plan(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_pre):
        x, a, _ = block_apply(layer(params["dense_layers"], i), cfg, x, positions)
        aux = aux + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def lm_head(params, cfg: ModelConfig, h):
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def _pad_time(name: str, a, eff_len: int):
    """Zero-pad a stacked cache leaf to ``eff_len`` positions on its time
    axis: -3 for k/v (.., S, Hkv, hd), -2 for latent leaves (.., S, c)."""
    t_axis = a.dim() - 3 if name in ("k", "v") else a.dim() - 2
    pad = eff_len - a.shape[t_axis]
    if pad == 0:
        return a
    shape = list(a.shape)
    shape[t_axis] = pad
    return torch.cat([a, a.new_zeros(shape)], dim=t_axis)


def transformer_prefill(params, cfg: ModelConfig, x, positions, max_len: int):
    """Full pass that also returns the populated KV cache (the serving
    prefill).  x: (B,S,D); cache padded to max_len (to the window under a
    sliding window).  Returns (hidden (B,S,D), cache)."""
    n_pre, _, _ = _layer_plan(cfg)
    S = x.shape[1]
    eff_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    if S > eff_len:
        raise ValueError(f"prefill of {S} positions exceeds the cache's {eff_len}")
    ks, vs = [], []
    for i in range(n_pre):
        x, _, kv = block_apply(layer(params["dense_layers"], i), cfg, x, positions)
        ks.append(kv["k"])
        vs.append(kv["v"])
    cache = {"dense_layers": {name: _pad_time(name, torch.stack(t), eff_len)
                              for name, t in (("k", ks), ("v", vs))}}
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def transformer_cache_init(cfg: ModelConfig, batch: int, max_len: int, device=None):
    n_pre, _, _ = _layer_plan(cfg)
    return {"dense_layers": attn_cache_init(cfg, batch, max_len, layers=n_pre, device=device)}


def transformer_decode(params, cfg: ModelConfig, cache, x, index: int):
    """x: (B,1,D) embedded token at position ``index`` -> (h, cache), the
    cache updated in place."""
    n_pre, _, _ = _layer_plan(cfg)
    positions = torch.full((x.shape[0], 1), int(index), device=x.device)
    for i in range(n_pre):
        x, _, _ = block_apply(layer(params["dense_layers"], i), cfg, x, positions,
                              cache=layer(cache["dense_layers"], i), cache_index=index)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache
