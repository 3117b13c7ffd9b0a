"""Zamba2-style hybrid: a Mamba2 backbone plus one *shared* attention block
applied every ``attn_every`` SSM layers, the port of the JAX package's
``models/hybrid.py``.  [arXiv:2411.15242]  With ``attn_every = 0`` it is
the pure SSM stack (Mamba2).

The shared block's weights are reused at every application; only its KV
cache is per application.  Layer trees are stacked as in the reference
(``mamba_seg`` twice: segment, then layer in the segment).
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_cache_init
from repro_torch.models.common import dense_init, embed_init, rms_norm
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import ssm_apply, ssm_cache_init, ssm_decode_step, ssm_init
from repro_torch.models.transformer import block_apply, block_init, layer, stacked_init, unstack
from repro_torch.utils.pytree import tree_map


def _plan(cfg: ModelConfig):
    """(segments, SSM layers per segment, SSM layers after the last)."""
    if cfg.attn_every <= 0:
        return 0, 0, cfg.n_layers
    n_seg = cfg.n_layers // cfg.attn_every
    return n_seg, cfg.attn_every, cfg.n_layers - n_seg * cfg.attn_every


def mamba_block_init(gen: torch.Generator, cfg: ModelConfig):
    return {"ln": torch.ones((cfg.d_model,), dtype=cfg.tdtype, device=gen.device),
            "ssm": ssm_init(gen, cfg)}


def hybrid_init(gen: torch.Generator, cfg: ModelConfig):
    n_seg, per, tail = _plan(cfg)
    params = {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), cfg.tdtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.tdtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.tdtype)
    if n_seg:
        params["mamba_seg"] = stacked_init(
            lambda g: stacked_init(lambda gg: mamba_block_init(gg, cfg), g, per), gen, n_seg)
        params["shared_attn"] = block_init(gen, cfg)
    if tail:
        params["mamba_tail"] = stacked_init(lambda g: mamba_block_init(g, cfg), gen, tail)
    return params


def _mamba_blk(p, cfg: ModelConfig, x):
    return x + ssm_apply(p["ssm"], cfg, rms_norm(x, p["ln"], cfg.norm_eps))


def hybrid_apply(params, cfg: ModelConfig, x, positions):
    n_seg, per, tail = _plan(cfg)
    for seg in (unstack(params["mamba_seg"]) if n_seg else []):
        for p in unstack(seg):
            x = _mamba_blk(p, cfg, x)
        x, _, _ = block_apply(params["shared_attn"], cfg, x, positions)
    for p in (unstack(params["mamba_tail"]) if tail else []):
        x = _mamba_blk(p, cfg, x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), torch.zeros(
        (), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def hybrid_cache_init(cfg: ModelConfig, batch: int, max_len: int, device=None):
    n_seg, per, tail = _plan(cfg)
    cache = {}
    if n_seg:
        seg = ssm_cache_init(cfg, batch, layers=n_seg * per, device=device)
        cache["mamba_seg"] = tree_map(lambda a: a.reshape(n_seg, per, *a.shape[1:]), seg)
        cache["shared_attn"] = attn_cache_init(cfg, batch, max_len, layers=n_seg, device=device)
    if tail:
        cache["mamba_tail"] = ssm_cache_init(cfg, batch, layers=tail, device=device)
    return cache


def hybrid_decode(params, cfg: ModelConfig, cache, x, index: int):
    """x: (B,1,D) embedded token at ``index`` -> (h, new cache).  The
    SSM states are returned anew; the shared block's KV cache is written in
    place."""
    n_seg, per, tail = _plan(cfg)
    positions = torch.full((x.shape[0], 1), int(index), device=x.device)

    def mdec(lp, h, c):
        y, nc = ssm_decode_step(lp["ssm"], cfg, rms_norm(h, lp["ln"], cfg.norm_eps), c)
        return h + y, nc

    new_cache = {}
    if n_seg:
        segs = []
        for s in range(n_seg):
            seg_p, seg_c = layer(params["mamba_seg"], s), layer(cache["mamba_seg"], s)
            news = []
            for i in range(per):
                x, nc = mdec(layer(seg_p, i), x, layer(seg_c, i))
                news.append(nc)
            segs.append(tree_map(lambda *ls: torch.stack(ls), *news))
            x, _, _ = block_apply(params["shared_attn"], cfg, x, positions,
                                  cache=layer(cache["shared_attn"], s), cache_index=index)
        new_cache["mamba_seg"] = tree_map(lambda *ls: torch.stack(ls), *segs)
        new_cache["shared_attn"] = cache["shared_attn"]
    if tail:
        news = []
        for i in range(tail):
            x, nc = mdec(layer(params["mamba_tail"], i), x, layer(cache["mamba_tail"], i))
            news.append(nc)
        new_cache["mamba_tail"] = tree_map(lambda *ls: torch.stack(ls), *news)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), new_cache
