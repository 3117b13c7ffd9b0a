"""Decoder-only transformer assembly (dense, MoE and VLM backbones), the port
of the JAX package's ``models/transformer.py``.

Layers are stacked on a leading L axis, as in the reference (so its
parameter trees convert leaf for leaf), and applied by a Python loop over
that axis where the reference scans.  An MoE config's layers follow its
plan (``first_dense`` leading dense layers, then groups of ``moe_every - 1``
dense layers and one MoE layer): ``dense_layers``, ``group_dense``
(groups x dense per group, doubly stacked) and ``group_moe``.  ``remat``
changes nothing here: ``torch.utils.checkpoint`` cannot run under the
trainer's ``torch.func`` transforms, so the knob is accepted and the
activations are kept (ROADMAP Queue 3).
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_apply, attn_cache_init, attn_init
from repro_torch.models.common import dense_init, embed_init, mlp_apply, mlp_init, rms_norm
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.utils.pytree import tree_map


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, moe: bool = False):
    dev = gen.device
    p = {
        "ln1": torch.ones((cfg.d_model,), dtype=cfg.tdtype, device=dev),
        "attn": attn_init(gen, cfg),
        "ln2": torch.ones((cfg.d_model,), dtype=cfg.tdtype, device=dev),
    }
    if moe:
        p["moe"] = moe_init(gen, cfg)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.tdtype)
    return p


def block_apply(p, cfg: ModelConfig, x, positions, cache=None, cache_index=None):
    """Pre-norm block. Returns (x, aux_loss, new_attn_cache)."""
    h, new_cache = attn_apply(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps), positions,
                              cache=cache, cache_index=cache_index)
    x = x + h
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        m, aux = moe_apply(p["moe"], cfg, h2)
    else:
        m, aux = mlp_apply(p["mlp"], h2), torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m, aux, new_cache


# ---------------------------------------------------------------------------
# layer stacking helpers
# ---------------------------------------------------------------------------

def stacked_init(fn, gen: torch.Generator, n: int):
    """``n`` draws of ``fn(gen)`` stacked leafwise on a new leading axis
    (one draw is viewed with the axis added, not copied: an MoE layer at
    published width holds some 32 GB)."""
    layers = [fn(gen) for _ in range(n)]
    if n == 1:
        return tree_map(lambda a: a.unsqueeze(0), layers[0])
    return tree_map(lambda *ls: torch.stack(ls), *layers)


def layer(stacked, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda a: a[i], stacked)


def unstack(stacked):
    """Every layer of a stacked tree, as a list of trees of views.  Under
    autograd ``unbind``'s backward stacks the layers' gradients once,
    where indexing layer by layer (:func:`layer`) would build a zero
    gradient of the whole stack for every layer and add them up."""
    if isinstance(stacked, dict):
        per = {k: unstack(v) for k, v in stacked.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(stacked, 0))


def _layer_plan(cfg: ModelConfig):
    """(n_prefix_dense, n_groups, dense_per_group), see ``config.moe_every``."""
    if cfg.family != "moe":
        return cfg.n_layers, 0, 0
    rest = cfg.n_layers - cfg.first_dense
    if rest % cfg.moe_every:
        raise ValueError(f"MoE plan: {rest} layers after first_dense not a multiple of "
                         f"moe_every={cfg.moe_every}")
    return cfg.first_dense, rest // cfg.moe_every, cfg.moe_every - 1


def transformer_init(gen: torch.Generator, cfg: ModelConfig):
    n_pre, n_grp, dpg = _layer_plan(cfg)
    params = {
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.tdtype, device=gen.device),
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), cfg.tdtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.tdtype)
    if n_pre:
        params["dense_layers"] = stacked_init(lambda g: block_init(g, cfg), gen, n_pre)
    if n_grp:
        if dpg:
            params["group_dense"] = stacked_init(
                lambda g: stacked_init(lambda gg: block_init(gg, cfg), g, dpg), gen, n_grp)
        params["group_moe"] = stacked_init(lambda g: block_init(g, cfg, moe=True), gen, n_grp)
    return params


def _layers(tree, cfg: ModelConfig):
    """(stack name, layer tree) of every layer of a stacked parameter (or
    cache) tree in the order the layers run: the leading dense layers, then
    each group's dense layers and its MoE layer.  ``group_dense`` is
    stacked twice (group, layer in group)."""
    n_pre, n_grp, dpg = _layer_plan(cfg)
    out = [("dense_layers", p) for p in (unstack(tree["dense_layers"]) if n_pre else [])]
    if n_grp:
        dense = [unstack(g) for g in unstack(tree["group_dense"])] if dpg else [[]] * n_grp
        for g, moe in enumerate(unstack(tree["group_moe"])):
            out += [("group_dense", p) for p in dense[g]]
            out.append(("group_moe", moe))
    return out


def transformer_apply(params, cfg: ModelConfig, x, positions):
    """x: (B,S,D) embedded input -> (hidden (B,S,D), aux): the MoE layers'
    aux losses summed in layer order."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for _, p in _layers(params, cfg):
        x, a, _ = block_apply(p, cfg, x, positions)
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


def _stack_cache(kvs, shape):
    """Per-layer cache dicts (in layer order: {k, v}, or MLA's {ckv,
    krope}) stacked to ``shape`` leading axes, as the layers' parameters
    are."""
    return {name: torch.stack([kv[name] for kv in kvs]).reshape(*shape, *kvs[0][name].shape)
            for name in kvs[0]}


def transformer_prefill(params, cfg: ModelConfig, x, positions, max_len: int):
    """Full pass that also returns the populated KV cache (the serving
    prefill).  x: (B,S,D); cache padded to max_len (to the window under a
    sliding window).  Returns (hidden (B,S,D), cache)."""
    n_pre, n_grp, dpg = _layer_plan(cfg)
    S = x.shape[1]
    eff_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    if S > eff_len:
        raise ValueError(f"prefill of {S} positions exceeds the cache's {eff_len}")
    kvs = {"dense_layers": [], "group_dense": [], "group_moe": []}
    for name, p in _layers(params, cfg):
        x, _, kv = block_apply(p, cfg, x, positions)
        kvs[name].append(kv)
    shapes = {"dense_layers": (n_pre,), "group_dense": (n_grp, dpg), "group_moe": (n_grp,)}
    cache = {name: {k: _pad_time(k, a, eff_len)
                    for k, a in _stack_cache(kv, shapes[name]).items()}
             for name, kv in kvs.items() if kv}
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def transformer_cache_init(cfg: ModelConfig, batch: int, max_len: int, device=None):
    n_pre, n_grp, dpg = _layer_plan(cfg)
    cache = {}
    if n_pre:
        cache["dense_layers"] = attn_cache_init(cfg, batch, max_len, layers=n_pre, device=device)
    if n_grp:
        if dpg:
            cache["group_dense"] = tree_map(
                lambda a: a.reshape(n_grp, dpg, *a.shape[1:]),
                attn_cache_init(cfg, batch, max_len, layers=n_grp * dpg, device=device))
        cache["group_moe"] = attn_cache_init(cfg, batch, max_len, layers=n_grp, device=device)
    return cache


def transformer_decode(params, cfg: ModelConfig, cache, x, index: int):
    """x: (B,1,D) embedded token at position ``index`` -> (h, cache), the
    cache updated in place.  Under M-RoPE all three streams take ``index``."""
    lead = (3,) if cfg.mrope_sections is not None else ()
    positions = torch.full((*lead, x.shape[0], 1), int(index), device=x.device)
    for (_, p), (_, c) in zip(_layers(params, cfg), _layers(cache, cfg)):
        x, _, _ = block_apply(p, cfg, x, positions, cache=c, cache_index=index)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache
