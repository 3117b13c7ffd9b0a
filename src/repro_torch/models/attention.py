"""Attention: GQA (qk-norm, QKV bias, RoPE / M-RoPE, a sliding window),
MLA (DeepSeek-V2's latent attention) and cross-attention, with KV caches
(ring-buffered under a window; MLA's holds the latent).  The port of the
JAX package's ``models/attention.py``.

Layouts, as in the reference: activations (B, S, D); q/k/v (B, S, H, hd);
caches (B, S_max, Hkv, hd); MLA's latent cache {"ckv": (B, S_max,
kv_lora_rank), "krope": (B, S_max, qk_rope_dim)}.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.swa_attention import BK, BQ, swa_attention_gqa
from repro_torch.models.common import apply_mrope, apply_rope, dense_init, rms_norm
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig, cross: bool = False):
    """One layer's attention parameters; a cross-attention layer is GQA
    even under ``cfg.mla``."""
    d, H, Hkv, hd, dt = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.tdtype
    dev = gen.device
    if cfg.mla and not cross:
        qk = H * (cfg.qk_nope_dim + cfg.qk_rope_dim)
        p = {
            "w_q": dense_init(gen, (cfg.q_lora_rank or d, qk), dt),
            "w_dkv": dense_init(gen, (d, cfg.kv_lora_rank + cfg.qk_rope_dim), dt),
            "kv_norm": torch.ones((cfg.kv_lora_rank,), dtype=dt, device=dev),
            "w_uk": dense_init(gen, (H, cfg.kv_lora_rank, cfg.qk_nope_dim), dt),
            "w_uv": dense_init(gen, (H, cfg.kv_lora_rank, cfg.v_head_dim), dt),
            "w_o": dense_init(gen, (H * cfg.v_head_dim, d), dt),
        }
        if cfg.q_lora_rank:
            p["w_dq"] = dense_init(gen, (d, cfg.q_lora_rank), dt)
            p["q_norm"] = torch.ones((cfg.q_lora_rank,), dtype=dt, device=dev)
        return p
    p = {
        "w_q": dense_init(gen, (d, H * hd), dt),
        "w_k": dense_init(gen, (d, Hkv * hd), dt),
        "w_v": dense_init(gen, (d, Hkv * hd), dt),
        "w_o": dense_init(gen, (H * hd, d), dt),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((H * hd,), dtype=dt, device=dev)
        p["b_k"] = torch.zeros((Hkv * hd,), dtype=dt, device=dev)
        p["b_v"] = torch.zeros((Hkv * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, layers: Optional[int] = None,
                    device=None):
    """Zeroed KV cache for ``layers`` stacked layers (or unstacked if None);
    under a sliding window it holds at most ``sliding_window`` positions.
    MLA's holds the latent and the roped key part."""
    if cfg.sliding_window is not None:
        max_len = min(max_len, cfg.sliding_window)
    lead = () if layers is None else (layers,)
    if cfg.mla:
        return {"ckv": torch.zeros((*lead, batch, max_len, cfg.kv_lora_rank), dtype=cfg.tdtype,
                                   device=device),
                "krope": torch.zeros((*lead, batch, max_len, cfg.qk_rope_dim), dtype=cfg.tdtype,
                                     device=device)}
    shp = (*lead, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shp, dtype=cfg.tdtype, device=device),
            "v": torch.zeros(shp, dtype=cfg.tdtype, device=device)}


# ---------------------------------------------------------------------------
# core score/combine
# ---------------------------------------------------------------------------

def _gqa_scores(q, k):
    """q: (B,S,H,hd), k: (B,T,Hkv,hd) -> (B,Hkv,G,S,T) fp32 scores."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    q = q.reshape(B, S, Hkv, H // Hkv, hd)
    return torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())


def _gqa_combine(w, v):
    """w: (B,Hkv,G,S,T) fp32, v: (B,T,Hkv,hd) -> (B,S,H*hd) in v's dtype."""
    B, Hkv, G, S, T = w.shape
    o = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return o.reshape(B, S, Hkv * G * v.shape[-1])


def _softmax_masked(scores, mask):
    neg = torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device)
    return torch.softmax(torch.where(mask, scores, neg), dim=-1)


def _chunked_gqa_attention(q, k, v, scale, *, causal=True, window=None, chunk=512):
    """Flash-style running-softmax attention over KV chunks of ``chunk``
    keys (plain torch: the reference's ``lax.scan`` is no Pallas kernel).
    q: (B,S,H,hd); k/v: (B,T,Hkv,hd) -> (B,S,H*hd) in q's dtype."""
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    C = min(chunk, T)
    if T % C:
        raise ValueError(f"chunked attention: {T} keys not a multiple of the chunk {C}")
    qr = q.reshape(B, S, Hkv, G, hd)
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, G, S, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, S, hd), dtype=torch.float32, device=q.device)
    neg = torch.full((), NEG_INF, device=q.device)
    for j in range(T // C):
        kc, vc = k[:, j * C:(j + 1) * C], v[:, j * C:(j + 1) * C]
        s = torch.einsum("bskgd,btkd->bkgst", qr.float(), kc.float()) * scale
        k_pos = j * C + torch.arange(C, device=q.device)
        mask = torch.ones((S, C), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgst,btkd->bkgsd", p.to(vc.dtype), vc).float()
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H * hd).to(q.dtype)


def causal_mask(S: int, T: int, offset: int = 0, window: Optional[int] = None, device=None):
    """(S, T) boolean mask; query i attends key j iff j <= i + offset
    (and j > i + offset - window for a sliding window)."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m


def swa_route(cfg: ModelConfig, S: int, cross: bool = False, cache=None) -> bool:
    """Whether a pass takes the sliding-window kernel: the reference's
    conditions for its Pallas kernel, exactly."""
    return bool(cfg.attn_impl == "pallas_swa" and cfg.sliding_window and not cross
                and cache is None and S % BQ == 0 and cfg.sliding_window % BK == 0)


# ---------------------------------------------------------------------------
# GQA forward (train / prefill / decode), cross-attention
# ---------------------------------------------------------------------------

def attn_apply(p, cfg: ModelConfig, x, positions, *, cache=None, cache_index=None,
               kv_src=None, cross: bool = False, causal: bool = True):
    """General attention.

    cache=None  -> full pass over x (train/prefill); a self-attention pass
                   returns the roped (k, v) as the new cache (a fresh
                   cross pass its k/v).
    cache given -> decode: x is (B,1,D) at position ``cache_index`` (an
                   int); its k/v are written into ``cache`` in place (slot
                   index % T under a sliding window: a ring buffer), and
                   the same cache is returned.  (The reference returns an
                   updated copy.)
    cross=True  -> cross-attention onto ``kv_src`` (B,T,D): no RoPE, every
                   key attended; with a cache the precomputed k/v are read
                   from it and nothing is written.
    positions are (B, S), or (3, B, S) under M-RoPE.  Returns (out, new_cache).
    """
    cross = cross or kv_src is not None
    if cfg.mla and not cross:
        return _mla_apply(p, cfg, x, positions, cache=cache, cache_index=cache_index)

    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["w_q"]
    if "b_q" in p:
        q = q + p["b_q"]
    q = q.reshape(B, S, H, hd)
    scale = hd ** -0.5
    fresh_kv = not (cross and cache is not None)
    if fresh_kv:
        src = x if kv_src is None else kv_src
        k, v = src @ p["w_k"], src @ p["w_v"]
        if "b_k" in p:
            k, v = k + p["b_k"], v + p["b_v"]
        k, v = k.reshape(B, src.shape[1], Hkv, hd), v.reshape(B, src.shape[1], Hkv, hd)
    else:  # cross-attention decode: k/v precomputed from the encoder output
        k, v = cache["k"], cache["v"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if fresh_kv:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if not cross:
        if cfg.mrope_sections is not None:
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and not cross:
        T = cache["k"].shape[1]
        index = int(cache_index)
        slot = index % T if cfg.sliding_window is not None else index
        cache["k"][:, slot:slot + S] = k
        cache["v"][:, slot:slot + S] = v
        scores = _gqa_scores(q, cache["k"]) * scale  # (B,Hkv,G,S,T)
        pos = torch.arange(T, device=x.device)
        # ring buffer: slots [0, min(index+1, T)) are valid
        valid = pos < min(index + 1, T) if cfg.sliding_window is not None else pos <= index
        w = _softmax_masked(scores, valid[None, None, None, None, :])
        return _gqa_combine(w, cache["v"]) @ p["w_o"], cache

    T = k.shape[1]
    new_cache = {"k": k, "v": v} if fresh_kv else cache
    if swa_route(cfg, S, cross, cache):
        o = swa_attention_gqa(q, k, v, cfg.sliding_window)  # (B,S,H,hd)
        return o.reshape(B, S, H * hd) @ p["w_o"], new_cache
    if cfg.attn_impl == "chunked" and T % min(cfg.attn_chunk, T) == 0:
        out = _chunked_gqa_attention(q, k, v, scale, causal=causal and not cross,
                                     window=None if cross else cfg.sliding_window,
                                     chunk=cfg.attn_chunk)
        return out @ p["w_o"], new_cache
    scores = _gqa_scores(q, k) * scale
    if causal and not cross:
        mask = causal_mask(S, T, window=cfg.sliding_window, device=x.device)
    else:
        mask = torch.ones((S, T), dtype=torch.bool, device=x.device)
    w = _softmax_masked(scores, mask[None, None, None])
    return _gqa_combine(w, v) @ p["w_o"], new_cache


# ---------------------------------------------------------------------------
# MLA (deepseek-v2)
# ---------------------------------------------------------------------------

def _mla_qkv(p, cfg: ModelConfig, x, positions):
    """-> q_nope (B,S,H,nope), q_rope (B,S,H,rope) roped, the normed latent
    ckv (B,S,c) and the roped shared key part k_rope (B,S,rope)."""
    B, S, _ = x.shape
    nd, rd, c = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    xq = x
    if cfg.q_lora_rank:
        xq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (xq @ p["w_q"]).reshape(B, S, cfg.n_heads, nd + rd)
    q_nope, q_rope = q[..., :nd], apply_rope(q[..., nd:], positions, cfg.rope_theta)
    ckv_full = x @ p["w_dkv"]
    ckv = rms_norm(ckv_full[..., :c], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv_full[..., c:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def _mla_scores(q_nope, q_rope, k_nope, k_rope, scale, absorbed):
    """fp32 scores (B,H,S,T): the no-RoPE part against per-head keys
    (B,T,H,nope), or with W_uk absorbed into q (``absorbed``: q_nope is
    (B,S,H,c), k_nope the latent (B,T,c)), plus the shared RoPE part."""
    eq = "bshc,btc->bhst" if absorbed else "bshd,bthd->bhst"
    return (torch.einsum(eq, q_nope.float(), k_nope.float())
            + torch.einsum("bshd,btd->bhst", q_rope.float(), k_rope.float())) * scale


def _mla_chunked(p, cfg: ModelConfig, q_nope, q_rope, ckv, k_rope, scale):
    """Flash-style causal MLA over latent chunks of ``attn_chunk`` keys with
    W_uk absorbed into q: never materialises (B,H,S,S) scores nor per-head
    k/v; the running accumulator is (B,H,S,c) fp32 and is cast to ckv's
    dtype before W_uv.  -> (B,S,H,v)."""
    B, S, H, _ = q_nope.shape
    C = min(cfg.attn_chunk, S)
    dev = ckv.device
    q_eff = torch.einsum("bshd,hcd->bshc", q_nope, p["w_uk"])
    q_pos = torch.arange(S, device=dev)
    m = torch.full((B, H, S, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, S, ckv.shape[-1]), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    for j in range(S // C):
        kc, rc = ckv[:, j * C:(j + 1) * C], k_rope[:, j * C:(j + 1) * C]
        s = _mla_scores(q_eff, q_rope, kc, rc, scale, absorbed=True)
        k_pos = j * C + torch.arange(C, device=dev)
        s = torch.where(k_pos[None, :] <= q_pos[:, None], s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        pv = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + pv.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhst,btc->bhsc", pv.to(kc.dtype), kc).float()
        m = m_new
    o_lat = (acc / l.clamp_min(1e-30)).to(ckv.dtype)
    return torch.einsum("bhsc,hcd->bshd", o_lat, p["w_uv"])


def _mla_apply(p, cfg: ModelConfig, x, positions, *, cache=None, cache_index=None):
    """MLA on its three routes, each as the reference computes it: per-head
    k/v materialised from the latent under a causal mask (train/prefill),
    the chunked absorbed form (``attn_impl="chunked"``), and decode with
    W_uk/W_uv absorbed over the whole latent cache, written in place at
    ``cache_index``.  Returns (out, the latent cache)."""
    B, S, _ = x.shape
    H, vd = cfg.n_heads, cfg.v_head_dim
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    q_nope, q_rope, ckv, k_rope = _mla_qkv(p, cfg, x, positions)

    if cache is None:
        if cfg.attn_impl == "chunked" and S % min(cfg.attn_chunk, S) == 0:
            o = _mla_chunked(p, cfg, q_nope, q_rope, ckv, k_rope, scale)
        else:
            k_nope = torch.einsum("btc,hcd->bthd", ckv, p["w_uk"])
            v = torch.einsum("btc,hcd->bthd", ckv, p["w_uv"])
            scores = _mla_scores(q_nope, q_rope, k_nope, k_rope, scale, absorbed=False)
            w = _softmax_masked(scores, causal_mask(S, S, device=x.device)[None, None])
            o = torch.einsum("bhst,bthd->bshd", w.to(v.dtype), v)
        return o.reshape(B, S, H * vd) @ p["w_o"], {"ckv": ckv, "krope": k_rope}

    T = cache["ckv"].shape[1]
    index = int(cache_index)
    cache["ckv"][:, index:index + S] = ckv
    cache["krope"][:, index:index + S] = k_rope
    q_eff = torch.einsum("bshd,hcd->bshc", q_nope, p["w_uk"])  # W_uk absorbed: (B,S,H,c)
    scores = _mla_scores(q_eff, q_rope, cache["ckv"], cache["krope"], scale, absorbed=True)
    valid = torch.arange(T, device=x.device) <= index
    w = _softmax_masked(scores, valid[None, None, None, :])
    o_lat = torch.einsum("bhst,btc->bshc", w.to(cache["ckv"].dtype), cache["ckv"])
    o = torch.einsum("bshc,hcd->bshd", o_lat, p["w_uv"])
    return o.reshape(B, S, H * vd) @ p["w_o"], cache
