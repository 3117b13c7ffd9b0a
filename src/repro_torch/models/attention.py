"""Attention: GQA with qk-norm, QKV bias, RoPE and a sliding window, with a
KV cache (ring-buffered under a window).  The port of the GQA half of the
JAX package's ``models/attention.py``; MLA, cross-attention and M-RoPE
raise ``NotImplementedError`` until their slices (ROADMAP Queue 1 item 8).

Layouts, as in the reference: activations (B, S, D); q/k/v (B, S, H, hd);
caches (B, S_max, Hkv, hd).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.swa_attention import BK, BQ, swa_attention_gqa
from repro_torch.models.common import apply_rope, dense_init, rms_norm
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item 8)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg: ModelConfig):
    if cfg.mla:
        raise _unported("MLA attention (deepseek-v2)")
    d, H, Hkv, hd, dt = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.tdtype
    dev = gen.device
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
    under a sliding window it holds at most ``sliding_window`` positions."""
    if cfg.mla:
        raise _unported("the MLA latent cache")
    if cfg.sliding_window is not None:
        max_len = min(max_len, cfg.sliding_window)
    shp = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    if layers is not None:
        shp = (layers, *shp)
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
# GQA forward (train / prefill / decode)
# ---------------------------------------------------------------------------

def attn_apply(p, cfg: ModelConfig, x, positions, *, cache=None, cache_index=None,
               kv_src=None, cross: bool = False, causal: bool = True):
    """Self-attention.

    cache=None  -> full pass over x (train/prefill); returns the roped
                   (k, v) as the new cache.
    cache given -> decode: x is (B,1,D) at position ``cache_index`` (an
                   int); its k/v are written into ``cache`` in place (slot
                   index % T under a sliding window: a ring buffer), and
                   the same cache is returned.  (The reference returns an
                   updated copy.)
    Returns (out, new_cache).
    """
    if cross or kv_src is not None:
        raise _unported("cross-attention (with encdec.py)")
    if cfg.mla:
        raise _unported("MLA attention (deepseek-v2)")
    if cfg.mrope_sections is not None:
        raise _unported("M-RoPE (with the VLM)")

    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = x @ p["w_q"], x @ p["w_k"], x @ p["w_v"]
    if "b_q" in p:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q, k, v = q.reshape(B, S, H, hd), k.reshape(B, S, Hkv, hd), v.reshape(B, S, Hkv, hd)
    scale = hd ** -0.5
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
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

    new_cache = {"k": k, "v": v}
    if swa_route(cfg, S):
        o = swa_attention_gqa(q, k, v, cfg.sliding_window)  # (B,S,H,hd)
        return o.reshape(B, S, H * hd) @ p["w_o"], new_cache
    if cfg.attn_impl == "chunked" and S % min(cfg.attn_chunk, S) == 0:
        out = _chunked_gqa_attention(q, k, v, scale, causal=causal,
                                     window=cfg.sliding_window, chunk=cfg.attn_chunk)
        return out @ p["w_o"], new_cache
    scores = _gqa_scores(q, k) * scale
    if causal:
        mask = causal_mask(S, S, window=cfg.sliding_window, device=x.device)
    else:
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
    w = _softmax_masked(scores, mask[None, None, None])
    return _gqa_combine(w, v) @ p["w_o"], new_cache
