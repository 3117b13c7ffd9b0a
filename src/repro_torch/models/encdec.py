"""Whisper-style encoder-decoder backbone [arXiv:2212.04356], the port of
the JAX package's ``models/encdec.py``.

As in the reference, the mel-spectrogram and conv frontend is a stub: the
inputs are frame embeddings (B, enc_seq, D).  The encoder (non-causal
self-attention with RoPE, a learned ``enc_pos``), the decoder with
cross-attention, and the self and cross KV caches are the reference's:
RMSNorm and SwiGLU blocks, not OpenAI's LayerNorm and GELU.  The layers
are stacked as in the reference and walked with ``transformer.unstack``.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_apply, attn_cache_init, attn_init
from repro_torch.models.common import dense_init, embed_init, mlp_apply, mlp_init, rms_norm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import lm_head, stacked_init, unstack


def _ones(cfg: ModelConfig, device):
    return torch.ones((cfg.d_model,), dtype=cfg.tdtype, device=device)


def enc_block_init(gen: torch.Generator, cfg: ModelConfig):
    return {
        "ln1": _ones(cfg, gen.device),
        "attn": attn_init(gen, cfg),
        "ln2": _ones(cfg, gen.device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.tdtype),
    }


def dec_block_init(gen: torch.Generator, cfg: ModelConfig):
    return {
        "ln1": _ones(cfg, gen.device),
        "attn": attn_init(gen, cfg),
        "lnx": _ones(cfg, gen.device),
        "xattn": attn_init(gen, cfg, cross=True),
        "ln2": _ones(cfg, gen.device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.tdtype),
    }


def encdec_init(gen: torch.Generator, cfg: ModelConfig):
    p = {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), cfg.tdtype),
        "enc_pos": embed_init(gen, (cfg.enc_seq, cfg.d_model), cfg.tdtype),
        "enc_layers": stacked_init(lambda g: enc_block_init(g, cfg), gen, cfg.n_enc_layers),
        "enc_norm": _ones(cfg, gen.device),
        "dec_layers": stacked_init(lambda g: dec_block_init(g, cfg), gen, cfg.n_layers),
        "final_norm": _ones(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.tdtype)
    return p


def _positions(B: int, S: int, device, start: int = 0):
    return torch.arange(start, start + S, device=device)[None, :].expand(B, S)


def encode(params, cfg: ModelConfig, frames):
    """frames: stub frontend embeddings (B, enc_seq, D) -> (B, enc_seq, D)."""
    x = frames + params["enc_pos"][None]
    positions = _positions(frames.shape[0], frames.shape[1], frames.device)
    for p in unstack(params["enc_layers"]):
        a, _ = attn_apply(p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps), positions,
                          causal=False)
        x = x + a
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(p, cfg: ModelConfig, h, positions, enc_out, self_cache=None, cross_cache=None,
               index=None):
    """-> (h, new self cache, new cross cache)."""
    a, new_self = attn_apply(p["attn"], cfg, rms_norm(h, p["ln1"], cfg.norm_eps), positions,
                             cache=self_cache, cache_index=index)
    h = h + a
    xa, new_cross = attn_apply(p["xattn"], cfg, rms_norm(h, p["lnx"], cfg.norm_eps), positions,
                               kv_src=enc_out, cache=cross_cache, cross=True)
    h = h + xa
    return h + mlp_apply(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps)), new_self, new_cross


def decode_train(params, cfg: ModelConfig, frames, tokens):
    """Teacher-forced decoder pass -> logits (B, S, V)."""
    enc_out = encode(params, cfg, frames)
    x = params["embed"][tokens]
    positions = _positions(tokens.shape[0], tokens.shape[1], tokens.device)
    for p in unstack(params["dec_layers"]):
        x, _, _ = _dec_block(p, cfg, x, positions, enc_out)
    return lm_head(params, cfg, rms_norm(x, params["final_norm"], cfg.norm_eps))


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def encdec_cache_init(params, cfg: ModelConfig, frames, batch: int, max_len: int):
    """A zeroed self-attention cache and each decoder layer's cross k/v,
    computed once from the encoder output (as the reference: no bias, no
    k-norm on them)."""
    enc_out = encode(params, cfg, frames)
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    ks, vs = [], []
    for p in unstack(params["dec_layers"]):
        ks.append((enc_out @ p["xattn"]["w_k"]).reshape(batch, -1, Hkv, hd))
        vs.append((enc_out @ p["xattn"]["w_v"]).reshape(batch, -1, Hkv, hd))
    return {
        "self": attn_cache_init(cfg, batch, max_len, layers=cfg.n_layers, device=frames.device),
        "cross": {"k": torch.stack(ks), "v": torch.stack(vs)},
    }


def encdec_cache_specs(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The reference's zero cache of the decode step's shapes (cross k/v
    over ``enc_seq`` positions, all zero)."""
    shp = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
    return {
        "self": attn_cache_init(cfg, batch, max_len, layers=cfg.n_layers, device=device),
        "cross": {"k": torch.zeros(shp, dtype=cfg.tdtype, device=device),
                  "v": torch.zeros(shp, dtype=cfg.tdtype, device=device)},
    }


def encdec_decode(params, cfg: ModelConfig, cache, x, index: int):
    """x: (B,1,D) embedded token at position ``index`` -> (h, cache), the
    self-attention cache updated in place and the cross cache only read."""
    positions = torch.full((x.shape[0], 1), int(index), device=x.device)
    for p, sc, ck, cv in zip(unstack(params["dec_layers"]), unstack(cache["self"]),
                             unstack(cache["cross"]["k"]), unstack(cache["cross"]["v"])):
        x, _, _ = _dec_block(p, cfg, x, positions, None, self_cache=sc,
                             cross_cache={"k": ck, "v": cv}, index=index)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache
