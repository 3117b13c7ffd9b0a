"""Analytic fused-HBM model for the memory roofline term, the port of the
JAX package's ``launch/analytic.py`` term for term.

The dry run's byte counter adds every eager op's operands and results
*unfused*: an upper bound that cannot show fusion wins (a flash-attention
rewrite keeps the same unfused count while deleting the HBM traffic on
real hardware).  This module gives the complementary *lower-bound-ish*
estimate: what a well-fused program actually moves.

Counted per device (tp = model-parallel degree; the port's dry run, all
on one card, calls it with tp=1), train mode:

  params     read fwd + read remat-fwd + grad write+read + update write
  activations L x T x d x K boundary tensors (written fwd, read bwd;
             K ~ 8 post-fusion layer boundaries: x2 residual, qkvo, mlp in/out)
  attention  naive: the O(S^2) score/prob tensors (fp32 write + read, fwd
             and bwd) — this is the term chunked/flash attention deletes;
             chunked: ~0 extra (scores stay on chip)
  MoE        dispatch gather + combine scatter (E*C*d in/out per MoE layer)
  decode     weights streamed once per step + KV/state cache read+write

All terms are per *node*, divided by tp (activations/params are sharded).
This is a model, not a measurement.
"""
from __future__ import annotations

from repro_torch.configs import INPUT_SHAPES
from repro_torch.models.api import active_param_count, param_count
from repro_torch.models.config import ModelConfig

ACT_BOUNDARY_TENSORS = 8


def fused_hbm_bytes(cfg: ModelConfig, shape_name, n_nodes: int,
                    tp: int = 16) -> float:
    """``shape_name``: a name of ``INPUT_SHAPES`` or an ``InputShape``."""
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    b = cfg.tdtype.itemsize
    P = param_count(cfg)
    p_dev = P * b / tp
    B_node = max(shape.global_batch // n_nodes, 1)
    S = shape.seq_len
    L = cfg.n_layers
    d = cfg.d_model

    if shape.mode == "decode":
        # one token: stream active weights once + cache read/write
        pa = active_param_count(cfg) * b / tp
        if cfg.family in ("ssm", "hybrid"):
            cache = L * B_node * cfg.ssm_nheads * cfg.ssm_state * cfg.ssm_headdim * 4
        elif cfg.mla:
            cache = L * B_node * S * (cfg.kv_lora_rank + cfg.qk_rope_dim) * b
        else:
            eff = min(S, cfg.sliding_window or S)
            cache = L * B_node * eff * cfg.n_kv_heads * cfg.hd * b * 2
        return pa + 2.0 * cache / tp

    T = B_node * S  # tokens per node
    passes = 1.0 if shape.mode == "prefill" else (3.0 if cfg.remat else 2.0)
    grad_traffic = 0.0 if shape.mode == "prefill" else 3.0 * p_dev  # g w+r, upd w
    params = passes * p_dev + grad_traffic

    acts_factor = 2.0 if shape.mode == "prefill" else (4.0 if cfg.remat else 3.0)
    acts = L * T * d * b * ACT_BOUNDARY_TENSORS * acts_factor / tp

    attn = 0.0
    if cfg.family not in ("ssm",) and cfg.attn_impl == "naive":
        eff = min(S, cfg.sliding_window or S)
        heads = cfg.n_heads
        n_attn = L if cfg.family != "hybrid" else max(cfg.n_layers // max(cfg.attn_every, 1), 1)
        per_layer = B_node * heads * S * eff * 4 * 2  # scores + probs, fp32
        mult = 2.0 if shape.mode == "prefill" else (6.0 if cfg.remat else 4.0)
        attn = n_attn * per_layer * mult / tp

    moe = 0.0
    if cfg.n_experts:
        n_moe = (cfg.n_layers - cfg.first_dense) // cfg.moe_every
        C = T * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor
        per_layer = cfg.n_experts * C * d * b * 4  # gather in + ffn out + scatter
        mult = 1.0 if shape.mode == "prefill" else (3.0 if cfg.remat else 2.0)
        moe = n_moe * per_layer * mult / tp

    ssm = 0.0
    if cfg.family in ("ssm", "hybrid"):
        nc = S // cfg.ssm_chunk
        states = B_node * nc * cfg.ssm_nheads * cfg.ssm_state * cfg.ssm_headdim * 4 * 2
        mult = 1.0 if shape.mode == "prefill" else (3.0 if cfg.remat else 2.0)
        ssm = L * states * mult / tp

    return params + acts + attn + moe + ssm
