"""Mixture-of-Experts layer, the port of the JAX package's
``models/moe.py``: a token-choice top-k router with renormalised gates,
capacity-based dispatch by a stable sort (no O(T·E·C) one-hots), the
per-expert SwiGLU over experts stacked on a leading E axis, a scatter-add
combine, shared experts and the Switch load-balance loss.

Every shape is static (T, E and the capacity C follow from the config and
the input's shape), so the layer runs under ``torch.func.vmap(grad(...))``:
the expert counts and the dispatch are out-of-place ``scatter_add`` and
``scatter`` onto a padded slot where the reference's ``bincount`` and
``.at[...].set(mode="drop")`` discard out-of-range writes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.models.config import ModelConfig


def moe_init(gen: torch.Generator, cfg: ModelConfig):
    d, dff, E, dt = cfg.d_model, cfg.d_expert or cfg.d_ff, cfg.n_experts, cfg.tdtype
    p = {
        "router": dense_init(gen, (d, E), dt, scale=d**-0.5),
        "w_gate": dense_init(gen, (E, d, dff), dt),
        "w_up": dense_init(gen, (E, d, dff), dt),
        "w_down": dense_init(gen, (E, dff, d), dt),
    }
    if cfg.n_shared_experts:
        ds = dff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, (d, ds), dt),
            "w_up": dense_init(gen, (d, ds), dt),
            "w_down": dense_init(gen, (ds, d), dt),
        }
    return p


def _capacity(T: int, top_k: int, E: int, factor: float) -> int:
    """Slots per expert: T·k/E·factor, rounded up to a multiple of 8 (at
    least 8)."""
    c = int(T * top_k / E * factor)
    return max(8, -(-c // 8) * 8)


def moe_apply(p, cfg: ModelConfig, x):
    """x: (B, S, D) -> (out (B, S, D), aux_loss fp32 scalar)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    T = B * S
    dev = x.device
    xt = x.reshape(T, D)
    C = _capacity(T, k, E, cfg.capacity_factor)

    logits = (xt @ p["router"]).float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # aux load-balance loss (Switch): the token fractions are counts of
    # integer choices, so they carry no gradient
    flat_e = expert_idx.reshape(-1)                       # (T*k,)
    ones = torch.ones(flat_e.shape, dtype=torch.float32, device=dev)
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).scatter_add(0, flat_e, ones) / (T * k)
    aux = cfg.aux_loss_coef * E * torch.sum(probs.mean(0) * ce)

    # capacity dispatch: group the (token, choice) entries by expert with a
    # stable sort; an entry's slot is its position in its expert's group
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_g = gate_vals.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    st, sg = flat_t.gather(0, order), flat_g.gather(0, order)
    counts = torch.zeros((E,), dtype=torch.int64, device=dev).scatter_add(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * k, device=dev) - starts.gather(0, se)
    # entries past capacity go to slot E*C, a pad slot cut off below
    slot = torch.where(pos_in_e < C, se * C + pos_in_e, torch.full_like(se, E * C))

    # token per (expert, slot); an empty slot holds T, the zero pad row
    dispatch_tok = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev).scatter(
        0, slot, st)[:E * C]
    gate_per_slot = torch.zeros((E * C + 1,), dtype=torch.float32, device=dev).scatter(
        0, slot, sg)[:E * C]

    x_pad = torch.cat([xt, xt.new_zeros((1, D))], 0)
    xg = x_pad.index_select(0, dispatch_tok).reshape(E, C, D)

    # expert FFN over the stacked experts
    h = F.silu(torch.einsum("ecd,edf->ecf", xg, p["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", xg, p["w_up"])
    yo = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(E * C, D)

    # combine: scatter-add back to tokens (the pad row T takes the empty slots)
    yw = yo * gate_per_slot[:, None].to(yo.dtype)
    out = torch.zeros((T + 1, D), dtype=yo.dtype, device=dev).scatter_add(
        0, dispatch_tok[:, None].expand(E * C, D), yw)[:T]

    if cfg.n_shared_experts:
        sp = p["shared"]
        hs = F.silu(xt @ sp["w_gate"]) * (xt @ sp["w_up"])
        out = out + hs @ sp["w_down"]
    return out.reshape(B, S, D), aux
