"""Unified model API across the model families, the port of the JAX
package's ``models/api.py``: ``init_params / forward / loss_fn /
init_cache / prefill / decode_step`` dispatch on ``cfg.family`` (dense,
moe, vlm, encdec, ssm, hybrid; cnn for ``init_params`` and ``forward``);
``param_specs`` and ``cache_specs`` give the reference's tensor-parallel
partition specs as plain tuples, and the counts (``param_count``,
``active_param_count``, ``model_flops``) come from shapes alone.
The VLM's and Whisper's frontends are stubs, as in the reference:
``batch["embeddings"]`` (with optional (3, B, S) M-RoPE
``batch["positions"]``) and ``batch["frames"]`` stand in for them.
"""
from __future__ import annotations

import math
import re

import torch

from repro_torch.models import cnn as _cnn
from repro_torch.models import encdec as _encdec
from repro_torch.models import hybrid as _hybrid
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    lm_head,
    transformer_apply,
    transformer_cache_init,
    transformer_decode,
    transformer_init,
    transformer_prefill,
)
from repro_torch.utils.pytree import tree_size

_RECURRENT = ("ssm", "hybrid")
_TRANSFORMER = ("dense", "moe", "vlm")
_LM = _TRANSFORMER + _RECURRENT + ("encdec",)


def _family(cfg: ModelConfig, allowed, what: str) -> str:
    if cfg.family not in allowed:
        raise ValueError(f"{what} takes the families {', '.join(allowed)}, not {cfg.family!r}")
    return cfg.family


# ---------------------------------------------------------------------------
# init / forward / loss
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters drawn from ``gen``, on its device."""
    cfg.validate()
    fam = _family(cfg, ("cnn",) + _LM, "init_params")
    if fam == "cnn":
        return _cnn.cnn_init(gen, num_classes=cfg.vocab, dtype=cfg.tdtype)
    if fam in _RECURRENT:
        return _hybrid.hybrid_init(gen, cfg)
    if fam == "encdec":
        return _encdec.encdec_init(gen, cfg)
    return transformer_init(gen, cfg)  # dense / moe / vlm


def _positions(cfg: ModelConfig, B: int, S: int, device):
    """0..S-1 for each row: (B, S), or the same in all three streams,
    (3, B, S), under M-RoPE."""
    pos = torch.arange(S, device=device)
    if cfg.mrope_sections is not None:
        return pos[None, None, :].expand(3, B, S)
    return pos[None, :].expand(B, S)


def _embedded(params, cfg: ModelConfig, batch):
    """(x (B,S,D), positions): the VLM stub frontend's
    ``batch["embeddings"]`` (and ``batch["positions"]`` where given), else
    the embedded ``batch["tokens"]``."""
    if "embeddings" in batch:
        x = batch["embeddings"]
        if batch.get("positions") is not None:
            return x, batch["positions"]
        return x, _positions(cfg, x.shape[0], x.shape[1], x.device)
    tokens = batch["tokens"]
    return params["embed"][tokens], _positions(cfg, *tokens.shape, tokens.device)


def forward(params, cfg: ModelConfig, batch):
    """-> (logits, aux_loss).  ``batch["tokens"]`` (B, S); ``"images"`` for
    the cnn family, ``"frames"`` (B, enc_seq, D) besides the tokens for
    encdec, ``"embeddings"`` (B, S, D) in place of the tokens for the VLM."""
    fam = _family(cfg, ("cnn",) + _LM, "forward")
    if fam == "cnn":
        logits = _cnn.cnn_apply(params, batch["images"])
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
    if fam == "encdec":
        logits = _encdec.decode_train(params, cfg, batch["frames"], batch["tokens"])
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
    x, positions = _embedded(params, cfg, batch)
    if fam in _RECURRENT:
        h, aux = _hybrid.hybrid_apply(params, cfg, x, positions)
    else:
        h, aux = transformer_apply(params, cfg, x, positions)
    return lm_head(params, cfg, h), aux


def cross_entropy(logits, labels, ignore: int = -1):
    """Mean CE over valid labels. logits (..., V), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    valid = labels != ignore
    ce = torch.where(valid, lse - gold, torch.zeros_like(lse))
    return ce.sum() / valid.sum().clamp(min=1)


def loss_fn(params, cfg: ModelConfig, batch):
    logits, aux = forward(params, cfg, batch)
    return cross_entropy(logits, batch["labels"]) + aux


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zeroed KV / state cache (for encdec the reference's zero cache,
    cross k/v included: ``encdec.encdec_cache_init`` computes the real
    cross k/v from the frames)."""
    fam = _family(cfg, _LM, "init_cache")
    if fam in _RECURRENT:
        return _hybrid.hybrid_cache_init(cfg, batch, max_len, device=device)
    if fam == "encdec":
        return _encdec.encdec_cache_specs(cfg, batch, max_len, device=device)
    return transformer_cache_init(cfg, batch, max_len, device=device)


def prefill(params, cfg: ModelConfig, batch, max_len: int):
    """The serving prefill of the transformer families (dense, moe, vlm):
    one full pass over ``batch["tokens"]`` (or the VLM's
    ``batch["embeddings"]``) that returns (last-position logits (B,V),
    populated cache).  Decode continues from index = S.  (The recurrent
    and encdec families prefill token by token through
    :func:`decode_step`.)"""
    _family(cfg, _TRANSFORMER, "prefill")
    x, positions = _embedded(params, cfg, batch)
    h, cache = transformer_prefill(params, cfg, x, positions, max_len)
    return lm_head(params, cfg, h[:, -1]), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, index: int):
    """tokens (B, 1) int; index: the int position. -> (logits (B,1,V), cache)."""
    fam = _family(cfg, _LM, "decode_step")
    x = params["embed"][tokens]
    if fam in _RECURRENT:
        h, new_cache = _hybrid.hybrid_decode(params, cfg, cache, x, index)
    elif fam == "encdec":
        h, new_cache = _encdec.encdec_decode(params, cfg, cache, x, index)
    else:
        h, new_cache = transformer_decode(params, cfg, cache, x, index)
    return lm_head(params, cfg, h), new_cache


# ---------------------------------------------------------------------------
# partition specs (tensor-parallel over the 'model' mesh axis)
# ---------------------------------------------------------------------------

_RULES = [
    # (regex on dotted path, base rank, spec for the trailing base dims)
    (r"embed$", 2, ("model", None)),
    (r"enc_pos$", 2, (None, None)),
    (r"lm_head$", 2, (None, "model")),
    (r"(w_q|w_k|w_v)$", 2, (None, "model")),
    (r"(b_q|b_k|b_v)$", 1, ("model",)),
    (r"w_o$", 2, ("model", None)),
    (r"w_dq$", 2, (None, None)),
    (r"w_dkv$", 2, (None, None)),
    (r"(w_uk|w_uv)$", 3, ("model", None, None)),
    (r"moe\.router$", 2, (None, "model")),
    (r"moe\.(w_gate|w_up|w_down)$", 3, ("model", None, None)),
    (r"(w_gate|w_up)$", 2, (None, "model")),
    (r"w_down$", 2, ("model", None)),
    (r"in_proj$", 2, (None, "model")),
    (r"conv_w$", 2, (None, "model")),
    (r"conv_b$", 1, ("model",)),
    (r"gate_norm$", 1, ("model",)),
    (r"out_proj$", 2, ("model", None)),
]


def _map_with_path(fn, tree, path=""):
    """``fn(dotted path, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}.{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(cfg: ModelConfig, leading=()):
    """The partition spec of every leaf of ``init_params``' tree, as a
    tuple of mesh-axis names or None per dim (the entries of the
    reference's ``PartitionSpec``).  ``leading`` goes in front of every
    spec (the node axis of the DL layer); stacked layer dims get None."""
    def spec_for(name, leaf):
        for pat, base_rank, base_spec in _RULES:
            if re.search(pat, name):
                return (*leading, *(None,) * (leaf.dim() - base_rank), *base_spec)
        return (*leading, *(None,) * leaf.dim())

    return _map_with_path(spec_for, init_params(cfg, _MetaGenerator()))


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, leading=()):
    """Partition specs (tuples) of the KV / state cache: k/v of rank 4 and
    more, (..., B, S, Hkv, hd), shard their heads over 'model'; every other
    dim is replicated."""
    def spec_for(name, leaf):
        if re.search(r"(\bk$|\bv$|k$|v$)", name) and leaf.dim() >= 4:
            return (*leading, *(None,) * (leaf.dim() - 4), None, "model", None)
        return (*leading, *(None,) * leaf.dim())

    return _map_with_path(spec_for, init_cache(cfg, batch, max_len, device="meta"))


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: inits allocate their
    leaves on the generator's device, so they build shapes only."""

    @property
    def device(self):
        return torch.device("meta")


def param_count(cfg: ModelConfig) -> int:
    """Parameters of ``init_params(cfg, ...)``, counted from shapes alone
    (an init on the ``meta`` device, as the reference counts with
    ``jax.eval_shape``), so a 400B config counts without its memory."""
    return tree_size(init_params(cfg, _MetaGenerator()))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only the top-k routed experts'
    share of each expert leaf), counted from shapes alone."""
    total = 0

    def walk(name, leaf):
        nonlocal total
        n = math.prod(leaf.shape)
        if re.search(r"moe\.(w_gate|w_up|w_down)$", name):
            n = int(n * cfg.moe_top_k / cfg.n_experts)
        total += n

    _map_with_path(walk, init_params(cfg, _MetaGenerator()))
    return total


def model_flops(cfg: ModelConfig, tokens: int, mode: str = "train") -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params."""
    return (6.0 if mode == "train" else 2.0) * active_param_count(cfg) * tokens
