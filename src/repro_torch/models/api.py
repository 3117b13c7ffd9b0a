"""Unified model API across the ported families, the port of the JAX
package's ``models/api.py``: ``init_params / forward / loss_fn /
init_cache / prefill / decode_step`` dispatch on ``cfg.family`` (dense,
moe, ssm, hybrid; cnn for ``init_params`` and ``forward``).  The encdec
and vlm families raise ``NotImplementedError`` until their slices
(ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import torch

from repro_torch.models import cnn as _cnn
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
_TRANSFORMER = ("dense", "moe")
_LM = _TRANSFORMER + _RECURRENT


def _family(cfg: ModelConfig, allowed) -> str:
    if cfg.family not in allowed:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 8); "
            f"ported here: {', '.join(allowed)}")
    return cfg.family


# ---------------------------------------------------------------------------
# init / forward / loss
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters drawn from ``gen``, on its device."""
    cfg.validate()
    fam = _family(cfg, ("cnn",) + _LM)
    if fam == "cnn":
        return _cnn.cnn_init(gen, num_classes=cfg.vocab, dtype=cfg.tdtype)
    if fam in _RECURRENT:
        return _hybrid.hybrid_init(gen, cfg)
    return transformer_init(gen, cfg)


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device)[None, :].expand(B, S)


def forward(params, cfg: ModelConfig, batch):
    """-> (logits, aux_loss).  ``batch["tokens"]`` (B, S) (``"images"`` for
    the cnn family)."""
    fam = _family(cfg, ("cnn",) + _LM)
    if fam == "cnn":
        logits = _cnn.cnn_apply(params, batch["images"])
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = _positions(B, S, tokens.device)
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
    """Zeroed KV / state cache."""
    if _family(cfg, _LM) in _RECURRENT:
        return _hybrid.hybrid_cache_init(cfg, batch, max_len, device=device)
    return transformer_cache_init(cfg, batch, max_len, device=device)


def prefill(params, cfg: ModelConfig, batch, max_len: int):
    """The serving prefill of the transformer families (dense, moe): one
    full pass that returns (last-position logits (B,V), populated cache).
    Decode continues from index = S.  (Recurrent families prefill token by
    token through :func:`decode_step`.)"""
    _family(cfg, _TRANSFORMER)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens]
    h, cache = transformer_prefill(params, cfg, x, _positions(B, S, tokens.device), max_len)
    return lm_head(params, cfg, h[:, -1]), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, index: int):
    """tokens (B, 1) int; index: the int position. -> (logits (B,1,V), cache)."""
    x = params["embed"][tokens]
    if _family(cfg, _LM) in _RECURRENT:
        h, new_cache = _hybrid.hybrid_decode(params, cfg, cache, x, index)
    else:
        h, new_cache = transformer_decode(params, cfg, cache, x, index)
    return lm_head(params, cfg, h), new_cache


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
