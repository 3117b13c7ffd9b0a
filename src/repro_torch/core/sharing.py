"""Sharing module: message content and aggregation.

Strategies act on the node-stacked flat parameter matrix X (N, P) and
return the post-gossip X' with the bytes each node sent this round.  Only
full sharing (D-PSGD) is ported; the sparsified, quantized and secure
strategies are not yet.
"""
from __future__ import annotations

from repro_torch.core.mixing import apply_W

_FULL_NAMES = ("full", "fullsharing", "d-psgd")
_QUANT_NAMES = ("quant", "quantized", "int8")


class FullSharing:
    """Baseline: serialize the full parameter vector (D-PSGD)."""

    def init_state(self, X):
        return ()

    def round(self, X, W, state, key=None, degree=1.0, rnd=0):
        X2 = apply_W(W, X).to(X.dtype)
        return X2, state, degree * X.shape[1] * X.element_size()

    def wire_dtype(self, x_dtype) -> str:
        return str(x_dtype).replace("torch.", "")

    def stage_bytes_per_round(self, n: int, p: int) -> int:
        return n * p * 4  # the fp32 mixing operand itself


def strategy_takes_budget(name: str) -> bool:
    """Whether ``name`` is a sparsified strategy parameterized by a budget."""
    return name.lower() not in _FULL_NAMES + _QUANT_NAMES


def is_full_sharing(name: str) -> bool:
    """Whether ``name`` aliases plain full sharing (D-PSGD)."""
    return name.lower() in _FULL_NAMES


def make_sharing(name: str, budget=None, **kw):
    """Build a sharing strategy by name (only full sharing is ported)."""
    name_l = name.lower()
    if name_l in _FULL_NAMES:
        if budget is not None or kw:
            raise ValueError(
                f"sharing strategy {name!r} shares every coordinate; "
                f"'budget' and {sorted(kw)} do not apply"
            )
        return FullSharing()
    if name_l in _QUANT_NAMES or name_l in ("randomk", "random", "topk", "choco",
                                             "choco-sgd", "chocosgd"):
        raise NotImplementedError(f"sharing strategy {name!r} is not ported yet")
    raise ValueError(f"unknown sharing strategy {name!r}")
