"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``
plus the input-shape suite, the port's copy of the JAX package's
``configs/__init__.py``.  One module per architecture, each citing its
source: the dense SmolLM-135M (sliding window), Qwen3-32B, Qwen2-72B and
Mistral-Large-123B, the MoE Llama4-Maverick-400B-A17B and DeepSeek-V2-236B
(MLA), the VLM Qwen2-VL-72B (M-RoPE), the encoder-decoder Whisper-tiny,
the SSM Mamba2-370M, the hybrid Zamba2-1.2B and the paper's GN-LeNet.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

ARCHS = [
    "qwen3-32b",
    "mamba2-370m",
    "qwen2-72b",
    "mistral-large-123b",
    "whisper-tiny",
    "deepseek-v2-236b",
    "zamba2-1.2b",
    "smollm-135m",
    "llama4-maverick-400b-a17b",
    "qwen2-vl-72b",
    # the paper's own workload
    "gn-lenet",
]
PORTED = tuple(ARCHS)  # every architecture of the reference's registry


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; one of {ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def supports_shape(name: str, shape: str) -> Tuple[bool, str]:
    """Whether (arch, input-shape) is architecturally meaningful.

    long_500k needs sub-quadratic attention (SSM/hybrid state recurrence or
    a sliding-window dense variant); a module's own ``supports_shape``
    (the CNN's) decides for it.  Returns (ok, reason-if-skipped)."""
    m = _module(name)
    if hasattr(m, "supports_shape"):
        return m.supports_shape(shape)
    cfg = get_config(name)
    if shape == "long_500k":
        if cfg.family in ("ssm", "hybrid") or cfg.sliding_window is not None:
            return True, ""
        return False, "full quadratic attention: 512k dense KV cache is architecturally excluded"
    return True, ""
