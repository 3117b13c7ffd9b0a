"""Model configuration: the port's copy of the JAX package's
``models/config.py`` with the same fields, so one config means the same
model in both packages.

In the port, ``attn_impl="pallas_swa"`` selects the hand-written CUDA
sliding-window attention kernel (``kernels/swa_attention.py``) and
``ssm_impl="pallas"`` the hand-written CUDA SSD chunk kernel
(``kernels/ssd_chunk.py``); the names stay as the reference spells them.
``ssm_impl="jnp"`` is the plain torch form.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    # -- core transformer dims ------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    # -- attention options ----------------------------------------------------
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen2
    attn_impl: str = "naive"       # naive | chunked (flash-style, O(S·C) memory)
    #                                | pallas_swa (CUDA sliding-window kernel;
    #                                  requires sliding_window set)
    attn_chunk: int = 512          # kv-chunk for attn_impl='chunked'
    ssm_impl: str = "jnp"          # jnp (plain torch) | pallas (CUDA SSD chunk kernel)
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # sub-quadratic dense variant
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    # -- MLA (deepseek-v2) ----------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # -- MoE --------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 1
    d_expert: Optional[int] = None  # expert FFN hidden size (default d_ff)
    moe_every: int = 1              # an MoE layer every k-th layer (llama4: 2)
    first_dense: int = 0            # leading dense layers
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # -- SSM (mamba2 SSD) ------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # -- hybrid (zamba2) ---------------------------------------------------
    attn_every: int = 0  # shared attention block applied every k SSM layers
    # -- enc-dec (whisper) -------------------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 0
    # -- embeddings / misc -------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "float32"          # compute/param dtype
    remat: bool = False             # accepted, memory only: torch.utils.checkpoint cannot run
    #                                 under the trainer's torch.func transforms, so
    #                                 activations are kept (values unchanged)
    remat_policy: str = "full"
    scan_unroll: bool = False       # kept for config parity; layers are a Python loop
    # -- frontend stubs -----------------------------------------------------
    stub_frontend: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        """The parameter and activation dtype as a torch dtype."""
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        """The reference's checks, raised as ``ValueError``."""
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("GQA group size: n_heads must be a multiple of n_kv_heads")
        if self.family in ("ssm", "hybrid") and not (
                self.ssm_state > 0 and self.d_inner % self.ssm_headdim == 0):
            raise ValueError("SSM: ssm_state > 0 and d_inner a multiple of ssm_headdim")
        if self.family == "moe" and not (self.n_experts > 0 and self.moe_top_k >= 1):
            raise ValueError("MoE: n_experts > 0 and moe_top_k >= 1")
        if self.family == "encdec" and not (self.n_enc_layers > 0 and self.enc_seq > 0):
            raise ValueError("enc-dec: n_enc_layers > 0 and enc_seq > 0")
        if self.mrope_sections is not None and sum(self.mrope_sections) != self.hd // 2:
            raise ValueError("M-RoPE sections cover half head_dim")
