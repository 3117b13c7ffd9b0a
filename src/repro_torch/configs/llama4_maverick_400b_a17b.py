"""Llama4-Maverick-400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family]:
48L, d_model 5120, 40 heads (GQA kv=8), MoE 128 experts top-1 + 1 shared
expert (d_expert 8192), alternating dense/MoE layers, vocab 202048.
Early-fusion multimodality: the text backbone only (frontend out of scope
for this entry; the VLM stub pattern is exercised by qwen2-vl-72b)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab=202048,
        n_experts=128,
        n_shared_experts=1,
        moe_top_k=1,
        d_expert=8192,
        moe_every=2,          # alternating dense / MoE
        dtype="bfloat16",
        remat=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512, vocab=512,
        n_experts=4, n_shared_experts=1, moe_top_k=1, d_expert=128,
        dtype="float32", remat=False,
    )
