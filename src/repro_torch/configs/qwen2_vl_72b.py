"""Qwen2-VL-72B [arXiv:2409.12191]: qwen2-72b dims (80L, d_model 8192,
64H GQA kv=8, d_ff 29568, vocab 152064) + M-RoPE (sections 16/24/24 over
head_dim/2) and dynamic-resolution vision via a STUB frontend —
input_specs supplies pre-projected patch embeddings interleaved with text."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab=152064,
        qkv_bias=True,
        mrope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        stub_frontend=True,
        dtype="bfloat16",
        remat=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512, vocab=512,
        mrope_sections=(8, 4, 4), dtype="float32", remat=False,
    )
