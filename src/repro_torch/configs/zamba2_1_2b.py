"""Zamba2-1.2B [arXiv:2411.15242]: 38 Mamba2 layers, d_model 2048,
ssm_state 64, one SHARED attention block (32 heads, d_ff 8192) applied
every 6 SSM layers, vocab 32000."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=256,
        attn_every=6,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=5, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        ssm_state=16, ssm_headdim=32, ssm_chunk=16, attn_every=2,
        vocab=512, dtype="float32",
    )
