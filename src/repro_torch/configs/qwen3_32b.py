"""Qwen3-32B [hf:Qwen/Qwen3-8B family card; 32B variant dims]:
64L, d_model 5120, 64 heads (GQA kv=8, head_dim 128), d_ff 25600,
vocab 151936, qk-norm."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        dtype="bfloat16",
        remat=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, dtype="float32", remat=False,
    )
