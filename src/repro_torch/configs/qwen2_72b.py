"""Qwen2-72B [arXiv:2407.10671]: 80L, d_model 8192, 64 heads (GQA kv=8),
d_ff 29568, vocab 152064, QKV bias."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        dtype="bfloat16",
        remat=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=512, vocab=512,
        dtype="float32", remat=False,
    )
