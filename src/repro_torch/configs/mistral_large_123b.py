"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407]: 88L,
d_model 12288, 96 heads (GQA kv=8), d_ff 28672, vocab 32768."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b",
        family="dense",
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=28672,
        vocab=32768,
        rope_theta=1_000_000.0,
        dtype="bfloat16",
        remat=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=384, n_heads=6, n_kv_heads=2, d_ff=768, vocab=512,
        dtype="float32", remat=False,
    )
