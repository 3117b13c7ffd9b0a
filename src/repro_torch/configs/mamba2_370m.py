"""Mamba2-370M [arXiv:2405.21060]: 48L, d_model 1024, attention-free SSD,
ssm_state 128, vocab 50280."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        d_ff=0,
        vocab=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=256,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=256, ssm_state=32, ssm_headdim=32, ssm_chunk=16,
        vocab=512, dtype="float32",
    )
