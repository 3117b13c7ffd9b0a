"""Whisper-tiny [arXiv:2212.04356]: enc-dec, 4+4L, d_model 384, 6 heads,
d_ff 1536, vocab 51865; conv/mel frontend is a STUB (input_specs provides
frame embeddings (B, 1500, 384))."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="encdec",
        n_layers=4,
        n_enc_layers=4,
        enc_seq=1500,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab=51865,
        tie_embeddings=True,
        stub_frontend=True,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, n_enc_layers=2, enc_seq=64, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab=512, dtype="float32",
    )
