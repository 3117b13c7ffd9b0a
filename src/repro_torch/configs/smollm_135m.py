"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M]: llama-arch, 30L, d_model 576,
9 heads (GQA kv=3), d_ff 1536, vocab 49152, tied embeddings.

Built, as in the JAX package, with a 4096-token sliding window: the
sub-quadratic dense variant that makes the long_500k decode shape
runnable."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab=49152,
        tie_embeddings=True,
        sliding_window=4096,
        dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=192, n_heads=3, n_kv_heads=3, d_ff=384,
        vocab=512, sliding_window=16, dtype="float32",
    )
