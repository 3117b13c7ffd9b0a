"""DeepSeek-V2-236B [arXiv:2405.04434]: 60L, d_model 5120, 128 heads with
MLA (kv_lora 512, q_lora 1536, qk_nope 128, qk_rope 64, v 128), MoE with
2 shared + 160 routed experts top-6 (d_expert 1536), first layer dense
(d_ff 12288), vocab 102400."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,           # dense (first) layer FFN
        vocab=102400,
        mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        n_experts=160,
        n_shared_experts=2,
        moe_top_k=6,
        d_expert=1536,
        moe_every=1,
        first_dense=1,
        dtype="bfloat16",
        remat=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
        kv_lora_rank=64, q_lora_rank=96, qk_nope_dim=32, qk_rope_dim=16,
        v_head_dim=32, n_experts=4, n_shared_experts=1, moe_top_k=2,
        d_expert=128, dtype="float32", remat=False,
    )
