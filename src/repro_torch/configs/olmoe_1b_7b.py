"""OLMoE-1B-7B — 64-expert top-8 MoE decoder [arXiv:2409.02060]."""

from ..models.config import ModelConfig, ATTN, MOE

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    pattern=((ATTN, MOE),),
    n_experts=64,
    top_k=8,
    moe_d_ff=1024,
    rope_theta=1e4,
    act="swiglu",
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=64, moe_d_ff=64, n_experts=8, top_k=2,
                         vocab=128)
