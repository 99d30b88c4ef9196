"""Mixtral-8x22B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""

from ..models.config import ModelConfig, SWA, MOE

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    pattern=((SWA, MOE),),
    n_experts=8,
    top_k=2,
    moe_d_ff=16384,
    sliding_window=4096,
    rope_theta=1e6,
    act="swiglu",
    source="arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1",
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, moe_d_ff=128, n_experts=4, top_k=2,
                         vocab=128, sliding_window=16)
