"""StarCoder2-15B — GQA + RoPE, LayerNorm, GeLU MLP [arXiv:2402.19173]."""

from ..models.config import ModelConfig, ATTN, MLP

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    pattern=((ATTN, MLP),),
    rope_theta=1e5,
    act="gelu",
    norm="layernorm",
    source="arXiv:2402.19173; hf:bigcode/starcoder2-15b",
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=128)
