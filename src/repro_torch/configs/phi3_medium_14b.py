"""Phi-3-medium 14B — dense decoder, RoPE + SwiGLU + GQA [arXiv:2404.14219]."""

from ..models.config import ModelConfig, ATTN, MLP

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    pattern=((ATTN, MLP),),
    rope_theta=1e4,
    act="swiglu",
    source="arXiv:2404.14219 (unverified tier)",
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=128)
