"""Granite-3.0-2B base — dense decoder with GQA, tied embeddings
[hf:ibm-granite/granite-3.0-2b-base]."""

from ..models.config import ModelConfig, ATTN, MLP

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    pattern=((ATTN, MLP),),
    rope_theta=1e4,
    act="swiglu",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=128)
