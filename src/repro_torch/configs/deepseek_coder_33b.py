"""DeepSeek-Coder 33B — llama-arch dense decoder [arXiv:2401.14196]."""

from ..models.config import ModelConfig, ATTN, MLP

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    pattern=((ATTN, MLP),),
    rope_theta=1e5,
    act="swiglu",
    source="arXiv:2401.14196; hf:deepseek-ai/deepseek-coder-33b-base",
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                         d_ff=128, vocab=128)
