"""InternVL2-2B — InternViT frontend (stub) + InternLM2-1.8B decoder
[arXiv:2404.16821].

The vision frontend is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings which overwrite the first
``n_patches`` token positions.
"""

from ..models.config import ModelConfig, ATTN, MLP

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    pattern=((ATTN, MLP),),
    rope_theta=1e6,
    act="swiglu",
    frontend="vlm",
    n_patches=256,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-2B",
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=128, n_patches=8)
