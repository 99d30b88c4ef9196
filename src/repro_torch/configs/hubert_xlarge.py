"""HuBERT X-Large — encoder-only audio transformer backbone
[arXiv:2106.07447].

The CNN feature extractor is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings (B, S, d_model).  Encoder-only ⇒ no
decode shapes.
"""

from ..models.config import ModelConfig, ATTN, MLP

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    pattern=((ATTN, MLP),),
    causal=False,
    act="gelu",
    norm="layernorm",
    frontend="audio",
    source="arXiv:2106.07447 (unverified tier)",
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab=64)
