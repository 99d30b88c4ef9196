"""Zamba2-2.7B — Mamba2 backbone + shared attention block [arXiv:2411.15242].

54 Mamba2 layers, d_model=2560, shared transformer block (32 MHA heads,
d_ff=10240) invoked after every 6th Mamba2 block with re-concatenated
embeddings (Zamba2 style).  ssm_state=64.

Simplifications vs. the released checkpoints (noted in DESIGN.md): the
per-invocation LoRA adapters on the shared block are omitted (one truly
shared weight set) and rotary embeddings are used in the shared block.
"""

from ..models.config import ModelConfig, MAMBA2, SHARED_ATTN

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    pattern=((MAMBA2,),) * 5 + ((MAMBA2, SHARED_ATTN),),
    ssm_state=64,
    ssm_expand=2,
    ssm_chunk=256,
    rope_theta=1e4,
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B",
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=128, ssm_state=16, ssm_chunk=16)
