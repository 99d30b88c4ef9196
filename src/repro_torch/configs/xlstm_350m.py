"""xLSTM-350M — sLSTM + mLSTM blocks [arXiv:2405.04517].

24 blocks, d_model=1024, 4 heads, vocab=50304, d_ff=0 (the xLSTM blocks
carry their own projection FFNs: mLSTM proj factor 2, sLSTM 4/3).
Interleave: one sLSTM block per 4 (xLSTM[7:1]-style mix rounded to the
pattern unit).
"""

from ..models.config import ModelConfig, SLSTM, MLSTM

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=((MLSTM,), (MLSTM,), (MLSTM,), (SLSTM,)),
    mlstm_proj_factor=2.0,
    slstm_proj_factor=4.0 / 3.0,
    ssm_chunk=256,
    source="arXiv:2405.04517 (unverified tier)",
)


def smoke() -> ModelConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                         vocab=128, ssm_chunk=16)
