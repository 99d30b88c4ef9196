"""Model / run configuration dataclasses.

One :class:`ModelConfig` describes any architecture in the assigned pool via
a *block pattern*: a repeating unit of block kinds (attention, SWA, MLP, MoE,
Mamba2, sLSTM, mLSTM, shared attention) applied pre-norm with residual
connections.  `configs/<arch>.py` instantiates the exact published
configurations.

The port's copy of ``repro/models/config.py``: the same fields, block kinds
and shape cells; only :attr:`ModelConfig.activation_dtype` differs, as a
``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

# Block kinds
ATTN = "attn"              # global GQA attention
SWA = "swa"                # sliding-window GQA attention
SHARED_ATTN = "shared_attn"  # Zamba2-style: one shared weight set, reused
MLP = "mlp"                # SwiGLU / GeLU MLP
MOE = "moe"                # top-k mixture of experts
MAMBA2 = "mamba2"          # state-space dual (SSD) block
SLSTM = "slstm"            # xLSTM scalar-memory block (sequential recurrence)
MLSTM = "mlstm"            # xLSTM matrix-memory block (chunkwise parallel)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # Block pattern: the repeating unit; len(pattern)*repeats == n_layers.
    # Each entry is a tuple of block kinds executed inside one "layer".
    pattern: Tuple[Tuple[str, ...], ...] = ((ATTN, MLP),)

    # attention
    d_head: Optional[int] = None     # default d_model // n_heads
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    causal: bool = True              # False for encoder-only architectures

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_heads: int = 0               # Mamba2 heads; default d_inner // 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # xLSTM
    slstm_proj_factor: float = 4.0 / 3.0
    mlstm_proj_factor: float = 2.0

    # frontends ([audio]/[vlm] are stubs: precomputed embeddings)
    frontend: Optional[str] = None   # None | "audio" | "vlm"
    n_patches: int = 256             # vlm: image patch positions

    # MLP activation
    act: str = "swiglu"              # swiglu | gelu

    # numerics
    dtype: str = "bfloat16"
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # citation
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else \
            self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            (self.name, self.n_layers, len(self.pattern))
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    def scaled(self, **kw) -> "ModelConfig":
        """A reduced copy for smoke tests (same family/pattern, tiny dims)."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """Assignment rules: encoder-only archs skip decode shapes; long_500k
    runs only for architectures with sub-quadratic sequence mixing
    (SSM/hybrid); full-attention archs skip it (see DESIGN.md)."""
    shapes = [TRAIN_4K, PREFILL_32K]
    if cfg.causal:  # decoder: has a decode step
        shapes.append(DECODE_32K)
        if cfg.family in ("ssm", "hybrid"):
            shapes.append(LONG_500K)
    return tuple(shapes)
