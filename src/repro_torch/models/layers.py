"""Neural network blocks of the port: norms, RoPE, GQA attention, MLP —
the counterparts of ``repro/models/layers.py`` (``norm_*``, ``rope_*``,
``attn_*``, ``mlp_*``).

Each block is an ``nn.Module`` whose weights keep the JAX package's
orientation ``(d_in, d_out)``, applied as ``x @ w``, so the reference's
parameters load without transposes (:func:`repro_torch.models.model
.params_from_reference`).  Numerics policy as in the reference: weights and
activations in ``cfg.dtype``; norms and RoPE in fp32, cast back.

MoE, Mamba2, mLSTM, sLSTM and the shared-attention block are not ported
yet: :func:`check_supported` raises for a config that uses them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ModelConfig, ATTN, SWA, MLP

Cache = Optional[Dict[str, torch.Tensor]]
SUPPORTED = (ATTN, SWA, MLP)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the first block kind of
    ``cfg.pattern`` that the port does not have yet."""
    for layer in cfg.pattern:
        for kind in layer:
            if kind not in SUPPORTED:
                raise NotImplementedError(
                    f"{cfg.name}: block kind {kind!r} is not ported to "
                    f"repro_torch yet (ported: {', '.join(SUPPORTED)})")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
class Norm(nn.Module):
    """RMSNorm or LayerNorm (``cfg.norm``), fp32 inside, cast back."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.layernorm = cfg.norm == "layernorm"
        self.eps = cfg.norm_eps
        d = cfg.d_model
        self.scale = _param((d,), torch.float32, device)
        if self.layernorm:
            self.bias = _param((d,), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.layernorm:
            mu = xf.mean(dim=-1, keepdim=True)
            var = (xf - mu).square().mean(dim=-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + self.eps)
            y = y * self.scale + self.bias
        else:
            ms = xf.square().mean(dim=-1, keepdim=True)
            y = xf * torch.rsqrt(ms + self.eps) * self.scale
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """positions (...,) -> angles (..., dim // 2) fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    return positions.float()[..., None] * inv


def rope_apply(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Half-split rotation.  x: (B, S, H, D); angles: (B, S, D//2) or
    (S, D//2)."""
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; global or sliding window)
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """GQA attention.  Prefill and training go through
    ``ops.flash_attention`` (the Hopper kernel on the card); a decode step
    attends over the fixed-size cache through ``ops.attention_ref``."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d, dh = cfg.d_model, cfg.head_dim
        H, Hkv = cfg.n_heads, cfg.n_kv_heads
        dt = cfg.activation_dtype
        self.wq = _param((d, H * dh), dt, device)
        self.wk = _param((d, Hkv * dh), dt, device)
        self.wv = _param((d, Hkv * dh), dt, device)
        self.wo = _param((H * dh, d), dt, device)

    def forward(self, x: torch.Tensor, *, angles: torch.Tensor,
                window: Optional[int] = None, cache: Cache = None,
                cache_index: Optional[int] = None,
                impl: Optional[str] = None) -> torch.Tensor:
        """``cache`` is this block's k/v, each (B, T, Hkv, dh), written IN
        PLACE (the JAX package returns updated copies, layers.py:118):
        prefill (no ``cache_index``) writes positions [0, S); a decode step
        writes at ``cache_index`` and then attends over the whole cache."""
        cfg = self.cfg
        B, S, _ = x.shape
        dh, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        q = rope_apply((x @ self.wq).view(B, S, H, dh), angles)
        k = rope_apply((x @ self.wk).view(B, S, Hkv, dh), angles)
        v = (x @ self.wv).view(B, S, Hkv, dh)
        if cache is not None and cache_index is not None:
            cache["k"][:, cache_index:cache_index + S] = k
            cache["v"][:, cache_index:cache_index + S] = v
            o = ops.attention_ref(q, cache["k"], cache["v"], causal=cfg.causal,
                                  window=window,
                                  kv_valid_len=cache_index + S,
                                  q_offset=cache_index)
        else:
            o = ops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                    impl=impl)
            if cache is not None:
                cache["k"][:, :S] = k
                cache["v"][:, :S] = v
        return o.reshape(B, S, H * dh) @ self.wo


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------
class MLPBlock(nn.Module):
    """SwiGLU (``wg``, ``wu``, ``wd``) or tanh-approximated GeLU (``wu``,
    ``wd``), as ``jax.nn.silu`` / ``jax.nn.gelu``."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        dt = cfg.activation_dtype
        self.swiglu = cfg.act == "swiglu"
        if self.swiglu:
            self.wg = _param((d, ff), dt, device)
        self.wu = _param((d, ff), dt, device)
        self.wd = _param((ff, d), dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.swiglu:
            h = F.silu(x @ self.wg) * (x @ self.wu)
        else:
            h = F.gelu(x @ self.wu, approximate="tanh")
        return h @ self.wd
