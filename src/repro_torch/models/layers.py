"""Neural network blocks of the port: norms, RoPE, GQA attention, MLP, the
Mamba2 (SSD) block and Zamba2's shared attention block — the counterparts
of ``repro/models/layers.py`` (``norm_*``, ``rope_*``, ``attn_*``,
``mlp_*``, ``mamba2_*``, ``shared_attn_*``).

Each block is an ``nn.Module`` whose weights keep the JAX package's
orientation ``(d_in, d_out)``, applied as ``x @ w``, so the reference's
parameters load without transposes (:func:`repro_torch.models.model
.params_from_reference`).  Numerics policy as in the reference: weights and
activations in ``cfg.dtype``; norms and RoPE in fp32, cast back.

MoE, mLSTM and sLSTM are not ported yet: :func:`check_supported` raises
for a config that uses them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ModelConfig, ATTN, SWA, MLP, MAMBA2, SHARED_ATTN

Cache = Optional[Dict[str, torch.Tensor]]
SUPPORTED = (ATTN, SWA, MLP, MAMBA2, SHARED_ATTN)


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


# ---------------------------------------------------------------------------
# Mamba2 block (SSD)
# ---------------------------------------------------------------------------
def _silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, rounding twice in bf16 as ``jax.nn.silu``
    does (``F.silu`` rounds once)."""
    return x * torch.sigmoid(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv (``layers.py`` ``_causal_conv``): x (B, S, C),
    w (K, C), the previous K-1 inputs ``tail`` (B, K-1, C) or None (zeros).
    Returns (y, the last K-1 inputs); the K products are summed in order
    in x's dtype."""
    K = w.shape[0]
    S = x.shape[1]
    if tail is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return y + b.to(x.dtype), xp[:, S:]


class Mamba2(nn.Module):
    """The Mamba2 block: projections, causal conv, SSD scan, gated RMSNorm.
    Prefill runs the chunked scan through ``ops.mamba2_ssd`` (the Hopper
    kernel on the card); a decode step is ``ops.ssd_decode_step``.

    Numerics as the reference's: ``dt = softplus(x @ wdt + dt_bias)`` in
    fp32, cast to the activation dtype before the scan but kept fp32 in
    the decode step; ``A = -exp(A_log)``; ``y += xh * D`` in the
    activation dtype; the gated RMSNorm ``norm(y * silu(z)) * gn`` in
    fp32."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d, din, n, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, \
            cfg.n_ssm_heads
        dt, f32 = cfg.activation_dtype, torch.float32
        conv_ch = din + 2 * n
        self.wz = _param((d, din), dt, device)
        self.wx = _param((d, din), dt, device)
        self.wB = _param((d, n), dt, device)
        self.wC = _param((d, n), dt, device)
        self.wdt = _param((d, H), dt, device)
        self.dt_bias = _param((H,), f32, device)
        self.A_log = _param((H,), f32, device)
        self.D = _param((H,), f32, device)
        self.conv_w = _param((cfg.ssm_conv, conv_ch), dt, device)
        self.conv_b = _param((conv_ch,), f32, device)
        self.gn = _param((din,), f32, device)
        self.out = _param((din, d), dt, device)

    def forward(self, x: torch.Tensor, *, cache: Cache = None,
                decode: bool = False,
                impl: Optional[str] = None) -> torch.Tensor:
        """``cache`` is this block's ``state`` (B, H, P, n) fp32 and
        ``conv`` (B, K-1, d_inner + 2n), written IN PLACE: prefill stores
        the final state and the last K-1 conv inputs; a ``decode`` step
        (S == 1) starts from them and updates both."""
        cfg = self.cfg
        B, S, _ = x.shape
        din, n, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        P = din // H
        z = x @ self.wz
        dt = F.softplus((x @ self.wdt).float() + self.dt_bias)
        A = -torch.exp(self.A_log)
        xbc = torch.cat([x @ self.wx, x @ self.wB, x @ self.wC], dim=-1)
        step = decode and S == 1
        tail = cache["conv"] if decode else None
        xbc, new_tail = _causal_conv(xbc, self.conv_w, self.conv_b, tail)
        xbc = _silu(xbc)
        xin, Bp, Cp = torch.split(xbc, [din, n, n], dim=-1)
        xh = xin.reshape(B, S, H, P)
        if step:
            state, y = ops.ssd_decode_step(cache["state"], xh[:, 0],
                                           dt[:, 0], A, Bp[:, 0], Cp[:, 0])
            y = y[:, None].to(x.dtype)
        else:
            init = cache["state"] if decode else None
            y, state = ops.mamba2_ssd(
                xh.contiguous(), dt.to(xh.dtype), A, Bp.contiguous(),
                Cp.contiguous(), chunk=cfg.ssm_chunk, init_state=init,
                impl=impl)
        if cache is not None:
            cache["state"].copy_(state)
            cache["conv"].copy_(new_tail)
        y = y + xh * self.D[None, None, :, None].to(x.dtype)
        y = y.reshape(B, S, din)
        g = (y * _silu(z)).float()
        g = g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True)
                            + cfg.norm_eps) * self.gn
        return g.to(x.dtype) @ self.out


# ---------------------------------------------------------------------------
# Zamba2-style shared attention block (one weight set reused across depth)
# ---------------------------------------------------------------------------
class SharedAttention(nn.Module):
    """``concat(x, x0) @ win``, then pre-norm attention and a pre-norm
    SwiGLU MLP, each with its residual; returns the block's output, which
    the caller adds to x.  One instance serves every ``shared_attn`` entry
    of the model (its k/v cache is per entry)."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        d = cfg.d_model
        self.win = _param((2 * d, d), cfg.activation_dtype, device)
        self.norm = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.norm2 = Norm(cfg, device)
        # the reference's shared block is SwiGLU whatever cfg.act says
        self.mlp = MLPBlock(dataclasses.replace(cfg, act="swiglu"), device)

    def forward(self, x: torch.Tensor, x0: torch.Tensor, *,
                angles: torch.Tensor, cache: Cache = None,
                cache_index: Optional[int] = None,
                impl: Optional[str] = None) -> torch.Tensor:
        h = torch.cat([x, x0], dim=-1) @ self.win
        h = h + self.attn(self.norm(h), angles=angles, cache=cache,
                          cache_index=cache_index, impl=impl)
        return h + self.mlp(self.norm2(h))
