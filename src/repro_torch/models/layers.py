"""Neural network blocks of the port: norms, RoPE, GQA attention, MLP, the
top-k mixture of experts, the Mamba2 (SSD) block, the xLSTM mLSTM and
sLSTM blocks and Zamba2's shared attention block — the counterparts of
``repro/models/layers.py`` (``norm_*``, ``rope_*``, ``attn_*``, ``mlp_*``,
``moe_*``, ``mamba2_*``, ``mlstm_*``, ``slstm_*``, ``shared_attn_*``).

Each block is an ``nn.Module`` whose weights keep the JAX package's
orientation ``(d_in, d_out)``, applied as ``x @ w``, so the reference's
parameters load without transposes (:func:`repro_torch.models.model
.params_from_reference`).  Numerics policy as in the reference: weights and
activations in ``cfg.dtype``; norms and RoPE in fp32, cast back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from .config import ModelConfig

Cache = Optional[Dict[str, torch.Tensor]]
NEG = -1e30         # the caches' stand-in for an mLSTM stabiliser of -inf


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
    attends over the fixed-size cache through ``ops.attention_ref``.

    ``forward`` is :meth:`project`, :meth:`heads`, :meth:`attend` and
    :meth:`out`.  A tensor-parallel rank (``runtime/spmd.py``) calls them
    with its column blocks of ``wq``, ``wk``, ``wv`` and its row block of
    ``wo``, and puts its collectives between them; the heads are read off
    the widths of what each method is given."""

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

    def project(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``x @ wq``, ``x @ wk``, ``x @ wv``, each (B, S, its columns)."""
        return x @ self.wq, x @ self.wk, x @ self.wv

    def heads(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              angles: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The projections as heads (B, S, ·, dh), q and k rotated: every
        one of their columns must belong to whole heads, since RoPE pairs
        dimensions within a head."""
        B, S, _ = q.shape
        dh = self.cfg.head_dim
        q = rope_apply(q.view(B, S, -1, dh), angles)
        k = rope_apply(k.view(B, S, -1, dh), angles)
        return q, k, v.view(B, S, -1, dh)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: Optional[int] = None, cache: Cache = None,
               cache_index: Optional[int] = None,
               impl: Optional[str] = None) -> torch.Tensor:
        """Attention of q (B, S, H, dh) over k, v (B, S, Hkv, dh), query
        head j on KV head j // (H / Hkv): (B, S, H dh).  ``cache`` as in
        :meth:`forward`."""
        cfg = self.cfg
        B, S, H, dh = q.shape
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
        return o.reshape(B, S, H * dh)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """``o @ wo`` (on a tensor-parallel rank, a partial sum)."""
        return o @ self.wo

    def forward(self, x: torch.Tensor, *, angles: torch.Tensor,
                window: Optional[int] = None, cache: Cache = None,
                cache_index: Optional[int] = None,
                impl: Optional[str] = None) -> torch.Tensor:
        """``cache`` is this block's k/v, each (B, T, Hkv, dh), written IN
        PLACE (the JAX package returns updated copies, layers.py:118):
        prefill (no ``cache_index``) writes positions [0, S); a decode step
        writes at ``cache_index`` and then attends over the whole cache."""
        q, k, v = self.heads(*self.project(x), angles)
        return self.out(self.attend(q, k, v, window=window, cache=cache,
                                    cache_index=cache_index, impl=impl))


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
# MoE (top-k routing, capacity-based dispatch)
# ---------------------------------------------------------------------------
class MoE(nn.Module):
    """Top-k mixture of experts with the reference's grouped, gather-only
    dispatch into a fixed-capacity expert layout (``moe_apply``): one
    dispatch group per sequence (G = B), a fp32 router, softmax, top-k with
    the gates renormalised, the Switch-style load-balancing loss, capacity
    ``cap = min(max(8, ceil8(int(Tk / E · capacity_factor))), Tk)`` for Tk
    = S · k routed rows per group, overflow rows dropped.  The three expert
    products — ``silu(xe @ wg) * (xe @ wu)``, then ``@ wd`` — run on the
    (E, G · cap, ·) layout through ``ops.moe_gmm`` (the Hopper kernel on
    the card), in prefill and in decode; routing, sorts and gathers stay
    plain torch, as they are jnp in the reference.

    Parity points: ``lax.top_k`` breaks ties toward the lower index and
    ``jnp.argsort`` is stable, so top-k is a stable descending sort and
    both argsorts are stable; invalid capacity slots gather a clipped row
    and are zeroed by a multiply in the activation dtype, as the reference
    zeroes them; the k weighted expert rows of a token are summed in fp32
    and rounded once, as ``jnp.sum`` upcasts bf16."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        dt = cfg.activation_dtype
        self.router = _param((d, E), torch.float32, device)
        self.wg = _param((E, d, ff), dt, device)
        self.wu = _param((E, d, ff), dt, device)
        self.wd = _param((E, ff, d), dt, device)
        # the reference draws the expert weights at fan-in d and ff, not
        # shape[0] = E
        self.init_fan_in = {"wg": d, "wu": d, "wd": ff}

    def capacity(self, tokens: int) -> int:
        """Slots per expert and group for ``tokens`` tokens a group."""
        cfg = self.cfg
        Tk = tokens * cfg.top_k
        cap = int(Tk / cfg.n_experts * cfg.capacity_factor)
        cap = max(8, -(-cap // 8) * 8)
        return min(cap, Tk)

    def route(self, x: torch.Tensor, router: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Router softmax and top-k: (gates (G, Tg, k) fp32 renormalised,
        expert ids (G, Tg, k) int64, probabilities (G, Tg, E) fp32) for x
        (G, Tg, d), with this block's router or ``router``."""
        k = self.cfg.top_k
        router = self.router if router is None else router
        probs = torch.softmax(x.float() @ router, dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, eidx = top.values[..., :k], top.indices[..., :k]
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
        return gate_vals, eidx, probs

    def aux_parts(self, probs: torch.Tensor, eidx: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The load-balancing loss's two sums over (G, Tg): the router
        probabilities and the one-hot top-1 choices, each (E,) fp32.
        ``aux = E · Σ_e (probs_sum / n) · (top1_sum / n)`` for n = G · Tg
        (the sharded steps sum the parts over the data ranks first)."""
        E = self.cfg.n_experts
        return (probs.sum(dim=(0, 1)),
                F.one_hot(eidx[..., 0], E).float().sum(dim=(0, 1)))

    def dispatch(self, x: torch.Tensor, router: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Tuple, torch.Tensor, torch.Tensor]:
        """Routing and the gather into the expert layout: (xe (E, G·cap, d)
        contiguous, the plan :meth:`combine` takes, probs, expert ids) for
        x (B, S, d)."""
        cfg = self.cfg
        B, S, d = x.shape
        E, k = cfg.n_experts, cfg.top_k
        G, Tg, Tk = B, S, S * k
        xt = x.reshape(G, Tg, d)
        gate_vals, eidx, probs = self.route(xt, router)
        cap = self.capacity(Tg)

        # dispatch: expert e's slot c holds sorted row starts[e] + c
        flat_e = eidx.reshape(G, Tk)
        order = torch.argsort(flat_e, dim=-1, stable=True)
        sorted_e = torch.gather(flat_e, 1, order)
        tok_of = order // k
        experts = torch.arange(E, device=x.device).expand(G, E).contiguous()
        starts = torch.searchsorted(sorted_e, experts, side="left")
        counts = torch.diff(starts, dim=-1,
                            append=torch.full((G, 1), Tk, device=x.device))
        slots = torch.arange(cap, device=x.device)
        slot_rows = (starts[:, :, None] + slots).clamp(0, Tk - 1)
        slot_valid = slots < counts[:, :, None]                 # (G, E, cap)
        src_tok = torch.gather(tok_of, 1, slot_rows.reshape(G, E * cap))
        xe = torch.gather(xt, 1, src_tok[..., None].expand(G, E * cap, d))
        xe = xe * slot_valid.reshape(G, E * cap, 1).to(x.dtype)
        xe = xe.reshape(G, E, cap, d).transpose(0, 1).reshape(E, G * cap, d)
        plan = (order, sorted_e, starts, gate_vals, cap)
        return xe.contiguous(), plan, probs, eidx

    @staticmethod
    def experts(xe: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, impl: Optional[str] = None
                ) -> torch.Tensor:
        """The expert products on the (E, G·cap, ·) layout through
        ``ops.moe_gmm``: ``(silu(xe @ wg) * (xe @ wu)) @ wd``, for the
        experts (and ffn columns) that ``wg``, ``wu``, ``wd`` hold."""
        h = _silu(ops.moe_gmm(xe, wg, impl=impl)) \
            * ops.moe_gmm(xe, wu, impl=impl)
        return ops.moe_gmm(h, wd, impl=impl)             # (E, G·cap, d)

    def combine(self, ye: torch.Tensor, plan: Tuple, x: torch.Tensor
                ) -> torch.Tensor:
        """The return path: each token's k expert rows, weighted by its
        gates and summed in fp32, as y (B, S, d) in x's dtype."""
        cfg = self.cfg
        B, S, d = x.shape
        E, k = cfg.n_experts, cfg.top_k
        G, Tg, Tk = B, S, S * k
        order, sorted_e, starts, gate_vals, cap = plan
        ye = ye.reshape(E, G, cap, d).transpose(0, 1).reshape(G, E * cap, d)

        # return path: row r (sorted) sits in slot sorted_e[r]·cap + (r -
        # starts[sorted_e[r]]) when within capacity; token t collects its
        # k rows through the inverse permutation
        slot_of_row = torch.arange(Tk, device=x.device) \
            - torch.gather(starts, 1, sorted_e)
        keep = slot_of_row < cap
        buf_pos = (sorted_e * cap + slot_of_row).clamp(0, E * cap - 1)
        inv = torch.argsort(order, dim=-1, stable=True)
        row_pos = torch.gather(buf_pos, 1, inv)
        row_keep = torch.gather(keep, 1, inv)
        contrib = torch.gather(ye, 1, row_pos[..., None].expand(G, Tk, d))
        wgt = (gate_vals.reshape(G, Tk) * row_keep.float()).to(x.dtype)
        y = (contrib * wgt[..., None]).reshape(G, Tg, k, d).float().sum(2)
        return y.to(x.dtype).reshape(B, S, d)

    def forward(self, x: torch.Tensor, *, impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (y (B, S, d), aux loss fp32 scalar)."""
        xe, plan, probs, eidx = self.dispatch(x)
        ye = self.experts(xe, self.wg, self.wu, self.wd, impl)
        p_sum, c_sum = self.aux_parts(probs, eidx)
        n = probs.shape[0] * probs.shape[1]
        aux = self.cfg.n_experts * ((p_sum / n) * (c_sum / n)).sum()
        return self.combine(ye, plan, x), aux


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
    fp32.

    ``forward`` is :meth:`mix` then :meth:`project`.  A tensor-parallel
    rank (``runtime/spmd.py``) calls the two with the leaves cut to its
    heads: the per-head leaves (``wz``, ``wx``, ``wdt``, ``dt_bias``,
    ``A_log``, ``D``, ``gn``, the rows of ``out``) hold only those heads,
    ``conv_w``, ``conv_b`` and the ``conv`` cache the heads' ``xin``
    channels and all of B and C; ``wB`` and ``wC`` are whole.  The heads
    are read off ``wz``'s width.  The norm's mean square over all of
    ``d_inner`` is the sum of every rank's partial sum of squares."""

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

    def mix(self, x: torch.Tensor, *, cache: Cache = None,
            decode: bool = False, impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Up to the gated norm: (g = y · silu(z) fp32 (B, S, the heads'
        channels), its sum of squares over those channels (B, S, 1)).

        ``cache`` is this block's ``state`` (B, H, P, n) fp32 and ``conv``
        (B, K-1, channels), written IN PLACE: prefill stores the final
        state and the last K-1 conv inputs; a ``decode`` step (S == 1)
        starts from them and updates both."""
        cfg = self.cfg
        B, S, _ = x.shape
        n, P = cfg.ssm_state, cfg.d_inner // cfg.n_ssm_heads
        z = x @ self.wz
        c = z.shape[-1]
        dt = F.softplus((x @ self.wdt).float() + self.dt_bias)
        A = -torch.exp(self.A_log)
        xbc = torch.cat([x @ self.wx, x @ self.wB, x @ self.wC], dim=-1)
        step = decode and S == 1
        tail = cache["conv"] if decode else None
        xbc, new_tail = _causal_conv(xbc, self.conv_w, self.conv_b, tail)
        xbc = _silu(xbc)
        xin, Bp, Cp = torch.split(xbc, [c, n, n], dim=-1)
        xh = xin.reshape(B, S, c // P, P)
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
        y = y.reshape(B, S, c)
        g = (y * _silu(z)).float()
        return g, g.square().sum(dim=-1, keepdim=True)

    def project(self, g: torch.Tensor, sumsq: torch.Tensor) -> torch.Tensor:
        """The gated norm's rest and the output projection, given the sum
        of squares over all of ``d_inner``: ``norm(g) · gn @ out`` (on a
        tensor-parallel rank, a partial sum)."""
        g = g * torch.rsqrt(sumsq / self.cfg.d_inner + self.cfg.norm_eps) \
            * self.gn
        return g.to(self.out.dtype) @ self.out

    def forward(self, x: torch.Tensor, *, cache: Cache = None,
                decode: bool = False,
                impl: Optional[str] = None) -> torch.Tensor:
        """:meth:`mix` (``cache`` as there) then :meth:`project`."""
        return self.project(*self.mix(x, cache=cache, decode=decode,
                                      impl=impl))


# ---------------------------------------------------------------------------
# xLSTM: mLSTM block (matrix memory, chunkwise parallel)
# ---------------------------------------------------------------------------
class MLSTM(nn.Module):
    """The mLSTM block: ``x @ wup`` split into ``z`` (first half) and
    ``xi``; q, k, v projections of ``xi`` (q scaled by ``dh ** -0.5`` in
    the activation dtype); fp32 input and forget gate logits
    ``xi @ w{i,f} + b{i,f}``; the chunked scan through
    ``ops.mlstm_chunked`` (the Hopper kernel on the card) or, for a decode
    step, ``ops.mlstm_decode_step``; the fp32 RMS norm times ``gn``; then
    ``× silu(z)`` and ``@ wd``.

    ``forward`` is :meth:`mix` then :meth:`project`.  A tensor-parallel
    rank (``runtime/spmd.py``) calls the two with the leaves cut to its
    heads: the per-head leaves (the columns of ``wq``, ``wk``, ``wv``,
    ``wi``, ``wf``, ``bi``, ``bf``, ``gn``, the rows of ``wd``) hold only
    those heads, and ``wup`` the heads' ``z`` columns and all of ``xi``'s.
    The heads are read off ``wi``'s width.  The norm's mean square over
    all of ``din`` is the sum of every rank's partial sum of squares."""

    CONSTANTS = {"bi": 0.0, "bf": 3.0, "gn": 1.0}   # open forget gates

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        din = int(cfg.mlstm_proj_factor * d)
        H = cfg.n_heads
        dt, f32 = cfg.activation_dtype, torch.float32
        self.wup = _param((d, 2 * din), dt, device)
        self.wq = _param((din, din), dt, device)
        self.wk = _param((din, din), dt, device)
        self.wv = _param((din, din), dt, device)
        self.wi = _param((din, H), f32, device)
        self.bi = _param((H,), f32, device)
        self.wf = _param((din, H), f32, device)
        self.bf = _param((H,), f32, device)
        self.gn = _param((din,), f32, device)
        self.wd = _param((din, d), dt, device)

    def mix(self, x: torch.Tensor, *, cache: Cache = None,
            decode: bool = False, impl: Optional[str] = None
            ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """Up to the norm: ((y fp32, z), y's sum of squares over the
        heads' channels (B, S, 1)).

        ``cache`` is this block's ``C`` (B, H, dh, dh), ``n`` (B, H, dh)
        and ``m`` (B, H), fp32, written IN PLACE: prefill stores the final
        state; a ``decode`` step starts from it.  A stabiliser of -inf is
        kept as -1e30 in the cache, as the reference's."""
        cfg = self.cfg
        B, S, d = x.shape
        din = self.wq.shape[0]
        H, dh = self.wi.shape[1], din // cfg.n_heads
        z, xi = torch.split(x @ self.wup, [self.wup.shape[1] - din, din],
                            dim=-1)
        # the scale rounded to the activation dtype first, as XLA rounds
        # the reference's weakly typed Python float
        scale = torch.tensor(dh ** -0.5, dtype=x.dtype)
        q = (xi @ self.wq).view(B, S, H, dh) * scale
        k = (xi @ self.wk).view(B, S, H, dh)
        v = (xi @ self.wv).view(B, S, H, dh)
        xf = xi.float()
        ig = xf @ self.wi + self.bi                          # (B, S, H)
        fg = xf @ self.wf + self.bf
        init = None
        if decode:
            m = cache["m"]
            init = (cache["C"], cache["n"],
                    torch.where(m <= -1e29, float("-inf"), m))
        if decode and S == 1:
            state, y = ops.mlstm_decode_step(init, q[:, 0], k[:, 0], v[:, 0],
                                             ig[:, 0], fg[:, 0])
            y = y[:, None].to(x.dtype)
        else:
            y, state = ops.mlstm_chunked(q, k, v, ig, fg,
                                         chunk=min(cfg.ssm_chunk, S),
                                         init=init, impl=impl)
        if cache is not None:
            C, n, m = state
            cache["C"].copy_(C)
            cache["n"].copy_(n)
            cache["m"].copy_(torch.where(torch.isfinite(m), m, NEG))
        y = y.reshape(B, S, H * dh).float()
        return (y, z), y.square().sum(dim=-1, keepdim=True)

    def project(self, yz: Tuple[torch.Tensor, torch.Tensor],
                sumsq: torch.Tensor) -> torch.Tensor:
        """The norm's rest, the gate and the down projection, given the
        sum of squares over all of ``din`` (on a tensor-parallel rank, a
        partial sum)."""
        y, z = yz
        y = y * torch.rsqrt(sumsq / self.wq.shape[0] + self.cfg.norm_eps) \
            * self.gn
        return (y.to(z.dtype) * _silu(z)) @ self.wd

    def forward(self, x: torch.Tensor, *, cache: Cache = None,
                decode: bool = False,
                impl: Optional[str] = None) -> torch.Tensor:
        """:meth:`mix` (``cache`` as there) then :meth:`project`."""
        return self.project(*self.mix(x, cache=cache, decode=decode,
                                      impl=impl))


# ---------------------------------------------------------------------------
# xLSTM: sLSTM block (scalar memory, sequential recurrence)
# ---------------------------------------------------------------------------
_GATES = ("i", "f", "z", "o")


class SLSTM(nn.Module):
    """The sLSTM block: per head, a stabilised scalar-memory recurrence
    over the sequence with gate pre-activations ``x @ w_g + b_g`` plus the
    head's recurrent ``h @ r_g`` (``r_g`` (H, dh, dh)); ``h = o · c /
    max(n, 1e-6)``; the fp32 RMS norm times ``gn``; then the
    ``gelu(· @ wu) @ wd2`` projection (tanh GeLU, as ``jax.nn.gelu``),
    ``ffd = ceil(int(slstm_proj_factor · d) / 64) · 64``.

    The reference scans ``_slstm_step`` with ``x_t @ w_g`` inside the step;
    here those products, which do not depend on the recurrence, and their
    biases are computed once for the whole sequence, and the step keeps
    its state head-major, (H, B, dh), so that the four recurrent products
    are one batched matmul.  Plain torch, no kernel: the Python loop runs
    S steps.

    ``forward`` is :meth:`mix`, :meth:`norm` and :meth:`ffn`.  A
    tensor-parallel rank (``runtime/spmd.py``; the recurrence is
    block-diagonal by head) calls :meth:`mix` and :meth:`norm` with the
    leaves cut to its heads (the columns of ``w{i,f,z,o}``, ``b{i,f,z,o}``
    and ``gn``, ``r{i,f,z,o}``'s heads; read off ``ri``'s heads), and the
    norm's mean square over all of ``d`` is the sum of every rank's partial
    sum of squares; :meth:`ffn` takes all of ``d``, with ``wu``'s columns
    and ``wd2``'s rows of the rank (a partial sum)."""

    CONSTANTS = {"bi": 0.0, "bf": 1.0, "bz": 0.0, "bo": 0.0, "gn": 1.0}

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d, H = cfg.d_model, cfg.n_heads
        dh = d // H
        dt, f32 = cfg.activation_dtype, torch.float32
        ffd = -(-int(cfg.slstm_proj_factor * d) // 64) * 64
        self.gn = _param((d,), f32, device)
        self.wu = _param((d, ffd), dt, device)
        self.wd2 = _param((ffd, d), dt, device)
        for g in _GATES:
            setattr(self, f"w{g}", _param((d, d), f32, device))
            setattr(self, f"r{g}", _param((H, dh, dh), f32, device))
            setattr(self, f"b{g}", _param((d,), f32, device))
        # the reference draws r_g at fan-in dh, not shape[0] = H
        self.init_fan_in = {f"r{g}": dh for g in _GATES}

    def mix(self, x: torch.Tensor, *, cache: Cache = None,
            decode: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """The recurrence: (h over the sequence fp32 (B, S, the heads'
        channels), its sum of squares over those channels (B, S, 1)).

        ``cache`` is this block's ``c``, ``n``, ``h``, ``m``, each (B, the
        heads' channels) fp32, written IN PLACE: prefill starts from the
        zero state (n = 1) and stores the final one; a ``decode`` step
        starts from it."""
        B, S, _ = x.shape
        H, dh = self.ri.shape[0], self.ri.shape[1]
        xf = x.float()

        def head_major(t):          # (..., B, H dh) -> (..., H, B, dh)
            return t.unflatten(-1, (H, dh)).transpose(-2, -3)

        # (S, 4, H, B, dh): x_t @ w_g + b_g of every step and gate
        gx = torch.stack([xf @ getattr(self, f"w{g}") + getattr(self, f"b{g}")
                          for g in _GATES], dim=0)          # (4, B, S, H dh)
        gx = head_major(gx.transpose(1, 2)).transpose(0, 1).contiguous()
        R = torch.cat([getattr(self, f"r{g}") for g in _GATES], dim=-1)
        if decode:
            c, n, h, m = (head_major(cache[k]) for k in ("c", "n", "h", "m"))
        else:
            zeros = xf.new_zeros((H, B, dh))
            c, n, h, m = zeros, torch.ones_like(zeros), zeros, zeros
        hs = xf.new_empty((S, H, B, dh))
        for t in range(S):
            pre = gx[t] + torch.bmm(h, R).unflatten(-1, (4, dh)) \
                .movedim(-2, 0)                             # (4, H, B, dh)
            it, ft = pre[0], pre[1]
            zt, ot = torch.tanh(pre[2]), torch.sigmoid(pre[3])
            logf_m = F.logsigmoid(ft) + m
            m_new = torch.maximum(logf_m, it)
            i_s = torch.exp(it - m_new)
            f_s = torch.exp(logf_m - m_new)
            c = f_s * c + i_s * zt
            n = f_s * n + i_s
            h = ot * (c / n.clamp_min(1e-6))
            m = m_new
            hs[t] = h
        if cache is not None:
            for k, t in (("c", c), ("n", n), ("h", h), ("m", m)):
                cache[k].copy_(t.transpose(0, 1).reshape(B, H * dh))
        y = hs.permute(2, 0, 1, 3).reshape(B, S, H * dh)
        return y, y.square().sum(dim=-1, keepdim=True)

    def norm(self, y: torch.Tensor, sumsq: torch.Tensor) -> torch.Tensor:
        """The RMS norm of ``y`` given the sum of squares over all of
        ``d``, times ``gn``, in the activation dtype."""
        y = y * torch.rsqrt(sumsq / self.cfg.d_model + self.cfg.norm_eps) \
            * self.gn
        return y.to(self.wu.dtype)

    def ffn(self, y: torch.Tensor) -> torch.Tensor:
        """``gelu(y @ wu) @ wd2`` of the normed ``y`` (B, S, d)."""
        return F.gelu(y @ self.wu, approximate="tanh") @ self.wd2

    def forward(self, x: torch.Tensor, *, cache: Cache = None,
                decode: bool = False) -> torch.Tensor:
        """:meth:`mix` (``cache`` as there), :meth:`norm`, :meth:`ffn`."""
        return self.ffn(self.norm(*self.mix(x, cache=cache, decode=decode)))


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
