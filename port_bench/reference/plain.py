"""Plain PyTorch operations of the benchmark's references.

Written from the published descriptions of the operations, not from the
program under test: nothing here imports it.  Every product goes through
a :class:`Matmul`, which computes it in fp32 (TF32 off) or, for the
control that a check of ``correct`` must fail, with both operands rounded
to fp8 first (e4m3, one scale a tensor; the gradients flowing back
through them in e5m2).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0         # the largest finite float8_e4m3fn


def strict_fp32() -> None:
    """Products in full fp32 on the card: no TF32 in matmuls or convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to the fp8 ``dtype`` under one scale that maps its
    largest magnitude to ``top``, and back to ``t``'s dtype."""
    amax = t.abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8(torch.autograd.Function):
    """Scaled fp8 as fp8 training computes: operands in e4m3 (largest 448),
    the gradient that flows back through them in e5m2 (largest 57344)."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(t)


class Matmul:
    """``a @ b`` in fp32, or on fp8-rounded operands (``precision="fp8"``)."""

    def __init__(self, precision: str = "fp32") -> None:
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be fp32 or fp8, got "
                             f"{precision!r}")
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, b = fp8_round(a), fp8_round(b)
        return torch.matmul(a, b)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) \
        * scale


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, the two halves of each head paired (GPT-NeoX
    layout).  x (B, S, H, D); positions (S,)."""
    D = x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                  device=x.device) / D)
    ang = positions.float()[:, None] * inv                  # (S, D/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mm: Matmul, *, causal: bool = True) -> torch.Tensor:
    """Softmax attention, query head j on KV head j // (H / Hkv), scores
    scaled by 1/sqrt(D).  q (B, S, H, D), k and v (B, S, Hkv, D); returns
    (B, S, H·D)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qh = q.permute(0, 2, 1, 3).reshape(B, Hkv, G, S, D)
    kh = k.permute(0, 2, 1, 3)[:, :, None]                  # (B,Hkv,1,S,D)
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    s = mm(qh, kh.transpose(-1, -2)) / math.sqrt(D)         # (B,Hkv,G,S,S)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(mask, float("-inf"))
    o = mm(torch.softmax(s, dim=-1), vh)                    # (B,Hkv,G,S,D)
    return o.reshape(B, H, S, D).permute(0, 2, 1, 3).reshape(B, S, H * D)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal convolution over time: x (B, S, C), w (K, C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(K)) + b


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, chunk: int, mm: Matmul
        ) -> torch.Tensor:
    """Mamba2's state-space dual scan (arXiv:2405.21060, the chunked
    form).  h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t and y_t = h_t C_t,
    from h_0 = 0.  x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, n)
    shared by the heads; s a multiple of ``chunk``.  Returns y (b, s, h,
    p)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd: length {s} is not a multiple of {chunk}")
    nc, L = s // chunk, chunk
    xd = (x * dt[..., None]).reshape(b, nc, L, h, p).permute(0, 3, 1, 2, 4)
    a = (dt * A).reshape(b, nc, L, h).permute(0, 3, 1, 2)   # (b,h,nc,L)
    Bc = B.reshape(b, nc, L, n)[:, None]                    # (b,1,nc,L,n)
    Cc = C.reshape(b, nc, L, n)[:, None]
    cs = torch.cumsum(a, dim=-1)
    # inside a chunk: y_t += sum_{u <= t} (C_t . B_u) exp(cs_t - cs_u) xd_u
    seg = cs[..., :, None] - cs[..., None, :]
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~tril, float("-inf")))
    y = mm(mm(Cc, Bc.transpose(-1, -2)) * decay, xd)        # (b,h,nc,L,p)
    # each chunk's own final state, then the states entering each chunk
    last = torch.exp(cs[..., -1:] - cs)[..., None]          # (b,h,nc,L,1)
    own = mm((xd * last).transpose(-1, -2), Bc)             # (b,h,nc,p,n)
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(cs[:, :, c, -1])[..., None, None] \
            + own[:, :, c]
    enter = torch.stack(entering, dim=2)                    # (b,h,nc,p,n)
    y = y + mm(Cc, enter.transpose(-1, -2)) * torch.exp(cs)[..., None]
    return y.permute(0, 2, 3, 1, 4).reshape(b, s, h, p)


# ---------------------------------------------------------------------------
# AdamW (decoupled weight decay; Loshchilov & Hutter, arXiv:1711.05101)
# ---------------------------------------------------------------------------
def lr_at(opt: Dict, step: int) -> float:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    to ``min_lr_ratio`` of it at ``total_steps``; ``step`` counts from 1."""
    warm = max(opt["warmup_steps"], 1)
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / warm
    span = max(opt["total_steps"] - opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"]) / span, 0.0), 1.0)
    r = opt["min_lr_ratio"]
    return opt["peak_lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi
                                                               * prog)))


class AdamW:
    """AdamW over a dict of fp32 leaves, the gradient clipped first to
    ``clip_norm`` by its global norm; leaves named in ``no_decay`` take no
    weight decay.  ``step`` applies one update in place."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: Dict,
                 no_decay: Iterable[str]) -> None:
        self.params = params
        self.opt = opt
        self.no_decay = set(no_decay)
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        o = self.opt
        self.t += 1
        lr = lr_at(o, self.t)
        norm = torch.sqrt(sum(torch.sum(g.square()) for g in grads.values()))
        scale = torch.clamp(o["clip_norm"] / torch.clamp_min(norm, 1e-12),
                            max=1.0) if o["clip_norm"] else 1.0
        b1, b2 = o["b1"], o["b2"]
        b1c, b2c = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k] * scale
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            delta = (self.m[k] / b1c) / (torch.sqrt(self.v[k] / b2c)
                                         + o["eps"])
            if k not in self.no_decay:
                delta.add_(p, alpha=o["weight_decay"])
            p.sub_(delta, alpha=lr)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's fp32 Euclidean norm, read back once."""
    return norms_of(list(tensors), lambda k: tensors[k])


def norms_of(names: List[str], leaf) -> Dict[str, float]:
    """The fp32 norm of ``leaf(name)`` for each name, each leaf made and
    dropped in turn (so that a whole model's differences never sit in
    memory together), read back once."""
    if not names:
        return {}
    with torch.no_grad():
        vals = torch.stack([torch.linalg.vector_norm(leaf(k).float())
                            for k in names]).tolist()
    return dict(zip(names, vals))


def median(values: List[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    return vs[n // 2] if n % 2 else 0.5 * (vs[n // 2 - 1] + vs[n // 2])


def norm_gap(got: Dict[str, float], want: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The worst leaf's gap between two norms, |got - want|, over the
    larger of the leaf's own ``want`` and the median leaf's; ``keep``
    limits the leaves.  Returns (gap, leaf)."""
    names = list(want if keep is None else keep)
    med = median([want[k] for k in names])
    worst, at = 0.0, ""
    for k in names:
        gap = abs(got[k] - want[k]) / max(want[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at
