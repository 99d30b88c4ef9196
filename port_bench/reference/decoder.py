"""Plain reference of the decoder language models the benchmark runs: a
repeating pattern of pre-norm residual blocks (GQA attention with RoPE,
SwiGLU MLP, Mamba2, and Zamba2's shared attention block, which reads the
concatenation of the residual stream and the embeddings), a final RMSNorm
and the LM head (tied or not).

It is the benchmark's yardstick.  It imports nothing of the program under
test.  The program's parameters carry the same names (``units.<r>.blocks.
L<i>_<j>_<kind>.<leaf>``, ``shared.*``, ``embed``, ``lm_head``,
``final_norm.scale``), so one dict of tensors made by the benchmark loads
into either; the harness checks that the program's names, shapes and
dtypes are these.  ``c`` is the ``port`` section of a configuration file.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import plain
from .plain import Matmul

ATTN, MLP, MAMBA2, SHARED = "attn", "mlp", "mamba2", "shared_attn"


# ---------------------------------------------------------------------------
# Parameters: (name, shape, dtype, init) with init ("normal", std) or
# ("const", value)
# ---------------------------------------------------------------------------
def head_dim(c: Dict) -> int:
    return c.get("d_head") or c["d_model"] // c["n_heads"]


def ssm_heads(c: Dict) -> int:
    return c.get("ssm_heads") or max(1, c["ssm_expand"] * c["d_model"] // 64)


def _normal(shape, dt="matrix", std=None):
    return (tuple(shape), dt, ("normal", std if std is not None
                               else 1.0 / math.sqrt(shape[0])))


def _const(shape, value):
    return (tuple(shape), "float32", ("const", value))


def _attn(c: Dict) -> Dict:
    d, dh, H, Hkv = c["d_model"], head_dim(c), c["n_heads"], c["n_kv_heads"]
    return {"wq": _normal((d, H * dh)), "wk": _normal((d, Hkv * dh)),
            "wv": _normal((d, Hkv * dh)), "wo": _normal((H * dh, d))}


def _mlp(c: Dict) -> Dict:
    d, ff = c["d_model"], c["d_ff"]
    return {"wg": _normal((d, ff)), "wu": _normal((d, ff)),
            "wd": _normal((ff, d))}


def _mamba2(c: Dict) -> Dict:
    d, n = c["d_model"], c["ssm_state"]
    din, H = c["ssm_expand"] * d, ssm_heads(c)
    ch = din + 2 * n
    return {"wz": _normal((d, din)), "wx": _normal((d, din)),
            "wB": _normal((d, n)), "wC": _normal((d, n)),
            "wdt": _normal((d, H)), "dt_bias": _const((H,), 0.0),
            "A_log": _const((H,), 0.0), "D": _const((H,), 1.0),
            "conv_w": _normal((c["ssm_conv"], ch), std=0.1),
            "conv_b": _const((ch,), 0.0), "gn": _const((din,), 1.0),
            "out": _normal((din, d))}


def blocks(c: Dict) -> List[Tuple[str, Optional[str], str]]:
    """(block, norm or None, kind) of one repeat of the pattern."""
    return [(f"L{i}_{j}_{kind}", None if kind == SHARED else f"L{i}_{j}_norm",
             kind) for i, layer in enumerate(c["pattern"])
            for j, kind in enumerate(layer)]


def repeats(c: Dict) -> int:
    if c["n_layers"] % len(c["pattern"]):
        raise ValueError("n_layers is not a whole number of patterns")
    return c["n_layers"] // len(c["pattern"])


def param_specs(c: Dict) -> List[Tuple[str, Tuple[int, ...], str, Tuple]]:
    """Every parameter: (name, shape, dtype, init), in a fixed order.  The
    dtype ``"matrix"`` is the configuration's activation dtype."""
    d = c["d_model"]
    out = [("embed",) + _normal((c["vocab"], d), std=0.02)]
    if not c["tie_embeddings"]:
        out.append(("lm_head",) + _normal((d, c["vocab"])))
    kinds = {ATTN: _attn, MLP: _mlp, MAMBA2: _mamba2}
    for r in range(repeats(c)):
        for name, norm, kind in blocks(c):
            if kind == SHARED:
                continue
            out.append((f"units.{r}.blocks.{norm}.scale",)
                       + _const((d,), 1.0))
            for leaf, spec in kinds[kind](c).items():
                out.append((f"units.{r}.blocks.{name}.{leaf}",) + spec)
    if any(k == SHARED for _, _, k in blocks(c)):
        out.append(("shared.win",) + _normal((2 * d, d)))
        out.append(("shared.norm.scale",) + _const((d,), 1.0))
        out += [(f"shared.attn.{k}",) + s for k, s in _attn(c).items()]
        out.append(("shared.norm2.scale",) + _const((d,), 1.0))
        out += [(f"shared.mlp.{k}",) + s for k, s in _mlp(c).items()]
    out.append(("final_norm.scale",) + _const((d,), 1.0))
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _sub(W: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    n = len(prefix)
    return {k[n:]: v for k, v in W.items() if k.startswith(prefix)}


def _attention(x, P, c, pos, mm):
    B, S, _ = x.shape
    dh = head_dim(c)
    q = mm(x, P["wq"]).view(B, S, -1, dh)
    k = mm(x, P["wk"]).view(B, S, -1, dh)
    v = mm(x, P["wv"]).view(B, S, -1, dh)
    q, k = plain.rope(q, pos, c["rope_theta"]), plain.rope(k, pos,
                                                          c["rope_theta"])
    return mm(plain.attention(q, k, v, mm), P["wo"])


def _swiglu(x, P, mm):
    return mm(plain.silu(mm(x, P["wg"])) * mm(x, P["wu"]), P["wd"])


def _mamba(x, P, c, mm):
    B, S, _ = x.shape
    n, H = c["ssm_state"], ssm_heads(c)
    din = c["ssm_expand"] * c["d_model"]
    z = mm(x, P["wz"])
    dt = torch.nn.functional.softplus(mm(x, P["wdt"]) + P["dt_bias"])
    A = -torch.exp(P["A_log"])
    xbc = torch.cat([mm(x, P["wx"]), mm(x, P["wB"]), mm(x, P["wC"])], -1)
    xbc = plain.silu(plain.causal_conv(xbc, P["conv_w"], P["conv_b"]))
    xin, Bm, Cm = torch.split(xbc, [din, n, n], dim=-1)
    xh = xin.reshape(B, S, H, din // H)
    y = plain.ssd(xh, dt, A, Bm, Cm, c["ssm_chunk"], mm)
    y = (y + xh * P["D"][:, None]).reshape(B, S, din)
    g = plain.rms_norm(y * plain.silu(z), P["gn"], c["norm_eps"])
    return mm(g, P["out"])


def _shared(x, x0, P, c, pos, mm):
    eps = c["norm_eps"]
    h = mm(torch.cat([x, x0], dim=-1), P["win"])
    h = h + _attention(plain.rms_norm(h, P["norm.scale"], eps),
                       _sub(P, "attn."), c, pos, mm)
    return h + _swiglu(plain.rms_norm(h, P["norm2.scale"], eps),
                       _sub(P, "mlp."), mm)


def _unit(x, x0, U, S_, c, pos, mm):
    eps = c["norm_eps"]
    for name, norm, kind in blocks(c):
        if kind == SHARED:
            x = x + _shared(x, x0, S_, c, pos, mm)
            continue
        h = plain.rms_norm(x, U[f"{norm}.scale"], eps)
        P = _sub(U, f"{name}.")
        if kind == ATTN:
            x = x + _attention(h, P, c, pos, mm)
        elif kind == MLP:
            x = x + _swiglu(h, P, mm)
        elif kind == MAMBA2:
            x = x + _mamba(h, P, c, mm)
        else:
            raise ValueError(f"the reference has no block {kind!r}")
    return x


def forward(W: Dict[str, torch.Tensor], tokens: torch.Tensor, c: Dict,
            mm: Optional[Matmul] = None, *, last_only: bool = False,
            remat: bool = False) -> torch.Tensor:
    """Logits (B, S, V) in fp32 of the token ids (B, S); with
    ``last_only`` those of the last position, (B, 1, V).  ``remat``
    recomputes each repeat's activations in the backward (to fit a
    full-size model's fp32 gradient on one card)."""
    mm = mm or Matmul()
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    x = W["embed"][tokens]
    x0 = x
    shared = _sub(W, "shared.")
    for r in range(repeats(c)):
        U = _sub(W, f"units.{r}.blocks.")
        if remat:
            x = checkpoint(_unit, x, x0, U, shared, c, pos, mm,
                           use_reentrant=False)
        else:
            x = _unit(x, x0, U, shared, c, pos, mm)
    if last_only:
        x = x[:, -1:]
    x = plain.rms_norm(x, W["final_norm.scale"], c["norm_eps"])
    head = W["embed"].t() if c["tie_embeddings"] else W["lm_head"]
    return mm(x, head)


def loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over every position."""
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
