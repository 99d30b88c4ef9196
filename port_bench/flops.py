"""Model operations of a forward pass, counted from a configuration's
``port`` section, as PaLM's appendix B counts them (arXiv:2204.02311):
2 operations a multiply-add of every product with a weight (a weight used
by several blocks, as Zamba2's shared block, counts at each use), the LM
head's product where logits are made, attention's QKᵀ and PV over the
full S × S square (not its causal half), and the Mamba2 scan as its
kernel's yardstick counts it.  No recomputation.  Training is three
forward passes' worth (the backward twice the forward)."""

import json
from pathlib import Path

from port_bench.kernels import mamba2_ssd

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks():
    with open(PEAKS) as f:
        return json.load(f)


def _head_dim(c):
    return c.get("d_head") or c["d_model"] // c["n_heads"]


def _attn(c, S):
    d, dh, H, Hkv = c["d_model"], _head_dim(c), c["n_heads"], c["n_kv_heads"]
    proj = 2 * S * (d * H * dh + 2 * d * Hkv * dh + H * dh * d)
    return proj + 2 * 2 * S * S * H * dh


def _mlp(c, S):
    return 2 * S * 3 * c["d_model"] * c["d_ff"]


def _mamba2(c, S):
    d, n, K = c["d_model"], c["ssm_state"], c["ssm_conv"]
    din = c["ssm_expand"] * d
    H = c.get("ssm_heads") or max(1, din // 64)
    proj = 2 * S * (d * (2 * din + 2 * n + H) + din * d)
    conv = 2 * S * K * (din + 2 * n)
    return proj + conv + mamba2_ssd.flops(1, S, H, din // H, n,
                                          c["ssm_chunk"])


def _shared(c, S):
    return 2 * S * 2 * c["d_model"] * c["d_model"] + _attn(c, S) \
        + _mlp(c, S)


BLOCKS = {"attn": _attn, "mlp": _mlp, "mamba2": _mamba2,
          "shared_attn": _shared}


def forward(c, S, logit_positions):
    """Operations of one sequence of ``S`` tokens, logits at
    ``logit_positions`` of them."""
    reps = c["n_layers"] // len(c["pattern"])
    body = sum(BLOCKS[kind](c, S) for layer in c["pattern"]
               for kind in layer)
    return reps * body + 2 * logit_positions * c["d_model"] * c["vocab"]


def train_per_token(c, S):
    """Training operations a token, sequences of ``S`` tokens."""
    return 3 * forward(c, S, S) / S
