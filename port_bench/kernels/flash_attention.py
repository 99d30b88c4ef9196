"""Operations and bytes of one call of the ``flash_attention`` kernel
(``src/repro_torch/kernels/csrc/flash_attention.cu``), frozen here as the
yardstick of its roofline.

Operations: QKᵀ and PV, 2 · 2 · B · S · T · D · H, of which a causal call
needs the half at or below the diagonal.  Bytes: q, k, v read once and
the output written once in bf16, and the fp32 log-sum-exp of each row
where the call writes it (a training forward)."""

import re

# One launch per call; a call that writes the log-sum-exp also launches
# fill_neg_inf, which counts in its time.
LAUNCH = re.compile(r"flash_attention(_bf16)?_kernel")
PARTS = re.compile(r"flash_attention(_bf16)?_kernel|fill_neg_inf")


def flops(B, S, T, H, D, causal=True):
    f = 2 * 2 * B * S * T * D * H
    return f / 2 if causal else f


def nbytes(B, S, T, H, Hkv, D, lse=False, elem=2):
    return elem * (2 * B * S * H * D + 2 * B * T * Hkv * D) \
        + (4 * B * H * S if lse else 0)


def bound_s(peaks, B, S, T, H, Hkv, D, causal=True, lse=False):
    """The least time of one call on the card: operations at the bf16
    peak or bytes at the memory peak, whichever is longer."""
    return max(flops(B, S, T, H, D, causal) / peaks["bf16_flops_per_s"],
               nbytes(B, S, T, H, Hkv, D, lse) / peaks["hbm_bytes_per_s"])
