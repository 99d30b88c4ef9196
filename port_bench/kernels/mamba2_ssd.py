"""Operations and bytes of one call of the ``mamba2_ssd`` kernel
(``src/repro_torch/kernels/csrc/mamba2_ssd.cu``: three launches on the
``wgmma`` route, one on ``fma``), frozen here as the yardstick of its
roofline.

Operations of the chunked scan: in each chunk of L positions the lower
triangles of C·Bᵀ (n a pair) and of its product with x (p a pair), and
the chunk's state in and out (2 · L · p · n each), 2 operations a
multiply-add.  Bytes: x and y (b·s·h·p), dt (b·s·h), B and C (b·s·n) in
bf16, A (h) and the final state (b·h·p·n) in fp32, each once."""

import re

CALL = re.compile(r"mamba2_ssd_(chunk_out_)?kernel")
PARTS = re.compile(r"mamba2_ssd_\w*kernel")


def flops(b, s, h, p, n, chunk):
    tri = chunk * (chunk + 1) // 2
    return 2 * (tri * n + tri * p + 2 * chunk * p * n) * (s // chunk) * h * b


def nbytes(b, s, h, p, n):
    return 2 * (2 * b * s * h * p + b * s * h + 2 * b * s * n) \
        + 4 * h + 4 * b * h * p * n


def bound_s(peaks, b, s, h, p, n, chunk):
    return max(flops(b, s, h, p, n, chunk) / peaks["bf16_flops_per_s"],
               nbytes(b, s, h, p, n) / peaks["hbm_bytes_per_s"])
