"""The frozen operation and byte arithmetic against counts by hand at the
cells' shapes."""

import json

import pytest

from port_bench import flops
from port_bench.kernels import flash_attention as fa
from port_bench.kernels import mamba2_ssd as ssd
from port_bench.tests import tiny


def _port(name):
    return json.loads((tiny.REPO / "port_bench" / "configs"
                       / f"{name}.json").read_text())["port"]


def test_flash_attention_counts():
    # granite's train shape (1, 4096, 32/8, 64), causal half
    assert fa.flops(1, 4096, 4096, 32, 64) == 2 * 2 * 4096 * 4096 * 64 * 32 / 2
    assert fa.flops(1, 4096, 4096, 32, 64) == pytest.approx(68.72e9, rel=1e-4)
    q = o = 4096 * 32 * 64 * 2
    k = v = 4096 * 8 * 64 * 2
    assert fa.nbytes(1, 4096, 4096, 32, 8, 64) == q + k + v + o
    assert fa.nbytes(1, 4096, 4096, 32, 8, 64, lse=True) == \
        q + k + v + o + 4096 * 32 * 4
    # zamba2's shared attention (1, 4096, 32/32, 80): bytes 4 x 20.97 MB
    assert fa.nbytes(1, 4096, 4096, 32, 32, 80) == 4 * 4096 * 32 * 80 * 2
    peaks = flops.peaks()
    assert fa.bound_s(peaks, 1, 4096, 4096, 32, 8, 64) == pytest.approx(
        68.72e9 / 989e12, rel=1e-4)


def test_mamba2_ssd_counts():
    # PERF.md's kernel row 6: (1, 2048, 80, 64), n 64, chunk 256
    assert ssd.flops(1, 2048, 80, 64, 64, 256) == pytest.approx(8.074e9,
                                                                rel=1e-4)
    assert ssd.nbytes(1, 2048, 80, 64, 64) == pytest.approx(44.106e6,
                                                            rel=1e-5)
    tri = 256 * 257 // 2
    per_chunk_head = 2 * (tri * 64 + tri * 64 + 2 * 256 * 64 * 64)
    assert ssd.flops(1, 4096, 80, 64, 64, 256) == per_chunk_head * 16 * 80


def test_granite_training_operations_a_token():
    c = _port("granite-3-2b")
    n_body = 40 * (2 * 2048 * 2048 + 2 * 2048 * 512 + 3 * 2048 * 8192)
    assert n_body == 2_432_696_320
    head = 6 * 2048 * 49155
    attn = 12 * 40 * 32 * 64 * 4096
    assert flops.train_per_token(c, 4096) == pytest.approx(
        6 * n_body + head + attn)
    assert flops.train_per_token(c, 4096) == pytest.approx(19.2267e9,
                                                           rel=1e-4)


def test_zamba2_prefill_operations():
    c = _port("zamba2-2.7b")
    S, d, din, n, H = 4096, 2560, 5120, 64, 80
    mamba = 2 * S * (d * (2 * din + 2 * n + H) + din * d) \
        + 2 * S * 4 * (din + 2 * n) + ssd.flops(1, S, H, 64, n, 256)
    shared = 2 * S * 2 * d * d + 2 * S * (4 * d * d) \
        + 4 * S * S * 32 * 80 + 2 * S * 3 * d * 10240
    head = 2 * d * 32000
    assert flops.forward(c, S, 1) == 54 * mamba + 9 * shared + head
