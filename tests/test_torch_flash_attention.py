"""Parity of the port's attention with the JAX package's.

The same inputs, drawn with numpy from a seed, go through the JAX Pallas
``flash_attention`` kernel in interpret mode (as ``tests/test_kernels.py``
runs it), the JAX dense oracle ``ref.attention``, and the port's plain
``flash_attention`` (the key-tile loop the Hopper kernel computes) and
dense ``attention``.  Tolerances are those of ``tests/test_kernels.py``:
2e-5 in fp32, 2e-2 in bf16 (one bf16 rounding of the output, 2^-8
relative, on values of order 1), compared in fp32.  The kernel itself
runs only on the card (``-m cuda`` and ``chip_smoke.py``); the bf16
kernel's one departure from the reference's arithmetic, P rounded to bf16
before P . V, is emulated here in plain torch and held to the same gate.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as fa

CASES = [
    (1, 256, 4, 2, 64, True, None),     # GQA causal
    (2, 128, 8, 8, 128, False, None),   # MHA bidirectional (encoder)
    (1, 256, 4, 1, 64, True, 64),       # MQA + sliding window
    (2, 512, 2, 2, 32, True, None),     # long-ish causal
    (1, 128, 6, 2, 80, True, None),     # non-128 head dim (zamba2/hubert)
]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _qkv(B, S, T, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", CASES)
def test_plain_flash_and_dense_match_jax(B, S, H, Hkv, D, causal, window,
                                         dtype):
    tdt, jdt = DTYPES[dtype]
    arrs = _qkv(B, S, S, H, Hkv, D, seed=S + H + D)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrs)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrs)
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=64, block_k=64, interpret=True)
    oracle = jax_ref.attention(jq, jk, jv, causal=causal, window=window)
    flash = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                impl="ref")
    dense = ref.attention(tq, tk, tv, causal=causal, window=window)
    for out in (flash, dense):
        assert out.dtype == tdt and out.shape == (B, S, H, D)
        np.testing.assert_allclose(_f32(out), _f32(pallas), **_tol(dtype))
        np.testing.assert_allclose(_f32(out), _f32(oracle), **_tol(dtype))


def _kernel_block_k(D):
    """The bf16 kernel's key tile (csrc/flash_attention.cu,
    bf16::Tile<D>::kBK): 128 keys, 64 at D = 128."""
    return 64 if D == 128 else 128


def _bf16_kernel_numerics(q, k, v, *, causal, window):
    """The bf16 kernel's arithmetic in plain torch: per key tile of
    ``_kernel_block_k(D)`` keys, fp32 scores times 1/sqrt(D) * log2(e), masked to
    NEG_INF, the online softmax in base 2 in fp32, l summed from the fp32
    p, and P rounded to bf16 before P . V, accumulated in fp32."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    c = torch.tensor(1.4426950408889634 / D ** 0.5, dtype=torch.float32)
    qf = q.float().reshape(B, S, Hkv, rep, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]      # (B, Hkv, 1, T, D)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    pos = torch.arange(S)[:, None]
    neg = torch.tensor(ref.NEG_INF)
    m = torch.full((B, Hkv, rep, S), ref.NEG_INF)
    l = torch.zeros((B, Hkv, rep, S))
    acc = torch.zeros((B, Hkv, rep, S, D))
    block_k = _kernel_block_k(D)
    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        s = torch.matmul(qf, kf[..., k0:k1, :].transpose(-1, -2)) * c
        key = torch.arange(k0, k1)[None, :]
        ok = torch.ones((S, k1 - k0), dtype=torch.bool)
        if causal:
            ok &= key <= pos
        if window is not None:
            ok &= key > pos - window
        s = torch.where(ok, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp2(s - m_new[..., None]), 0.0)
        alpha = torch.where(m == ref.NEG_INF, 0.0, torch.exp2(m - m_new))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(torch.bfloat16).float(), vf[..., k0:k1, :])
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).to(torch.bfloat16)       # (B, Hkv, rep, S, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window", CASES)
def test_bf16_rounding_point_matches_jax(B, S, H, Hkv, D, causal, window):
    """The bf16 kernel rounds P to bf16 before P . V where the reference
    keeps it in fp32 (the choice SDPA makes too): emulated on the same bf16
    inputs, it stays within the bf16 tolerance of the JAX Pallas kernel."""
    arrs = _qkv(B, S, S, H, Hkv, D, seed=S + H + D)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window,
                       block_q=64, block_k=64, interpret=True)
    got = _bf16_kernel_numerics(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **_tol("bfloat16"))


def test_build_key_follows_shared_headers(tmp_path, monkeypatch):
    """A kernel library is keyed by its source, every shared header of
    ``csrc/`` and the flags, so a changed header is rebuilt, never loaded
    stale (only the key is computed here: no nvcc)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "_build")
    first = {n: build._target(n) for n in ("flash_attention", "moe_gmm")}
    assert {n: build._target(n) for n in first} == first
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    second = {n: build._target(n) for n in first}
    assert all(second[n] != first[n] for n in first)
    (csrc / "extra.cuh").write_text("// a new shared header\n")
    third = build._target("flash_attention")
    assert third not in (first["flash_attention"], second["flash_attention"])
    src = csrc / "flash_attention.cu"
    src.write_text(src.read_text() + "\n")
    assert build._target("flash_attention") not in (
        first["flash_attention"], second["flash_attention"], third)
    assert build._target("moe_gmm") == build._target("moe_gmm")


@pytest.mark.parametrize("S,T,causal,window", [
    (1000, 1000, True, None), (1, 2080, False, None), (77, 77, True, 13),
    (130, 200, False, None)])
def test_plain_flash_ragged_against_dense(S, T, causal, window):
    """Any S and T (the Pallas wrapper's S % block_q == 0 is a TPU tiling
    limit): the key-tile loop's ragged last tile against the dense oracle,
    fp32 within 2e-5."""
    q, k, v = map(torch.from_numpy, _qkv(1, S, T, 4, 2, 64, seed=S + T))
    got = ref.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("window", [None, 16])
def test_decode_mask_matches_jax(window):
    """The decode step's attention over a fixed-size cache: one query at
    ``q_offset`` against ``kv_valid_len`` valid positions, per batch row
    (tensor offsets) and as ints (what the port's decode passes), fp32
    within 2e-5."""
    B, T, H, Hkv, D = 2, 48, 4, 2, 32
    q, k, v = _qkv(B, 1, T, H, Hkv, D, seed=5)
    offs = np.array([20, 37], np.int32)
    want = jax_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window,
                             kv_valid_len=jnp.asarray(offs + 1),
                             q_offset=jnp.asarray(offs))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ref.attention(tq, tk, tv, causal=True, window=window,
                        kv_valid_len=torch.from_numpy(offs + 1).long(),
                        q_offset=torch.from_numpy(offs).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    for b in range(B):
        one = ops.attention_ref(tq[b:b + 1], tk[b:b + 1], tv[b:b + 1],
                                causal=True, window=window,
                                kv_valid_len=int(offs[b]) + 1,
                                q_offset=int(offs[b]))
        np.testing.assert_allclose(one.numpy(), np.asarray(want)[b:b + 1],
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", [None, "cuda"])
def test_wrapper_takes_plain_version_for_cpu_tensors(impl):
    q, k, v = map(torch.from_numpy, _qkv(1, 70, 70, 4, 2, 64, seed=1))
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, impl=impl)
    assert fa.flash_attention.launches == before
    assert torch.equal(got, ref.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("case,match", [
    ("heads", "multiple"), ("rank", "4-D"), ("batch", "batch"),
    ("kv", "differ"), ("dtype", "dtype")])
def test_argument_checks(case, match):
    """The checks the wrapper runs before any launch (pure Python, so they
    are exercised here on CPU tensors)."""
    q, k, v = torch.zeros(1, 8, 4, 64), torch.zeros(1, 8, 2, 64), \
        torch.zeros(1, 8, 2, 64)
    if case == "heads":
        k = v = torch.zeros(1, 8, 3, 64)
    elif case == "rank":
        q = torch.zeros(8, 4, 64)
    elif case == "batch":
        k = v = torch.zeros(2, 8, 2, 64)
    elif case == "kv":
        v = torch.zeros(1, 9, 2, 64)
    else:
        k = k.double()
    with pytest.raises((ValueError, TypeError), match=match):
        ops.flash_attention(q, k, v)


def test_unknown_impl_raises():
    q, k, v = torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 2, 32), \
        torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal,window", [
    c[:2] + (c[1],) + c[2:] for c in CASES] + [
    (1, 1000, 1000, 4, 2, 64, True, None),
    (1, 1, 2080, 4, 2, 64, False, None),
    (1, 32, 32, 4, 2, 16, True, None),     # smoke-scale granite-3-2b
    (2, 1000, 1000, 4, 2, 80, True, None),  # T ragged at batch 0's end
    (1, 300, 300, 32, 1, 128, True, None),  # MQA: 32 heads in one block
    (2, 77, 200, 8, 2, 64, False, 50),     # S != T with a window
    (1, 130, 257, 6, 2, 16, False, None),  # 126 of 128 rows, ragged T
    (2, 200, 333, 4, 4, 32, True, 64)])    # ragged S and T, causal window
def test_kernel_matches_plain_on_card(B, S, T, H, Hkv, D, causal, window,
                                      dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt = DTYPES[dtype][0]
    q, k, v = (torch.from_numpy(a).to("cuda", tdt)
               for a in _qkv(B, S, T, H, Hkv, D, seed=3))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


@pytest.mark.cuda
def test_bf16_kernel_rejects_misaligned_inputs():
    """TMA reads q, k and v from 16-byte boundaries: a contiguous bf16 view
    that starts 2 bytes in is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, S, H, D = 1, 64, 4, 64
    flat = torch.zeros(B * S * H * D + 1, dtype=torch.bfloat16, device="cuda")
    q = flat[1:].view(B, S, H, D)
    k = v = torch.zeros(B, S, 2, D, dtype=torch.bfloat16, device="cuda")
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before
