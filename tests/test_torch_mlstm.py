"""Parity of the port's chunkwise mLSTM with the JAX package's.

The same inputs, drawn with numpy from a seed (the distributions of
``tests/test_kernels.py``'s mLSTM tests: q, k ~ N(0, 0.25), v ~ N(0, 1),
i ~ N(0, 1), f ~ N(2, 1)), go through the JAX Pallas ``mlstm_chunk``
kernel in interpret mode and the jnp ``ref.mlstm_chunked``, and through
the port's plain ``mlstm_chunked`` (what the Hopper kernel computes),
``mlstm_sequential``, ``mlstm_decode_step`` and ``ops.mlstm_chunked``.

Tolerances are ``tests/test_kernels.py``'s (atol = rtol unless stated):
y 2e-5 (fp32) and 2e-2 (bf16: one rounding of y); C 2e-4 (fp32) or 2e-2
(bf16) absolute with 2e-2 relative; m 1e-3.  The port's plain version
takes the kernel's summation order for the forget gates' cumsum and
-1e30 for the masked entries and the initial stabiliser, where the jnp
version takes ``jnp.cumsum`` and -inf; both stay within those bounds of
each other and of the Pallas body.  The kernel runs only on the card
(``-m cuda`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import mlstm_chunk as mk
from repro_torch.kernels import ops, ref

SHAPES = [(2, 64, 2, 16, 16), (1, 128, 4, 32, 64)]  # (b, s, h, d, chunk)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(b, s, h, d, seed):
    """q, k, v, i_gate, f_gate as float32 numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)) * 0.5
    k = rng.standard_normal((b, s, h, d)) * 0.5
    v = rng.standard_normal((b, s, h, d))
    ig = rng.standard_normal((b, s, h))
    fg = rng.standard_normal((b, s, h)) + 2.0
    return tuple(a.astype(np.float32) for a in (q, k, v, ig, fg))


def _torch(arrs, dtype=torch.float32):
    """q, k, v in ``dtype``; the gates stay fp32."""
    t = [torch.from_numpy(a) for a in arrs]
    return tuple(x.to(dtype) for x in t[:3]) + tuple(t[3:])


def _jax(arrs, dtype=jnp.float32):
    t = [jnp.asarray(a) for a in arrs]
    return tuple(x.astype(dtype) for x in t[:3]) + tuple(t[3:])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_result(got, want, dtype):
    (y, (C, n, m)), (wy, (wC, wn, wm)) = got, want
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(y), _f32(wy), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(C), _f32(wC), rtol=2e-2,
                               atol=2e-2 if dtype == "bfloat16" else 2e-4)
    np.testing.assert_allclose(_f32(n), _f32(wn), rtol=2e-2,
                               atol=2e-2 if dtype == "bfloat16" else 2e-4)
    np.testing.assert_allclose(_f32(m), _f32(wm), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,d,chunk", SHAPES)
def test_plain_mlstm_matches_jax(b, s, h, d, chunk, dtype):
    """The port's plain version against the jnp ``ref.mlstm_chunked``, the
    Pallas body in interpret mode and the jnp sequential oracle."""
    tdt, jdt = DTYPES[dtype]
    arrs = _inputs(b, s, h, d, seed=b + s + h)
    got = ref.mlstm_chunked(*_torch(arrs, tdt), chunk=chunk)
    y, (C, n, m) = got
    assert y.dtype == tdt and y.shape == (b, s, h, d)
    assert C.dtype == n.dtype == m.dtype == torch.float32
    assert (C.shape, n.shape, m.shape) == ((b, h, d, d), (b, h, d), (b, h))
    jargs = _jax(arrs, jdt)
    for want in (jax_ref.mlstm_chunked(*jargs, chunk=chunk),
                 jax_ops.mlstm_chunked(*jargs, chunk=chunk,
                                       impl="pallas_interpret"),
                 jax_ref.mlstm_sequential(*jargs)):
        _assert_result(got, want, dtype)


@pytest.mark.parametrize("b,s,h,d,chunk", [(2, 64, 4, 8, 16),
                                           (1, 128, 2, 16, 32)])
def test_chunked_matches_sequential(b, s, h, d, chunk):
    """The port's chunked scan against its stepwise oracle, and that
    oracle against the JAX one (``test_mlstm_chunked_vs_sequential``'s
    shapes and bounds)."""
    arrs = _inputs(b, s, h, d, seed=7)
    y_c, (C_c, n_c, m_c) = ref.mlstm_chunked(*_torch(arrs), chunk=chunk)
    y_s, (C_s, n_s, m_s) = ref.mlstm_sequential(*_torch(arrs))
    for got, want in ((y_c, y_s), (C_c, C_s), (n_c, n_s)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                                   rtol=2e-4)
    np.testing.assert_allclose(m_c.numpy(), m_s.numpy(), atol=1e-5,
                               rtol=1e-5)
    jy, (jC, jn, jm) = jax_ref.mlstm_sequential(*_jax(arrs))
    for got, want in ((y_s, jy), (C_s, jC), (n_s, jn), (m_s, jm)):
        np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5,
                                   rtol=1e-5)


def test_decode_step_matches_jax():
    """``mlstm_decode_step`` stepped over s from the zero state (m = -inf)
    against the JAX one, state and output at every step."""
    b, s, h, d = 2, 16, 3, 8
    arrs = _inputs(b, s, h, d, seed=8)
    q, k, v, ig, fg = _torch(arrs)
    jq, jk, jv, jig, jfg = _jax(arrs)
    state = (torch.zeros(b, h, d, d), torch.zeros(b, h, d),
             torch.full((b, h), float("-inf")))
    jstate = (jnp.zeros((b, h, d, d)), jnp.zeros((b, h, d)),
              jnp.full((b, h), -jnp.inf))
    for t in range(s):
        state, y = ops.mlstm_decode_step(state, q[:, t], k[:, t], v[:, t],
                                         ig[:, t], fg[:, t])
        jstate, jy = jax_ops.mlstm_decode_step(jstate, jq[:, t], jk[:, t],
                                               jv[:, t], jig[:, t],
                                               jfg[:, t])
        np.testing.assert_allclose(y.numpy(), _f32(jy), atol=1e-5,
                                   rtol=1e-5)
        for got, want in zip(state, jstate):
            np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("s", [24, 12])
def test_ops_any_length_matches_jax(s):
    """``ops.mlstm_chunked``'s chunk rule: s = 24 with chunk 16 pads to 32
    (i = -1e30, f = 30 on the padded steps) and slices y back, s = 12 runs
    one chunk of 12 -- against the JAX ``ops.mlstm_chunked(impl="ref")``;
    ``impl="ref"`` gives the same as the default on CPU tensors."""
    arrs = _inputs(2, s, 4, 16, seed=s)
    got = ops.mlstm_chunked(*_torch(arrs), chunk=16)
    assert got[0].shape == (2, s, 4, 16)
    _assert_result(got, jax_ops.mlstm_chunked(*_jax(arrs), chunk=16,
                                              impl="ref"), "float32")
    y_ref, st_ref = ops.mlstm_chunked(*_torch(arrs), chunk=16, impl="ref")
    assert torch.equal(got[0], y_ref)
    assert all(torch.equal(a, b) for a, b in zip(got[1], st_ref))


def test_init_chaining():
    """Two halves, the second from the first's final state (the plain
    version with an initial state, as the JAX ``ops`` routes it), equal
    the whole."""
    q, k, v, ig, fg = _torch(_inputs(1, 128, 2, 16, seed=3))
    y_full, st_full = ops.mlstm_chunked(q, k, v, ig, fg, chunk=32)
    y1, st1 = ops.mlstm_chunked(q[:, :64], k[:, :64], v[:, :64], ig[:, :64],
                                fg[:, :64], chunk=32)
    y2, st2 = ops.mlstm_chunked(q[:, 64:], k[:, 64:], v[:, 64:], ig[:, 64:],
                                fg[:, 64:], chunk=32, init=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=2e-5, rtol=2e-5)
    for got, want in zip(st2, st_full):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("impl", [None, "cuda"])
def test_wrapper_takes_plain_version_for_cpu_tensors(impl):
    args = _torch(_inputs(1, 48, 2, 16, seed=6))
    before = mk.mlstm_chunk.launches
    y, st = ops.mlstm_chunked(*args, chunk=16, impl=impl)
    assert mk.mlstm_chunk.launches == before
    y_ref, st_ref = ref.mlstm_chunked(*args, chunk=16)
    assert torch.equal(y, y_ref)
    assert all(torch.equal(a, b) for a, b in zip(st, st_ref))


@pytest.mark.parametrize("case,match", [
    ("rank", "expected"), ("k", "k "), ("v", "v "), ("i_gate", "i_gate"),
    ("f_gate", "f_gate"), ("chunk", "multiple")])
def test_argument_checks(case, match):
    """The checks the wrapper runs before any launch (pure Python, so they
    are exercised here on CPU tensors), each naming its argument."""
    q, k, v, ig, fg = _torch(_inputs(1, 24, 2, 16, seed=7))
    chunk = 8
    if case == "rank":
        q = q[0]
    elif case == "k":
        k = k[:, :12]
    elif case == "v":
        v = v[..., :8]
    elif case == "i_gate":
        ig = ig[:, :, :1]
    elif case == "f_gate":
        fg = fg[:, :12]
    else:
        chunk = 16
    with pytest.raises(ValueError, match=match):
        mk.mlstm_chunk(q, k, v, ig, fg, chunk=chunk)


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        ops.mlstm_chunked(*_torch(_inputs(1, 8, 1, 16, seed=8)), chunk=8,
                          impl="pallas")


CARD_SHAPES = SHAPES + [
    (1, 48, 4, 32, 16),         # smoke xlstm's prefill (prompt 48)
    (1, 12, 2, 64, 12),         # a chunk of 12
    (1, 512, 2, 512, 256),      # xlstm-350m's head dim at its chunk
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,d,chunk", CARD_SHAPES)
def test_kernel_matches_plain_on_card(b, s, h, d, chunk, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt = DTYPES[dtype][0]
    args = [t.cuda() for t in _torch(_inputs(b, s, h, d, seed=9), tdt)]
    before = mk.mlstm_chunk.launches
    got = mk.mlstm_chunk(*args, chunk=chunk)
    again = mk.mlstm_chunk(*args, chunk=chunk)
    want = ref.mlstm_chunked(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert mk.mlstm_chunk.launches == before + 2
    assert torch.equal(got[0], again[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], again[1]))
    cpu = lambda r: (r[0].cpu(), tuple(t.cpu() for t in r[1]))  # noqa: E731
    _assert_result(cpu(got), cpu(want), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case,err,match", [
    ("d", ValueError, "multiple of 16"), ("dtype", TypeError, "dtype"),
    ("gate", TypeError, "float32"), ("chunk", ValueError, "above")])
def test_kernel_argument_checks_on_card(case, err, match):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = 24 if case == "d" else 16
    q, k, v, ig, fg = (t.cuda() for t in _torch(_inputs(1, 512, 2, d, 11)))
    chunk = 512 if case == "chunk" else 64
    if case == "dtype":
        k = k.to(torch.bfloat16)
    elif case == "gate":
        ig = ig.double()
    with pytest.raises(err, match=match):
        mk.mlstm_chunk(q, k, v, ig, fg, chunk=chunk)
