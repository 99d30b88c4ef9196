"""Parity of the port's Mamba2 SSD scan with the JAX package's.

The same inputs, drawn with numpy from a seed, go through the JAX Pallas
``mamba2_ssd`` kernel in interpret mode and the jnp oracle
``ref.ssd_chunked`` (as ``tests/test_kernels.py`` runs them), and through
the port's plain ``ssd_chunked`` (what the Hopper kernel computes),
``ssd_sequential``, ``ssd_decode_step`` and ``ops.mamba2_ssd``.

Tolerances: bf16 y within 2e-2 (atol = rtol, as ``tests/test_kernels.py``
states it: one bf16 rounding of y), states within 1e-3 as there.  fp32 y
across the two frameworks within 2e-5 of the largest |y|: the JAX test's
elementwise 2e-5 holds between the Pallas kernel and the jnp oracle, which
share XLA's summation orders, but not across frameworks, where sums of
terms up to ~50 that cancel leave elements near 0 with absolute errors of
~1e-4 (measured: at most 1.6e-4, below 3e-6 of the largest |y|).  Within
the port (chaining, the stepwise oracle) the JAX test's own bounds hold.
The kernel runs only on the card (``-m cuda`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.mamba2_ssd import mamba2_ssd as jax_ssd
from repro_torch.kernels import mamba2_ssd as ssd
from repro_torch.kernels import ops, ref

SHAPES = [                      # tests/test_kernels.py's (b, s, h, p, n, chunk)
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 64, 64),
    (1, 64, 8, 16, 32, 64),     # chunk == s
]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(b, s, h, p, n, seed):
    """x, dt = softplus(normal), A = -exp(normal), B, C as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def _torch(arrs, dtype=torch.float32):
    """x, dt, B, C in ``dtype``; A stays fp32."""
    x, dt, A, B, C = (torch.from_numpy(a) for a in arrs)
    return x.to(dtype), dt.to(dtype), A, B.to(dtype), C.to(dtype)


def _jax(arrs, dtype=jnp.float32):
    x, dt, A, B, C = (jnp.asarray(a) for a in arrs)
    return x.astype(dtype), dt.astype(dtype), A, B.astype(dtype), \
        C.astype(dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_y(got, want, dtype, against="the JAX reference"):
    got, want = _f32(got), _f32(want)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2,
                                   err_msg=f"y against {against}")
    else:
        err, top = np.abs(got - want).max(), np.abs(want).max()
        assert err <= 2e-5 * top, (f"y against {against}: max |diff| "
                                   f"{err}, max |y| {top}, torch threads "
                                   f"{torch.get_num_threads()}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_plain_ssd_matches_jax(b, s, h, p, n, chunk, dtype):
    tdt, jdt = DTYPES[dtype]
    arrs = _inputs(b, s, h, p, n, seed=b + s + h)
    y, st = ref.ssd_chunked(*_torch(arrs, tdt), chunk=chunk)
    assert y.dtype == tdt and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    jargs = _jax(arrs, jdt)
    for against, (want_y, want_st) in (
            ("the jnp oracle", jax_ref.ssd_chunked(*jargs, chunk=chunk)),
            ("the Pallas interpret run",
             jax_ssd(*jargs, chunk=chunk, interpret=True))):
        _assert_y(y, want_y, dtype, against)
        np.testing.assert_allclose(st.numpy(), _f32(want_st), atol=1e-3,
                                   rtol=1e-3,
                                   err_msg=f"state against {against}")


def test_init_state_chaining():
    """Two halves, the second from the first's final state, equal the
    whole (``test_mamba2_ssd_init_state_chaining``'s shape and bounds),
    through the port's plain scan and ``ops.mamba2_ssd``."""
    x, dt, A, B, C = _torch(_inputs(1, 128, 2, 16, 16, seed=3))
    y_full, st_full = ref.ssd_chunked(x, dt, A, B, C, chunk=32)
    y1, st1 = ops.mamba2_ssd(x[:, :64], dt[:, :64], A, B[:, :64],
                             C[:, :64], chunk=32)
    y2, st2 = ops.mamba2_ssd(x[:, 64:], dt[:, 64:], A, B[:, 64:],
                             C[:, 64:], chunk=32, init_state=st1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(st2.numpy(), st_full.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_chunked_matches_sequential():
    """The chunked scan equals the stepwise recurrence
    (``test_ssd_matches_sequential_decode``'s shape and bounds); the port's
    stepwise oracle equals the JAX one."""
    arrs = _inputs(2, 64, 2, 8, 8, seed=4)
    x, dt, A, B, C = _torch(arrs)
    y_seq, st_seq = ref.ssd_sequential(x, dt, A, B, C)
    y_chk, st_chk = ref.ssd_chunked(x, dt, A, B, C, chunk=16)
    np.testing.assert_allclose(y_chk.numpy(), y_seq.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(st_chk.numpy(), st_seq.numpy(), atol=1e-4,
                               rtol=1e-4)
    jy, jst = jax_ref.ssd_sequential(*_jax(arrs))
    np.testing.assert_allclose(y_seq.numpy(), _f32(jy), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(st_seq.numpy(), _f32(jst), atol=1e-5,
                               rtol=1e-5)


def test_decode_step_matches_jax():
    rng = np.random.default_rng(5)
    b, h, p, n = 2, 3, 16, 8
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    xt = rng.standard_normal((b, h, p)).astype(np.float32)
    dtt = np.logaddexp(rng.standard_normal((b, h)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bt = rng.standard_normal((b, n)).astype(np.float32)
    Ct = rng.standard_normal((b, n)).astype(np.float32)
    arrs = (state, xt, dtt, A, Bt, Ct)
    want_st, want_y = jax_ops.ssd_decode_step(*map(jnp.asarray, arrs))
    st, y = ops.ssd_decode_step(*map(torch.from_numpy, arrs))
    np.testing.assert_allclose(st.numpy(), _f32(want_st), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), _f32(want_y), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("s", [24, 12])
def test_ops_any_length_matches_jax(s):
    """``ops.mamba2_ssd``'s chunk rule: s = 24 with chunk 16 pads to 32 and
    slices y back, s = 12 with chunk 16 runs one chunk of 12 — against the
    JAX ``ops.mamba2_ssd(impl="ref")``."""
    arrs = _inputs(2, s, 4, 32, 16, seed=s)
    y, st = ops.mamba2_ssd(*_torch(arrs), chunk=16)
    want_y, want_st = jax_ops.mamba2_ssd(*_jax(arrs), chunk=16, impl="ref")
    assert y.shape == (2, s, 4, 32)
    _assert_y(y, want_y, "float32")
    np.testing.assert_allclose(st.numpy(), _f32(want_st), atol=1e-3,
                               rtol=1e-3)
    y_ref, st_ref = ops.mamba2_ssd(*_torch(arrs), chunk=16, impl="ref")
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)


@pytest.mark.parametrize("length", [1, 31, 32, 33, 256, 300])
def test_block_cumsum_is_a_cumsum(length):
    """The kernel's scan order, as the plain version takes it, is an
    inclusive cumsum (float64, so the order does not show)."""
    x = torch.from_numpy(np.random.default_rng(length).standard_normal(
        (3, length)))
    np.testing.assert_allclose(ref._block_cumsum(x).numpy(),
                               torch.cumsum(x, -1).numpy(), atol=1e-12)


@pytest.mark.parametrize("impl", [None, "cuda"])
def test_wrapper_takes_plain_version_for_cpu_tensors(impl):
    args = _torch(_inputs(1, 48, 2, 16, 8, seed=6))
    before = ssd.mamba2_ssd.launches
    y, st = ops.mamba2_ssd(*args, chunk=16, impl=impl)
    assert ssd.mamba2_ssd.launches == before
    y_ref, st_ref = ref.ssd_chunked(*args, chunk=16)
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)


@pytest.mark.parametrize("case,match", [
    ("rank", "expected"), ("dt", "do not match"), ("BC", "both be"),
    ("init", "init_state"), ("chunk", "multiple")])
def test_argument_checks(case, match):
    """The checks the wrapper runs before any launch (pure Python, so they
    are exercised here on CPU tensors)."""
    x, dt, A, B, C = _torch(_inputs(1, 24, 2, 16, 8, seed=7))
    init, chunk = None, 8
    if case == "rank":
        x = x[0]
    elif case == "dt":
        dt = dt[:, :, :1]
    elif case == "BC":
        C = C[:, :12]
    elif case == "init":
        init = torch.zeros(1, 2, 16, 9)
    else:
        chunk = 16
    with pytest.raises(ValueError, match=match):
        ssd.mamba2_ssd(x, dt, A, B, C, chunk=chunk, init_state=init)


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        ops.mamba2_ssd(*_torch(_inputs(1, 8, 1, 8, 8, seed=8)), chunk=8,
                       impl="pallas")


CARD_SHAPES = SHAPES + [
    (2, 64, 2, 8, 8, 16),       # p = n = 8 at chunk 16
    (1, 48, 2, 64, 16, 16),     # smoke zamba2's SSD
    (1, 12, 2, 64, 16, 12),     # a chunk of 12
    (1, 512, 2, 128, 128, 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,h,p,n,chunk", CARD_SHAPES)
def test_kernel_matches_plain_on_card(b, s, h, p, n, chunk, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt = DTYPES[dtype][0]
    arrs = _inputs(b, s, h, p, n, seed=9)
    args = [t.cuda() for t in _torch(arrs, tdt)]
    init = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (b, h, p, n)).astype(np.float32)).cuda()
    before = ssd.mamba2_ssd.launches
    y, st = ssd.mamba2_ssd(*args, chunk=chunk, init_state=init)
    y2, st2 = ssd.mamba2_ssd(*args, chunk=chunk, init_state=init)
    want_y, want_st = ref.ssd_chunked(*args, chunk=chunk, init_state=init)
    torch.cuda.synchronize()
    assert ssd.mamba2_ssd.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(st, st2)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(y.cpu()), _f32(want_y.cpu()), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(st.cpu().numpy(), want_st.cpu().numpy(),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case,err,match", [
    ("p", ValueError, "one of"), ("dtype", TypeError, "dtype"),
    ("A", TypeError, "float32"), ("chunk", ValueError, "above")])
def test_kernel_argument_checks_on_card(case, err, match):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, s, h, p, n = 1, 512, 2, 16, 8
    if case == "p":
        p = 24
    x, dt, A, B, C = (t.cuda() for t in _torch(_inputs(b, s, h, p, n, 11)))
    chunk = 512 if case == "chunk" else 64
    if case == "dtype":
        dt = dt.to(torch.bfloat16)
    elif case == "A":
        A = A.double()
    with pytest.raises(err, match=match):
        ssd.mamba2_ssd(x, dt, A, B, C, chunk=chunk)
