"""Port parity: the ``gs_stencil`` kernel module of ``repro_torch`` against
the JAX package's Pallas kernel (interpret mode) and its jnp oracle.

The same inputs, drawn with numpy from a seed, go through both packages.
Block and edges must match bitwise (the update is elementwise fp32 in one
order on both sides); the residual within rtol 1e-6, because jnp and torch
sum the |new - old| terms in different orders.  On the CPU the kernel
wrapper takes the plain version; the kernel itself is checked on the card
(``-m cuda``, and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import collective_stages as stages
from repro_torch.kernels import ops, ref

RES_RTOL = 1e-6
SHAPES = [(16, 16), (8, 32), (17, 5)]


def _inputs(H, W, seed):
    """Block and four DISTINCT halos (top, left, bottom, right): a swap of
    arguments or of returned edges cannot pass."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((H, W), W, H, W, H)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_matches(port, ref_out):
    new, res, edges = port
    new_r, res_r, edges_r = ref_out
    np.testing.assert_array_equal(_np(new), _np(new_r))
    for e, er in zip(edges, edges_r):
        np.testing.assert_array_equal(_np(e), _np(er))
    np.testing.assert_allclose(float(res), float(res_r), rtol=RES_RTOL)


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "oracle"])
def test_gs_stencil_matches_jax(H, W, jax_impl):
    arrs = _inputs(H, W, H * W)
    port = ops.gs_stencil(*map(torch.from_numpy, arrs), impl="ref")
    jargs = [jnp.asarray(a) for a in arrs]
    if jax_impl == "oracle":
        want = jax_ref.gs_stencil(*jargs)
    else:
        want = jax_ops.gs_stencil(*jargs, impl="pallas_interpret")
    _assert_matches(port, want)


@pytest.mark.parametrize("H,W", SHAPES)
def test_gs_stencil_edge_order(H, W):
    """Arguments are (top, left, bottom, right); edges come back as the
    NEW block's (top row, bottom row, left column, right column)."""
    arrs = _inputs(H, W, 7 + H)
    new, _, (te, be, le, re) = ops.gs_stencil(
        *map(torch.from_numpy, arrs), impl="ref")
    for got, want in ((te, new[0]), (be, new[-1]), (le, new[:, 0]),
                      (re, new[:, -1])):
        assert torch.equal(got, want)
    # the top halo feeds row 0 only: changing it leaves the bottom row
    arrs2 = list(arrs)
    arrs2[1] = arrs[1] + 1.0
    new2, _, _ = ops.gs_stencil(*map(torch.from_numpy, arrs2), impl="ref")
    assert not torch.equal(new2[0], new[0])
    if H > 1:
        assert torch.equal(new2[-1], new[-1])


def test_gs_stencil_bf16_with_bf16_halos():
    H, W = 16, 16
    arrs = _inputs(H, W, 11)
    port = ops.gs_stencil(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in arrs), impl="ref")
    want = jax_ops.gs_stencil(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs),
        impl="pallas_interpret")
    assert port[0].dtype == torch.bfloat16
    assert all(e.dtype == torch.bfloat16 for e in port[2])
    assert port[1].dtype == torch.float32     # residual stays fp32
    _assert_matches(port, want)


@pytest.mark.parametrize("impl", [None, "cuda"])
def test_wrapper_takes_plain_version_for_cpu_tensors(impl):
    """On CPU tensors the kernel wrapper runs the plain version — and
    counts no launch; the dispatch default is the kernel wrapper."""
    arrs = [torch.from_numpy(a) for a in _inputs(17, 5, 3)]
    before = stages.gs_stencil.launches
    got = ops.gs_stencil(*arrs, impl=impl)
    want = ref.gs_stencil(*arrs)
    assert stages.gs_stencil.launches == before
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for e, ew in zip(got[2], want[2]):
        assert torch.equal(e, ew)


def test_unknown_impl_raises():
    arrs = [torch.from_numpy(a) for a in _inputs(4, 4, 0)]
    with pytest.raises(ValueError, match="impl"):
        ops.gs_stencil(*arrs, impl="pallas")


@pytest.mark.parametrize("case,match", [
    ("noncontig", "contiguous"), ("length", "shape"), ("dtype", "dtype"),
    ("rank", "2-D")])
def test_cuda_argument_checks(case, match):
    """The checks the wrapper runs before a launch (pure Python, so they
    are exercised here on CPU tensors)."""
    block = torch.zeros(6, 4)
    halos = [torch.zeros(4), torch.zeros(6), torch.zeros(4), torch.zeros(6)]
    if case == "noncontig":
        halos[1] = torch.zeros(6, 2)[:, 0]
    elif case == "length":
        halos[2] = torch.zeros(5)
    elif case == "dtype":
        block = block.double()
    else:
        block = torch.zeros(24)
    with pytest.raises((ValueError, TypeError), match=match):
        stages._check_cuda_args(block, halos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W", [(1024, 1024), (17, 5), (1000, 1023)])
def test_kernel_matches_plain_on_card(H, W, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    arrs = [torch.from_numpy(a).to("cuda", dt)
            for a in _inputs(H, W, H + W)]
    before = stages.gs_stencil.launches
    new, res, edges = stages.gs_stencil(*arrs)
    _, res2, _ = stages.gs_stencil(*arrs)
    new_p, res_p, edges_p = ref.gs_stencil(*arrs)
    torch.cuda.synchronize()
    assert stages.gs_stencil.launches == before + 2
    assert torch.equal(new, new_p)
    for e, ep in zip(edges, edges_p):
        assert torch.equal(e, ep)
    assert torch.equal(res, res2)            # no atomics: reproducible
    np.testing.assert_allclose(res.item(), res_p.item(), rtol=1e-5)
