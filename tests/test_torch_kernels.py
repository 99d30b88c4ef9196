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


# ---------------------------------------------------------------------------
# Level-B stage kernels: fused_combine, quantize_wire, dequantize_wire
# ---------------------------------------------------------------------------
# fp32 and the widening bf16 cast are bitwise on both sides; the int8
# dequant-add is bitwise against the jnp oracle (the same two roundings)
# and within 2e-6 of the Pallas kernel, which may contract an FMA.  The
# int8 quantisation is held against the oracle (a true division); the
# Pallas kernel multiplies by 1/scale and may differ at a .5 boundary.
def _wire_inputs(m, wire):
    rng = np.random.default_rng(m)
    acc = rng.standard_normal(m).astype(np.float32)
    got32 = rng.standard_normal(m).astype(np.float32)
    jacc, jgot32 = jnp.asarray(acc), jnp.asarray(got32)
    tacc, tgot32 = torch.from_numpy(acc), torch.from_numpy(got32)
    if wire == "fp32":
        return (jacc, jgot32, None), (tacc, tgot32, None)
    if wire == "bf16":
        return ((jacc, jgot32.astype(jnp.bfloat16), None),
                (tacc, tgot32.to(torch.bfloat16), None))
    jq, jscale = jax_ops.quantize_stage(jgot32, impl="ref")
    q, scale = ops.quantize_stage(tgot32, impl="ref")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.dtype == torch.float32 and scale.dim() == 0
    assert float(scale) == float(jscale)
    return (jacc, jq, jscale), (tacc, q, scale)


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("m", [64, 257, 1031, 4096])
def test_combine_stage_matches_jax(m, wire, accumulate):
    (jacc, jgot, jscale), (acc, got, scale) = _wire_inputs(m, wire)
    want = jax_ref.combine_stage(jacc, jgot, jscale, accumulate=accumulate)
    pallas = jax_ops.combine_stage(jacc, jgot, jscale, accumulate=accumulate,
                                   impl="pallas_interpret")
    for impl in ("ref", "cuda"):
        got_t = ops.combine_stage(acc, got, scale, accumulate=accumulate,
                                  impl=impl)
        assert got_t.dtype == torch.float32 and got_t.shape == (m,)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))
        if wire == "int8":
            np.testing.assert_allclose(got_t.numpy(), np.asarray(pallas),
                                       atol=2e-6)
        else:
            np.testing.assert_array_equal(got_t.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
def test_combine_stage_bf16_accumulator_matches_jax(wire):
    """A bf16 accumulator (compress="bf16" rings): the add runs in fp32
    and rounds once to bf16 on both sides."""
    (jacc, jgot, jscale), (acc, got, scale) = _wire_inputs(1031, wire)
    jacc, acc = jacc.astype(jnp.bfloat16), acc.to(torch.bfloat16)
    for accumulate in (True, False):
        want = jax_ref.combine_stage(jacc, jgot, jscale,
                                     accumulate=accumulate)
        port = ops.combine_stage(acc, got, scale, accumulate=accumulate,
                                 impl="ref")
        assert port.dtype == torch.bfloat16
        np.testing.assert_array_equal(port.float().numpy(),
                                      np.asarray(want, np.float32))


def test_combine_stage_out_in_place():
    (_, _, _), (acc, got, scale) = _wire_inputs(257, "int8")
    want = ref.combine_stage(acc, got, scale)
    buf = acc.clone()
    out = ops.combine_stage(buf, got, scale, impl="cuda", out=buf)
    assert out.data_ptr() == buf.data_ptr()
    assert torch.equal(buf, want)


def _half_boundaries():
    """x / scale lands exactly on k + 0.5 (scale = 15.875 / 127 = 0.125)."""
    half = np.arange(-127, 127, dtype=np.float32) + 0.5
    return np.concatenate([half * np.float32(0.125),
                           np.float32([15.875, -15.875])]).astype(np.float32)


@pytest.mark.parametrize("m", [1031, 1034])
def test_quantize_scale_is_a_true_division(m):
    """The wire scale is fl(max|x| / 127), one rounding, as the JAX
    package's source writes it.  ``_wire_inputs``' int8 draw of 1034
    elements is a case where max|x| * fl(1/127) lands one ulp lower, which
    an XLA that divides by a constant through its reciprocal returns."""
    rng = np.random.default_rng(m)
    rng.standard_normal(m)                       # the accumulator's draw
    x = rng.standard_normal(m).astype(np.float32)
    amax = np.abs(x).max()
    want = amax / np.float32(127.0)
    for impl in ("ref", "cuda"):
        _, scale = ops.quantize_stage(torch.from_numpy(x), impl=impl)
        assert float(scale) == float(want)
    by_reciprocal = amax * (np.float32(1.0) / np.float32(127.0))
    assert (float(by_reciprocal) != float(want)) == (m == 1034)


@pytest.mark.parametrize("m", [63, 640, 2049, "half"])
def test_quantize_dequantize_stage_matches_jax(m):
    if m == "half":
        x = _half_boundaries()
    else:
        x = (np.random.default_rng(m).standard_normal(m) * 11.0
             ).astype(np.float32)
    jq, jscale = jax_ops.quantize_stage(jnp.asarray(x), impl="ref")
    for impl in ("ref", "cuda"):
        q, scale = ops.quantize_stage(torch.from_numpy(x), impl=impl)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            deq = ops.dequantize_stage(q, scale, dt, impl=impl)
            want = jax_ref.dequantize_stage(jq, jscale, jdt)
            pallas = jax_ops.dequantize_stage(jq, jscale, jdt,
                                              impl="pallas_interpret")
            assert deq.dtype == dt
            for w in (want, pallas):
                np.testing.assert_array_equal(deq.float().numpy(),
                                              np.asarray(w, np.float32))
    if m == "half":
        assert float(jscale) == 0.125
        want = np.round(np.arange(-127, 127) + 0.5)      # half to even
        np.testing.assert_array_equal(q.numpy()[:254], want.astype(np.int8))


def test_quantize_stage_bf16_input_matches_jax():
    x = (np.random.default_rng(5).standard_normal(640) * 3).astype(
        np.float32)
    jq, jscale = jax_ops.quantize_stage(jnp.asarray(x, jnp.bfloat16),
                                        impl="ref")
    q, scale = ops.quantize_stage(torch.from_numpy(x).to(torch.bfloat16),
                                  impl="cuda")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


@pytest.mark.parametrize("fn", ["combine", "quantize", "dequantize"])
def test_stage_wrappers_take_plain_version_for_cpu_tensors(fn):
    """CPU tensors never reach a kernel: no launch is counted."""
    (_, _, _), (acc, q, scale) = _wire_inputs(257, "int8")
    before = (stages.fused_combine.launches, stages.quantize_wire.launches,
              stages.dequantize_wire.launches)
    if fn == "combine":
        assert torch.equal(stages.fused_combine(acc, q, scale),
                           ref.combine_stage(acc, q, scale))
    elif fn == "quantize":
        assert torch.equal(stages.quantize_wire(acc, scale),
                           ref.quantize_stage(acc, scale))
    else:
        assert torch.equal(stages.dequantize_wire(q, scale),
                           ref.dequantize_stage(q, scale))
    assert (stages.fused_combine.launches, stages.quantize_wire.launches,
            stages.dequantize_wire.launches) == before


@pytest.mark.parametrize("case,match", [
    ("shape", "shape"), ("acc_dtype", "dtype"), ("got_dtype", "dtype"),
    ("noncontig", "contiguous"), ("out_dtype", "dtype")])
def test_fused_combine_argument_checks(case, match):
    acc, got, out = torch.zeros(8), torch.zeros(8), None
    if case == "shape":
        got = torch.zeros(9)
    elif case == "acc_dtype":
        acc = acc.double()
    elif case == "got_dtype":
        got = got.to(torch.int32)
    elif case == "noncontig":
        acc, got = torch.zeros(8, 2)[:, 0], torch.zeros(8, 2)[:, 0]
    else:
        out = torch.zeros(8, dtype=torch.bfloat16)
    with pytest.raises((ValueError, TypeError), match=match):
        stages._check_combine_args(acc, got, None, out)


@pytest.mark.parametrize("fn", ["combine", "quantize", "dequantize"])
def test_stage_unknown_impl_raises(fn):
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="impl"):
        if fn == "combine":
            ops.combine_stage(x, x, impl="pallas")
        elif fn == "quantize":
            ops.quantize_stage(x, impl="pallas_interpret")
        else:
            ops.dequantize_stage(x.to(torch.int8), 1.0, impl="pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 257, 1031, (1 << 20) + 3])
def test_stage_kernels_match_plain_on_card(m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    before = stages.fused_combine.launches
    n = 0
    for wire in ("fp32", "bf16", "int8"):
        (_, _, _), (acc, got, scale) = _wire_inputs(m, wire)
        acc, got = acc.cuda(), got.cuda()
        scale = None if scale is None else scale.cuda()
        for a in (acc, acc.to(torch.bfloat16)):
            for accumulate in (True, False):
                k = stages.fused_combine(a, got, scale,
                                         accumulate=accumulate)
                p = ref.combine_stage(a, got, scale, accumulate=accumulate)
                n += 1
                assert torch.equal(k, p), (wire, a.dtype, accumulate)
    x = torch.from_numpy(_half_boundaries()).cuda()
    q, scale = ops.quantize_stage(x, impl="cuda")
    assert torch.equal(q, ref.quantize_stage(x, scale))
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(stages.dequantize_wire(q, scale, dt),
                           ref.dequantize_stage(q, scale, dt))
    torch.cuda.synchronize()
    assert stages.fused_combine.launches == before + n


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 1), (3, 3), (1, 3), (0, 3)])
@pytest.mark.parametrize("m", [1, 17, 1031, (1 << 20) + 3])
def test_fused_combine_on_misaligned_views_on_card(m, offsets):
    """Ring chunks are views at any offset into a flat buffer: acc and got
    at element offsets that misalign the 16-byte vectors, together and
    against each other, bitwise against the plain version, in place too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    oa, og = offsets
    rng = np.random.default_rng(m)
    acc0 = torch.from_numpy(rng.standard_normal(m + 3).astype(np.float32))
    got32 = torch.from_numpy(rng.standard_normal(m + 3).astype(np.float32))
    q, q_scale = ops.quantize_stage(got32, impl="ref")
    wires = {"fp32": (got32, None), "bf16": (got32.to(torch.bfloat16), None),
             "int8": (q, q_scale)}
    before = stages.fused_combine.launches
    n = 0
    for wire, (got0, scale) in wires.items():
        got = got0.cuda()[og:og + m]
        scale = None if scale is None else scale.cuda()
        for a0 in (acc0.cuda(), acc0.cuda().to(torch.bfloat16)):
            a = a0[oa:oa + m]
            for accumulate in (True, False):
                k = stages.fused_combine(a, got, scale,
                                         accumulate=accumulate)
                p = ref.combine_stage(a, got, scale, accumulate=accumulate)
                assert torch.equal(k, p), (wire, a.dtype, accumulate)
            inplace = a0.clone()[oa:oa + m]
            stages.fused_combine(inplace, got, scale, out=inplace)
            assert torch.equal(inplace, ref.combine_stage(a, got, scale))
            n += 3
    torch.cuda.synchronize()
    assert stages.fused_combine.launches == before + n
