"""Port parity: the ``gs_stencil`` kernel module of ``repro_torch`` against
the JAX package's Pallas kernel (interpret mode) and its jnp oracle.

The same inputs, drawn with numpy from a seed, go through both packages.
Block and edges must match bitwise (the update is elementwise fp32 in one
order on both sides); the residual within rtol 1e-6, because jnp and torch
sum the |new - old| terms in different orders.  On the CPU the kernel
wrapper takes the plain version; the kernel itself is checked on the card
(``-m cuda``, and ``chip_smoke.py``).
"""

import sys
from pathlib import Path

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


# ---------------------------------------------------------------------------
# gs_stencil's routes and the order of its residual
# ---------------------------------------------------------------------------
ORDER_SHAPES = [(1024, 1024), (1000, 1023), (17, 5), (1, 8), (8, 1)]


def _gs_view(arr, dtype, offset, device="cpu"):
    """``arr`` as a contiguous ``dtype`` view ``offset`` elements into a
    flat buffer (the allocator aligns the buffer)."""
    t = torch.from_numpy(arr).to(device, dtype)
    buf = torch.zeros(t.numel() + offset, dtype=dtype, device=device)
    return buf[offset:].view(t.shape).copy_(t)


def _routes(block):
    """Both routes where the block meets the vec route, else scalar."""
    return ("vec", "scalar") if stages.route(block) == "vec" else ("scalar",)


@pytest.mark.parametrize("dtype,W,offset,want", [
    ("float32", 1024, 0, "vec"), ("float32", 1020, 0, "vec"),
    ("float32", 1023, 0, "scalar"), ("float32", 1022, 0, "scalar"),
    ("float32", 1024, 4, "vec"), ("float32", 1024, 1, "scalar"),
    ("float32", 1024, 2, "scalar"), ("bfloat16", 1024, 0, "vec"),
    ("bfloat16", 1020, 0, "scalar"), ("bfloat16", 1016, 0, "vec"),
    ("bfloat16", 1024, 8, "vec"), ("bfloat16", 1024, 4, "scalar"),
    ("bfloat16", 1024, 1, "scalar"), ("float32", 5, 0, "scalar"),
    ("float32", 1, 0, "scalar"), ("bfloat16", 8, 0, "vec")])
def test_gs_route(dtype, W, offset, want):
    """``route`` reads dtype, W and the block's alignment only: 16-byte
    vectors where W is a multiple of the dtype's 16-byte width and the
    block starts on a 16-byte boundary."""
    block = _gs_view(np.ones((3, W), np.float32), getattr(torch, dtype),
                     offset)
    assert block.is_contiguous()
    assert stages.route(block) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W", ORDER_SHAPES)
def test_residual_in_kernel_order_matches_plain_and_jax(H, W, dtype):
    """The kernel-order residual is the same sum as the plain version's
    and the Pallas kernel's, in another order: within RES_RTOL of both,
    on every route the block can take."""
    arrs = _inputs(H, W, H * W + 5)
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    args = [torch.from_numpy(a).to(dt) for a in arrs]
    plain = ref.gs_stencil(*args)[1]
    jres = jax_ops.gs_stencil(*(jnp.asarray(a, jdt) for a in arrs),
                              impl="pallas_interpret")[1]
    for which in _routes(args[0]):
        got = stages.residual_in_kernel_order(*args, which=which)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(plain), rtol=RES_RTOL)
        np.testing.assert_allclose(float(got), float(jres), rtol=RES_RTOL)


def _emulated_residual(args, which):
    """The kernel's residual by walking its CTAs, warps and lanes one by
    one with numpy fp32 scalars, as ``csrc/gs_stencil.cu`` adds: each
    thread's rows then columns, ``__shfl_down_sync`` trees (a lane past
    31 reads its own value), the same tree over the CTA's warp sums, the
    last CTA's 32 lanes summing the partials strided by 32, then the
    tree."""
    f32 = np.float32
    new, old = ref.gs_update(*args)
    terms = (new - old).abs().numpy()
    H, W = terms.shape
    vec = stages.GS_VEC[args[0].dtype] if which == "vec" else 1
    warps, rows = stages.GS_WARPS, stages.GS_ROWS
    gx, gy = -(-W // (32 * vec)), -(-H // (warps * rows))

    def shfl_tree(lanes):
        v = [f32(x) for x in lanes]
        for off in (16, 8, 4, 2, 1):
            v = [f32(v[i] + (v[i + off] if i + off < 32 else v[i]))
                 for i in range(32)]
        return v[0]

    def cta_sum(threads):
        sums = [shfl_tree(threads[32 * w:32 * w + 32]) for w in range(warps)]
        return shfl_tree(sums + [f32(0)] * (32 - warps))

    partials = []
    for by in range(gy):
        for bx in range(gx):
            threads = []
            for w in range(warps):
                for lane in range(32):
                    c0, i0 = (bx * 32 + lane) * vec, (by * warps + w) * rows
                    acc = f32(0)
                    for i in range(i0, min(i0 + rows, H)):
                        for c in range(c0, min(c0 + vec, W)):
                            acc = f32(acc + terms[i, c])
                    threads.append(acc)
            partials.append(cta_sum(threads))
    lanes = []
    for lane in range(32):
        acc = f32(0)
        for k in range(lane, len(partials), 32):
            acc = f32(acc + partials[k])
        lanes.append(acc)
    return shfl_tree(lanes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W", [(70, 264), (130, 40), (3, 17), (1, 8)])
def test_residual_order_is_the_kernels_walk(H, W, dtype):
    """The vectorised kernel-order residual equals, bitwise, a scalar
    walk of the kernel's threads: the reshapes and trees pick the
    kernel's order, on both routes, across several CTAs in each
    direction."""
    args = [torch.from_numpy(a).to(getattr(torch, dtype))
            for a in _inputs(H, W, 3 * H + W)]
    for which in _routes(args[0]):
        got = stages.residual_in_kernel_order(*args, which=which)
        assert np.float32(got.item()) == _emulated_residual(args, which), \
            which


def _card_inputs(H, W, dtype, seed, offset=0):
    arrs = _inputs(H, W, seed)
    return [_gs_view(arrs[0], dtype, offset, "cuda")] + [
        torch.from_numpy(a).to("cuda", dtype) for a in arrs[1:]]


def _assert_card_call(args, got, which):
    """Block and edges bitwise equal to the plain version; the residual
    bitwise equal to the kernel-order function, within 1e-5 of plain."""
    new, res, edges = got
    new_p, res_p, edges_p = ref.gs_stencil(*args)
    assert torch.equal(new, new_p), which
    for e, ep in zip(edges, edges_p):
        assert e.is_contiguous() and torch.equal(e, ep), which
    order = stages.residual_in_kernel_order(*args, which=which)
    assert torch.equal(res, order), (which, res.item(), order.item())
    np.testing.assert_allclose(res.item(), res_p.item(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W,offset", [
    (1024, 1024, 0), (17, 5, 0), (1000, 1023, 0), (1, 8, 0), (8, 1, 0),
    (1, 1, 0), (70, 264, 0), (64, 1020, 0), (1024, 1024, 1)])
def test_kernel_matches_plain_on_card(H, W, offset, dtype):
    """Each call is one launch on the route ``route`` names; block and
    edges bitwise, the residual in the kernel's order and repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _card_inputs(H, W, getattr(torch, dtype), H + W, offset)
    which = stages.route(args[0])
    assert which == ("scalar" if offset or W % stages.GS_VEC[args[0].dtype]
                     else "vec")
    before = dict(stages.gs_stencil.route_launches)
    got = stages.gs_stencil(*args)
    _, res2, _ = stages.gs_stencil(*args)
    torch.cuda.synchronize()
    assert stages.gs_stencil.route_launches[which] == before[which] + 2
    _assert_card_call(args, got, which)
    assert torch.equal(got[1], res2)         # no atomics: reproducible


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.cuda
def test_four_streams_at_once_on_card():
    """Four streams, each held back by a sleep and then launching 50 calls
    (main-path blocks and ragged ones) from threads of their own, run at
    once: every result bitwise equal to the same call made alone
    (``chip_smoke.check_gs_streams``, phase 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _chip_smoke().check_gs_streams(stages, torch.device("cuda"))


@pytest.mark.cuda
def test_graph_replay_on_card():
    """A captured call replays as it ran: every launch leaves its ticket
    at 0, so two replays give the eager result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = _card_inputs(1024, 1024, torch.float32, 9)
    want = stages.gs_stencil(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        stages.gs_stencil(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = stages.gs_stencil(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
        for e, ew in zip(got[2], want[2]):
            assert torch.equal(e, ew)


@pytest.mark.cuda
def test_one_kernel_a_call_on_card():
    """torch.profiler over 10 calls sees 10 gs_stencil kernels and no
    other device activity: no second pass, no memset, no halo cast
    (``chip_smoke.check_gs_one_launch``, phase 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _chip_smoke().check_gs_one_launch(stages, torch.device("cuda"))


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
