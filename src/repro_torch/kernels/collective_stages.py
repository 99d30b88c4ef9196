"""Collective-stage kernel wrappers — the port of
``repro/kernels/collective_stages.py``.

Four hand-written CUDA kernels, each beside its plain version in
:mod:`repro_torch.kernels.ref`:

* :func:`fused_combine` (``csrc/collective_stages.cu``) — the Level-B
  reduce-scatter combine ``acc + dequant(got)`` in one pass, or the
  allgather install ``dequant(got)`` with ``accumulate=False``;
* :func:`quantize_wire` — symmetric int8 quantisation against a scale
  held on the device;
* :func:`dequantize_wire` — ``q × scale`` cast to fp32 or bf16;
* :func:`gs_stencil` (``csrc/gs_stencil.cu``) — the Gauss–Seidel block
  stage: interior update, L1 residual and the four outgoing boundary
  edges in one pass.

For tensors on the CPU each wrapper runs the plain version; a CUDA tensor
goes to the kernel, on the current stream, or the wrapper raises —
nothing falls back.  Each wrapper's ``.launches`` counts its kernel's
launches (plain-version calls count nothing).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from . import build, ref

_count_lock = threading.Lock()

# dtype codes of the C interface of csrc/collective_stages.cu
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ACC_DTYPES = (torch.float32, torch.bfloat16)


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _check_1d(name: str, what: str, t: torch.Tensor, device,
              dtypes, numel: Optional[int] = None) -> None:
    if t.device != device:
        raise ValueError(f"{name}: {what} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {what} dtype {t.dtype} is not one of "
                        f"{[str(d) for d in dtypes]}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: {what} has {t.numel()} elements, "
                         f"expected {numel}")


def _check_scale(name: str, scale, device) -> None:
    """The kernels read the scale through a pointer: a one-element fp32
    tensor on the operands' device."""
    if not isinstance(scale, torch.Tensor):
        raise TypeError(f"{name}: scale must be a tensor on {device}, got "
                        f"{type(scale).__name__}")
    _check_1d(name, "scale", scale, device, (torch.float32,), numel=1)


def _check_combine_args(acc, got, scale, out) -> None:
    name = "fused_combine"
    if acc.shape != got.shape:
        raise ValueError(f"{name}: acc/got shape mismatch: "
                         f"{tuple(acc.shape)} vs {tuple(got.shape)}")
    _check_1d(name, "acc", acc, acc.device, _ACC_DTYPES)
    _check_1d(name, "got", got, acc.device, tuple(_CODES))
    if out is not None:
        _check_1d(name, "out", out, acc.device, (acc.dtype,),
                  numel=acc.numel())


def fused_combine(acc: torch.Tensor, got: torch.Tensor, scale=None, *,
                  accumulate: bool = True,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc + dequant(got)`` in one pass over the elements.

    ``got`` may arrive in a narrower wire dtype (bf16, int8); it is cast
    to ``acc.dtype`` (fp32 or bf16) — via ``× scale`` when a scale is
    given, a 0-d fp32 tensor on the device — inside the kernel, so no
    widened copy of the wire payload is written.  ``accumulate=False``
    skips the add and never reads ``acc`` (the allgather-leg install).
    The result has ``acc``'s shape and dtype; it is written into ``out``
    when given, which may be ``acc`` itself.
    """
    if not acc.is_cuda:
        return ref.combine_stage(acc, got, scale, accumulate=accumulate,
                                 out=out)
    _check_combine_args(acc, got, scale, out)
    if scale is not None:
        _check_scale("fused_combine", scale, acc.device)
    if out is None:
        out = torch.empty_like(acc)
    if acc.numel() == 0:
        return out
    lib = build.load("collective_stages")
    err = lib.fused_combine(
        acc.data_ptr(), got.data_ptr(),
        None if scale is None else scale.data_ptr(), out.data_ptr(),
        acc.numel(), _CODES[acc.dtype], _CODES[got.dtype], int(accumulate),
        torch.cuda.current_stream(acc.device).cuda_stream)
    build.check(err, "fused_combine")
    _count(fused_combine)
    return out


def quantize_wire(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantisation against ``scale`` in one pass:
    ``round(x / scale)`` (a true division, rounding half to even), clipped
    to ±127.  ``scale`` is the caller's ``max|x| / 127``, a 0-d fp32
    tensor on the device."""
    if not x.is_cuda:
        return ref.quantize_stage(x, scale)
    _check_1d("quantize_wire", "x", x, x.device, _ACC_DTYPES)
    _check_scale("quantize_wire", scale, x.device)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return q
    lib = build.load("collective_stages")
    err = lib.quantize_wire(x.data_ptr(), scale.data_ptr(), q.data_ptr(),
                            x.numel(), _CODES[x.dtype],
                            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "quantize_wire")
    _count(quantize_wire)
    return q


def dequantize_wire(q: torch.Tensor, scale,
                    dtype: torch.dtype = torch.float32, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q × scale`` cast to ``dtype`` (fp32 or bf16) in one pass: the
    chunks that travelled the allgather leg in int8.  The result is
    written into ``out`` when given."""
    if not q.is_cuda:
        return ref.dequantize_stage(q, scale, dtype, out=out)
    _check_1d("dequantize_wire", "q", q, q.device, (torch.int8,))
    if dtype not in _ACC_DTYPES:
        raise TypeError(f"dequantize_wire: output dtype {dtype} is not "
                        f"float32 or bfloat16")
    _check_scale("dequantize_wire", scale, q.device)
    if out is None:
        out = torch.empty(q.shape, dtype=dtype, device=q.device)
    else:
        _check_1d("dequantize_wire", "out", out, q.device, (dtype,),
                  numel=q.numel())
    if q.numel() == 0:
        return out
    lib = build.load("collective_stages")
    err = lib.dequantize_wire(q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                              q.numel(), _CODES[dtype],
                              torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "dequantize_wire")
    _count(dequantize_wire)
    return out


fused_combine.launches = 0
quantize_wire.launches = 0
dequantize_wire.launches = 0


# gs_stencil's routes, by code of the C interface of csrc/gs_stencil.cu,
# and its launch geometry (kRows, kWarps there): a thread owns GS_VEC[dt]
# adjacent columns ("vec") or one ("scalar") of a strip of GS_ROWS rows; a
# CTA stacks GS_WARPS data warps (and one warp that sums them).
GS_ROUTES = ("scalar", "vec")
_GS_ROUTE_CODES = {name: code for code, name in enumerate(GS_ROUTES)}
GS_VEC = {torch.float32: 4, torch.bfloat16: 8}      # 16 bytes
GS_ROWS, GS_WARPS = 4, 8
_gs_lock = threading.Lock()
_gs_partials: Dict[Tuple[int, int, int, int], int] = {}  # (H, W, dt, route)
_gs_slots: Dict[Tuple[int, int], int] = {}          # (device, stream)
_gs_words_used: Dict[int, int] = {}                 # device -> words
_gs_scratch: Dict[Tuple[int, int, int], Tuple[int, int]] = {}


def _check_cuda_args(block: torch.Tensor, halos) -> None:
    if block.dim() != 2 or block.numel() == 0:
        raise ValueError(f"gs_stencil: block must be a non-empty 2-D "
                         f"tensor, got shape {tuple(block.shape)}")
    H, W = block.shape
    if block.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gs_stencil: block dtype {block.dtype} is not "
                        f"float32 or bfloat16")
    if not block.is_contiguous():
        raise ValueError("gs_stencil: block must be contiguous")
    for name, h, n in zip(("top", "left", "bottom", "right"), halos,
                          (W, H, W, H)):
        if h.device != block.device:
            raise ValueError(f"gs_stencil: {name} halo on {h.device}, "
                             f"block on {block.device}")
        if h.dim() != 1 or h.shape[0] != n:
            raise ValueError(f"gs_stencil: {name} halo must have shape "
                             f"({n},), got {tuple(h.shape)}")
        if not h.is_contiguous():
            raise ValueError(f"gs_stencil: {name} halo must be contiguous")


def route(block: torch.Tensor) -> str:
    """The route of ``csrc/gs_stencil.cu`` that ``gs_stencil(block, ...)``
    takes on the card, from dtype, shape and alignment alone:

    * ``"vec"`` — W a multiple of the dtype's 16-byte width (4 fp32, 8
      bf16 columns) and the block at a 16-byte aligned address: 16-byte
      loads and stores of the block;
    * ``"scalar"`` — everything else (ragged W, views at unaligned
      offsets): the same kernel, one column a thread.

    The halos are read with scalar loads on both routes, and the outputs
    are allocated by the wrapper, so neither enters the choice."""
    vec = GS_VEC.get(block.dtype, 0)
    if vec and block.shape[-1] % vec == 0 and block.data_ptr() % 16 == 0:
        return "vec"
    return "scalar"


def _gs_plan(H: int, W: int, dt: torch.dtype, which: str) -> int:
    """The number of partial words a call needs, one a CTA (from the C
    interface, once per shape)."""
    key = (H, W, _CODES[dt], _GS_ROUTE_CODES[which])
    n = _gs_partials.get(key)
    if n is None:
        n = build.load("gs_stencil").gs_stencil_num_partials(*key)
        _gs_partials[key] = n
    return n


def _gs_scratch_for(device: int, stream: int, n: int) -> Tuple[int, int]:
    """The ticket slot of launches on ``stream`` and the offset of their
    ``n`` partial words in the kernel's pool, handed out once under a lock
    (the header of ``csrc/gs_stencil.cu`` says why one per stream: calls on
    different streams may run at once)."""
    key = (device, stream, n)
    got = _gs_scratch.get(key)
    if got is not None:
        return got
    with _gs_lock:
        got = _gs_scratch.get(key)
        if got is None:
            lib = build.load("gs_stencil")
            slot = _gs_slots.setdefault(key[:2], len(_gs_slots))
            offset = _gs_words_used.get(device, 0)
            if (slot >= lib.gs_stencil_num_slots()
                    or offset + n > lib.gs_stencil_pool_words()):
                raise RuntimeError(
                    f"gs_stencil: out of ticket slots or partial words "
                    f"({len(_gs_slots)} streams, {offset + n} words)")
            _gs_words_used[device] = offset + n
            got = _gs_scratch[key] = (slot, offset)
    return got


def gs_stencil(block: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
               bottom: torch.Tensor, right: torch.Tensor):
    """Fused Gauss–Seidel block stage.

    One pass over the (H, W) block producing the 4-point average update,
    the block's fp32 L1 residual ``sum|new - old|`` (a 0-d fp32 tensor on
    the block's device) and the four NEW boundary edges packed for the
    next halo exchange.  Returns ``(new_block, residual, (top, bottom,
    left, right))`` with edges of length W, W, H, H — note the argument
    order (top, left, bottom, right) differs from the edge order.  The
    halos are rounded to the block's dtype (float32 or bfloat16) first.
    On a CUDA device: one launch on the current stream, on the route
    :func:`route` names; the edges are contiguous views of one buffer.
    """
    if not block.is_cuda:
        return ref.gs_stencil(block, top, left, bottom, right)
    dt = block.dtype
    halos = [h if h.dtype == dt else h.to(dt)
             for h in (top, left, bottom, right)]
    _check_cuda_args(block, halos)
    H, W = block.shape
    which = route(block)
    n = _gs_plan(H, W, dt, which)
    # the current stream's handle (what torch.cuda.current_stream(device)
    # .cuda_stream gives, without making a Stream object)
    device = block.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    slot, offset = _gs_scratch_for(device, stream, n)
    new = torch.empty_like(block)
    edges = torch.empty(2 * (W + H), dtype=dt, device=block.device)
    res = torch.empty((), dtype=torch.float32, device=block.device)
    err = build.load("gs_stencil").gs_stencil_fwd(
        block.data_ptr(), halos[0].data_ptr(), halos[1].data_ptr(),
        halos[2].data_ptr(), halos[3].data_ptr(), new.data_ptr(),
        edges.data_ptr(), res.data_ptr(), H, W, _CODES[dt],
        _GS_ROUTE_CODES[which], slot, offset, stream)
    build.check(err, "gs_stencil")
    with _count_lock:
        gs_stencil.launches += 1
        gs_stencil.route_launches[which] += 1
    return new, res, edges.split_with_sizes((W, W, H, H))


gs_stencil.launches = 0
gs_stencil.route_launches = {name: 0 for name in GS_ROUTES}


def _shuffle_tree(a: torch.Tensor) -> torch.Tensor:
    """Lane 0 of a warp's shuffle-down tree (offsets 16, 8, 4, 2, 1) over
    the last axis of ``a`` (32 lanes, fp32)."""
    for off in (16, 8, 4, 2, 1):
        a = a[..., :off] + a[..., off:2 * off]
    return a[..., 0]


def residual_in_kernel_order(block: torch.Tensor, top: torch.Tensor,
                             left: torch.Tensor, bottom: torch.Tensor,
                             right: torch.Tensor,
                             which: Optional[str] = None) -> torch.Tensor:
    """The fp32 residual ``sum|new - old|`` of :func:`gs_stencil`, summed
    in exactly the order of ``csrc/gs_stencil.cu`` on route ``which``
    (default :func:`route`), with tensor operations on the block's device:
    each thread's rows, then its columns, in order; the warp's shuffle
    tree; the same tree over the CTA's warp sums (lanes beyond GS_WARPS at
    0) into one partial per CTA; in the elected CTA, lane l summing
    partials l, l + 32, ... in order, then the tree.  fp32 adds round the
    same on any device, so on the card the kernel's residual equals this
    bitwise.  Tests and ``chip_smoke.py`` use it; the main path does
    not."""
    which = route(block) if which is None else which
    vec = GS_VEC[block.dtype] if which == "vec" else 1
    new, old = ref.gs_update(block, top, left, bottom, right)
    H, W = old.shape
    gx, gy = -(-W // (32 * vec)), -(-H // (GS_WARPS * GS_ROWS))
    terms = torch.nn.functional.pad(
        (new - old).abs(), (0, gx * 32 * vec - W, 0, gy * GS_WARPS * GS_ROWS
                            - H))
    # (by, warp, row, bx, lane, column) -> (by, bx, warp, lane, row·column)
    terms = terms.reshape(gy, GS_WARPS, GS_ROWS, gx, 32, vec).permute(
        0, 3, 1, 4, 2, 5).reshape(gy, gx, GS_WARPS, 32, GS_ROWS * vec)
    acc = torch.zeros(terms.shape[:-1], dtype=torch.float32,
                      device=terms.device)
    for k in range(GS_ROWS * vec):
        acc = acc + terms[..., k]
    warps = torch.nn.functional.pad(_shuffle_tree(acc), (0, 32 - GS_WARPS))
    partials = _shuffle_tree(warps).reshape(-1)     # index by * gx + bx
    partials = torch.nn.functional.pad(
        partials, (0, -partials.numel() % 32)).reshape(-1, 32)
    acc = torch.zeros(32, dtype=torch.float32, device=terms.device)
    for row in partials:
        acc = acc + row
    return _shuffle_tree(acc)
