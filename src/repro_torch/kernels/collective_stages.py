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
from typing import Optional

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
    On a CUDA device the launch goes on the current stream.
    """
    if not block.is_cuda:
        return ref.gs_stencil(block, top, left, bottom, right)
    dt = block.dtype
    halos = [h.to(dt) for h in (top, left, bottom, right)]
    _check_cuda_args(block, halos)
    H, W = block.shape
    lib = build.load("gs_stencil")
    new = torch.empty_like(block)
    edges = [torch.empty(n, dtype=dt, device=block.device)
             for n in (W, W, H, H)]
    partials = torch.empty(lib.gs_stencil_num_partials(H, W),
                           dtype=torch.float32, device=block.device)
    res = torch.empty((), dtype=torch.float32, device=block.device)
    fn = lib.gs_stencil_f32 if dt == torch.float32 else lib.gs_stencil_bf16
    stream = torch.cuda.current_stream(block.device).cuda_stream
    err = fn(block.data_ptr(), *(h.data_ptr() for h in halos),
             new.data_ptr(), *(e.data_ptr() for e in edges),
             partials.data_ptr(), res.data_ptr(), H, W, stream)
    build.check(err, "gs_stencil")
    _count(gs_stencil)
    return new, res, tuple(edges)


gs_stencil.launches = 0
