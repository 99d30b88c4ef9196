"""Collective-stage kernel wrappers — the port of
``repro/kernels/collective_stages.py``.

:func:`gs_stencil` wraps the hand-written CUDA kernel
``csrc/gs_stencil.cu`` (the Gauss–Seidel block stage: interior update, L1
residual and the four outgoing boundary edges in one pass).  For tensors
on the CPU it runs the plain version (:func:`repro_torch.kernels.ref.
gs_stencil`); a CUDA tensor goes to the kernel, or the wrapper raises —
nothing falls back.  ``gs_stencil.launches`` counts the kernel's launches.

The Level-B stage kernels of the reference (``fused_combine``,
``quantize_wire``, ``dequantize_wire``) are not ported yet.
"""

from __future__ import annotations

import threading

import torch

from . import build, ref

_count_lock = threading.Lock()


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
    with _count_lock:
        gs_stencil.launches += 1
    return new, res, tuple(edges)


gs_stencil.launches = 0
