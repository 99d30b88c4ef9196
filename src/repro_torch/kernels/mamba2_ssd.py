"""Mamba2 SSD kernel wrapper — the port of ``repro/kernels/mamba2_ssd.py``.

:func:`mamba2_ssd` launches the hand-written Hopper kernel of
``csrc/mamba2_ssd.cu`` for CUDA tensors, on the current stream, and runs
its plain version (:func:`repro_torch.kernels.ref.ssd_chunked`) for CPU
tensors; nothing falls back.  ``mamba2_ssd.launches`` counts the kernel's
launches (plain-version calls count nothing).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from . import build, ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
DIMS = (8, 16, 32, 64, 128)     # head dims p and state widths n built
MAX_CHUNK = 256
_count_lock = threading.Lock()


def _check_args(x, dt, A, B, C, init_state) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 \
            or C.dim() != 3:
        raise ValueError(f"mamba2_ssd: x (b,s,h,p), dt (b,s,h), A (h,) and "
                         f"B/C (b,s,n) expected, got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,):
        raise ValueError(f"mamba2_ssd: dt {tuple(dt.shape)} / A "
                         f"{tuple(A.shape)} do not match x {tuple(x.shape)}")
    if tuple(B.shape) != (b, s, n) or tuple(C.shape) != (b, s, n):
        raise ValueError(f"mamba2_ssd: B {tuple(B.shape)} and C "
                         f"{tuple(C.shape)} must both be (b, s, n) with x's "
                         f"b and s")
    if init_state is not None and tuple(init_state.shape) != (b, h, p, n):
        raise ValueError(f"mamba2_ssd: init_state {tuple(init_state.shape)} "
                         f"is not {(b, h, p, n)}")
    named = (("dt", dt), ("A", A), ("B", B), ("C", C),
             ("init_state", init_state))
    for name, t in named:
        if t is not None and t.device != x.device:
            raise ValueError(f"mamba2_ssd: {name} on {t.device}, x on "
                             f"{x.device}")
    if not x.is_cuda:
        return
    if x.dtype not in _CODES:
        raise TypeError(f"mamba2_ssd: dtype {x.dtype} is not float32 or "
                        f"bfloat16")
    for name, t in (("dt", dt), ("B", B), ("C", C)):
        if t.dtype != x.dtype:
            raise TypeError(f"mamba2_ssd: {name} dtype {t.dtype}, x dtype "
                            f"{x.dtype}")
    for name, t in (("A", A), ("init_state", init_state)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"mamba2_ssd: {name} must be float32, got "
                            f"{t.dtype}")
    if p not in DIMS or n not in DIMS:
        raise ValueError(f"mamba2_ssd: head dim p={p} and state n={n} must "
                         f"each be one of {DIMS}")
    for name, t in (("x", x),) + named:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"mamba2_ssd: {name} must be contiguous")


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
               init_state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (b, s, h, p); dt: (b, s, h); A: (h,) fp32; B, C: (b, s, n);
    ``init_state`` (b, h, p, n) fp32 or None (zeros).  As the Pallas
    wrapper: ``chunk = min(chunk, s)`` must divide s.  On the card x, dt,
    B and C share one dtype (float32 or bfloat16), p and n are in
    :data:`DIMS` and the chunk is at most :data:`MAX_CHUNK`.  Returns
    (y (b, s, h, p) in x's dtype, final state (b, h, p, n) fp32).
    """
    _check_args(x, dt, A, B, C, init_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"mamba2_ssd: s={s} is not a multiple of "
                         f"chunk={chunk}")
    if not x.is_cuda:
        return ref.ssd_chunked(x, dt, A, B, C, chunk=chunk,
                               init_state=init_state)
    if chunk > MAX_CHUNK:
        raise ValueError(f"mamba2_ssd: chunk {chunk} is above "
                         f"{MAX_CHUNK}")
    y = torch.empty_like(x)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = build.load("mamba2_ssd")
    err = lib.mamba2_ssd_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), fin.data_ptr(), b, s, h, p, n, chunk, _CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "mamba2_ssd")
    with _count_lock:
        mamba2_ssd.launches += 1
    return y, fin


mamba2_ssd.launches = 0
