"""Mamba2 SSD kernel wrapper — the port of ``repro/kernels/mamba2_ssd.py``.

:func:`mamba2_ssd` launches the hand-written Hopper kernel of
``csrc/mamba2_ssd.cu`` for CUDA tensors, on the current stream, and runs
its plain version (:func:`repro_torch.kernels.ref.ssd_chunked`) for CPU
tensors; nothing falls back.  :func:`route` names which of the kernel's
routes a call takes.  ``mamba2_ssd.launches`` counts the kernel's launches
(one a call, whatever the route; plain-version calls count nothing) and
``mamba2_ssd.route_launches`` the same by route.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from . import build, ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The routes of csrc/mamba2_ssd.cu's C interface, by code.
ROUTES = ("fma", "wgmma")
_ROUTE_CODES = {name: code for code, name in enumerate(ROUTES)}
DIMS = (8, 16, 32, 64, 128)     # head dims p and state widths n built
MAX_CHUNK = 256
WGMMA_P = (64, 128)             # head dims of the wgmma route
WGMMA_SLAB = 64                 # its chunks are multiples of this (tc::kSlab)
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
    for name, t in (("x", x),) + named:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"mamba2_ssd: {name} must be contiguous")


def route(x: torch.Tensor, B: torch.Tensor, chunk: int,
          C: torch.Tensor) -> str:
    """The route of ``csrc/mamba2_ssd.cu`` that ``mamba2_ssd(x, dt, A, B,
    C, chunk=chunk)`` takes on the card, from dtype, shape and alignment
    alone (the chunk as the wrapper takes it, ``min(chunk, s)``):

    * ``"wgmma"`` — bfloat16 with p in :data:`WGMMA_P`, n a multiple of 16
      up to 128, a chunk that is a multiple of 64 up to :data:`MAX_CHUNK`,
      and x, B and C at 16-byte aligned addresses (what TMA needs): the
      chunk-parallel SSD on ``wgmma`` fed by TMA, in three
      launches (chunk states, state passing, outputs);
    * ``"fma"`` — everything else (float32, other bfloat16 shapes, views
      at unaligned offsets): one block per (batch, head, p-tile) walking
      the chunks in order on the FMA pipes.

    y is allocated by the wrapper, so it is always aligned."""
    s, p = x.shape[1], x.shape[-1]
    n = B.shape[-1]
    chunk = min(chunk, s)
    if (x.dtype == torch.bfloat16 and p in WGMMA_P and n % 16 == 0
            and 0 < n <= 128 and chunk > 0 and chunk % WGMMA_SLAB == 0
            and chunk <= MAX_CHUNK
            and all(t.data_ptr() % 16 == 0 for t in (x, B, C))):
        return "wgmma"
    return "fma"


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
               init_state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (b, s, h, p); dt: (b, s, h); A: (h,) fp32; B, C: (b, s, n);
    ``init_state`` (b, h, p, n) fp32 or None (zeros).  As the Pallas
    wrapper: ``chunk = min(chunk, s)`` must divide s.  On the card x, dt,
    B and C share one dtype (float32 or bfloat16), p and n are in
    :data:`DIMS` (the wgmma route takes any n that is a multiple of 16 up to
    128) and the chunk is at most :data:`MAX_CHUNK`; the kernel's
    route follows from dtype, shape and alignment alone (:func:`route`),
    and a route that cannot run its operands raises (a tensor map the
    driver refuses, say): no call is retried on another.  Returns (y (b,
    s, h, p) in x's dtype, final state (b, h, p, n) fp32).
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
    which = route(x, B, chunk, C)
    if which == "fma" and (p not in DIMS or n not in DIMS):
        raise ValueError(f"mamba2_ssd: head dim p={p} and state n={n} must "
                         f"each be one of {DIMS} (or, bf16, take the wgmma "
                         f"route: p in {WGMMA_P}, n a multiple of 16 up to "
                         f"128)")
    y = torch.empty_like(x)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    scratch = (None, None, None)
    if which == "wgmma":
        # chunk states, cums, and the carried states as bf16 hi and lo
        nc = s // chunk
        sc = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                         device=x.device)
        cums = torch.empty((b, nc, h, chunk), dtype=torch.float32,
                           device=x.device)
        st_in = torch.empty((2, b, nc, h, p, n), dtype=torch.bfloat16,
                            device=x.device)
        scratch = (sc.data_ptr(), cums.data_ptr(), st_in.data_ptr())
    lib = build.load("mamba2_ssd")
    err = lib.mamba2_ssd_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), fin.data_ptr(), b, s, h, p, n, chunk, _CODES[x.dtype],
        _ROUTE_CODES[which], *scratch,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "mamba2_ssd")
    with _count_lock:
        mamba2_ssd.launches += 1
        mamba2_ssd.route_launches[which] += 1
    return y, fin


mamba2_ssd.launches = 0
mamba2_ssd.route_launches = dict.fromkeys(ROUTES, 0)
