"""mLSTM chunkwise kernel wrapper — the port of
``repro/kernels/mlstm_chunk.py``.

:func:`mlstm_chunk` launches the hand-written Hopper kernel of
``csrc/mlstm_chunk.cu`` for CUDA tensors, on the current stream, and runs
its plain version (:func:`repro_torch.kernels.ref.mlstm_chunked`) for CPU
tensors; nothing falls back.  ``mlstm_chunk.launches`` counts the
kernel's launches (plain-version calls count nothing).
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

from . import build, ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
DIMS = tuple(range(16, 513, 16))    # head dims d the kernel takes
MAX_CHUNK = 256
_count_lock = threading.Lock()


def _check_args(q, k, v, i_gate, f_gate) -> None:
    if q.dim() != 4 or i_gate.dim() != 3 or f_gate.dim() != 3:
        raise ValueError(f"mlstm_chunk: q/k/v (b,s,h,d) and i_gate/f_gate "
                         f"(b,s,h) expected, got q {tuple(q.shape)}, i_gate "
                         f"{tuple(i_gate.shape)}, f_gate "
                         f"{tuple(f_gate.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"mlstm_chunk: {name} {tuple(t.shape)} is not "
                             f"q's {tuple(q.shape)}")
    for name, t in (("i_gate", i_gate), ("f_gate", f_gate)):
        if tuple(t.shape) != tuple(q.shape[:3]):
            raise ValueError(f"mlstm_chunk: {name} {tuple(t.shape)} is not "
                             f"(b, s, h) = {tuple(q.shape[:3])}")
    named = (("k", k), ("v", v), ("i_gate", i_gate), ("f_gate", f_gate))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"mlstm_chunk: {name} on {t.device}, q on "
                             f"{q.device}")
    if not q.is_cuda:
        return
    if q.dtype not in _CODES:
        raise TypeError(f"mlstm_chunk: q dtype {q.dtype} is not float32 or "
                        f"bfloat16")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"mlstm_chunk: {name} dtype {t.dtype}, q dtype "
                            f"{q.dtype}")
    for name, t in (("i_gate", i_gate), ("f_gate", f_gate)):
        if t.dtype != torch.float32:
            raise TypeError(f"mlstm_chunk: {name} must be float32, got "
                            f"{t.dtype}")
    if q.shape[-1] not in DIMS:
        raise ValueError(f"mlstm_chunk: head dim d={q.shape[-1]} must be a "
                         f"multiple of 16 from 16 to 512")
    for name, t in (("q", q),) + named:
        if not t.is_contiguous():
            raise ValueError(f"mlstm_chunk: {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"mlstm_chunk: {name} must be 16-byte aligned "
                             f"(the kernel reads it in 16-byte vectors)")


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                chunk: int = 128
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]]:
    """Chunkwise stabilised mLSTM from the zero state.

    q, k, v: (b, s, h, d); i_gate, f_gate: (b, s, h) pre-activation
    logits.  As the Pallas wrapper: ``chunk = min(chunk, s)`` must divide
    s.  On the card q, k and v share one dtype (float32 or bfloat16), the
    gates are float32, d is in :data:`DIMS` and the chunk is at most
    :data:`MAX_CHUNK`.  Returns (y (b, s, h, d) in q's dtype, (C (b, h, d,
    d), n (b, h, d), m (b, h)) fp32).
    """
    _check_args(q, k, v, i_gate, f_gate)
    b, s, h, d = q.shape
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"mlstm_chunk: s={s} is not a multiple of "
                         f"chunk={chunk}")
    if not q.is_cuda:
        return ref.mlstm_chunked(q, k, v, i_gate, f_gate, chunk=chunk)
    if chunk > MAX_CHUNK:
        raise ValueError(f"mlstm_chunk: chunk {chunk} is above "
                         f"{MAX_CHUNK}")
    y = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    C = torch.empty((b, h, d, d), **f32)
    n = torch.empty((b, h, d), **f32)
    m = torch.empty((b, h), **f32)
    lib = build.load("mlstm_chunk")
    err = lib.mlstm_chunk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_gate.data_ptr(),
        f_gate.data_ptr(), y.data_ptr(), C.data_ptr(), n.data_ptr(),
        m.data_ptr(), b, s, h, d, chunk, _CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "mlstm_chunk")
    with _count_lock:
        mlstm_chunk.launches += 1
    return y, (C, n, m)


mlstm_chunk.launches = 0
