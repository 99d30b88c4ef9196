"""Flash attention kernel wrapper — the port of
``repro/kernels/flash_attention.py``.

:func:`flash_attention` launches the hand-written Hopper kernel of
``csrc/flash_attention.cu`` for CUDA tensors, on the current stream, and
runs its plain version (:func:`repro_torch.kernels.ref.flash_attention`)
for CPU tensors; nothing falls back.  ``flash_attention.launches`` counts
the kernel's launches (plain-version calls count nothing).

Unlike the Pallas wrapper, any S and T are taken: ``S % block_q == 0`` is
a TPU tiling limit, and the kernel masks its ragged tiles.  bf16 runs on
the tensor cores (``wgmma``, with q, k and v loaded by TMA, so each must
start on a 16-byte boundary); fp32 on the FMA pipes.  Head dim 8, below
``wgmma``'s k-step, takes the FMA instance in both dtypes, q, k and v
zero-padded to 16 columns in shared memory.  With
``return_lse=True`` the kernel also writes each query row's log-sum-exp,
what the attention backward (``ref.attention_bwd``) recomputes the
probabilities from; without it the kernel is given a null pointer and does
the forward's work alone.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple, Union

import torch

from . import build, ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 80, 128)
_count_lock = threading.Lock()


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q (B,S,H,D) and k/v (B,T,Hkv,D) "
                         f"must be 4-D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ in shape")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} in batch or head dim")
    Hkv = k.shape[2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {Hkv} kv heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} dtype {t.dtype}, q "
                            f"dtype {q.dtype}")
    if q.is_cuda:
        if q.dtype not in _CODES:
            raise TypeError(f"flash_attention: dtype {q.dtype} is not "
                            f"float32 or bfloat16")
        if D not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head dim {D} is not one of "
                             f"{HEAD_DIMS}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"flash_attention: {name} must be "
                                 f"contiguous")
            if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
                raise ValueError(f"flash_attention: {name} must start on a "
                                 f"16-byte boundary (TMA loads it)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    return_lse: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Tiled online-softmax attention, forward.

    q: (B, S, H, D); k, v: (B, T, Hkv, D) with H % Hkv == 0, float32 or
    bfloat16.  Query head h attends kv head ``h // (H // Hkv)``; ``causal``
    masks keys after the query's position, ``window`` keys at or before
    ``position - window``.  Scores and accumulation in fp32; the result
    has q's shape and dtype.  ``return_lse``: also each row's
    log-sum-exp ``m + log(l)`` of the scaled scores, fp32 (B, H, S), with
    the reference's convention for a row with no visible key (l = 1, m =
    ``NEG_INF``); returns ``(out, lse)``.
    """
    _check_args(q, k, v)
    if not q.is_cuda:
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=return_lse)
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    lib = build.load("flash_attention")
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, S, T, H, Hkv, D,
        int(causal), -1 if window is None else int(window), _CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    with _count_lock:
        flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
