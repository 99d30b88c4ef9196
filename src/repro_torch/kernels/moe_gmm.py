"""Expert grouped-matmul kernel wrapper — the port of
``repro/kernels/moe_gmm.py``.

:func:`moe_gmm` launches the hand-written Hopper kernel of
``csrc/moe_gmm.cu`` for CUDA tensors, on the current stream, and runs its
plain version (:func:`repro_torch.kernels.ref.moe_gmm`) for CPU tensors;
nothing falls back.  ``moe_gmm.launches`` counts the kernel's launches
(plain-version calls count nothing).
"""

from __future__ import annotations

import threading

import torch

from . import build, ref

_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_EXPERTS = 65535     # the grid's z extent
_count_lock = threading.Lock()


def _check_args(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"moe_gmm: x (E, C, K) and w (E, K, N) expected, "
                         f"got x {tuple(x.shape)}, w {tuple(w.shape)}")
    if w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gmm: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)} (w must be (E, K, N))")
    if w.device != x.device:
        raise ValueError(f"moe_gmm: w on {w.device}, x on {x.device}")
    if not x.is_cuda:
        return
    if x.dtype not in _CODES:
        raise TypeError(f"moe_gmm: x dtype {x.dtype} is not float32 or "
                        f"bfloat16")
    if w.dtype != x.dtype:
        raise TypeError(f"moe_gmm: w dtype {w.dtype}, x dtype {x.dtype}")
    if x.shape[0] > MAX_EXPERTS:
        raise ValueError(f"moe_gmm: {x.shape[0]} experts, at most "
                         f"{MAX_EXPERTS}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"moe_gmm: {name} must be contiguous")


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched expert matmul: x (E, C, K) × w (E, K, N) -> (E, C, N) in
    x's dtype, accumulated in fp32 and cast once.  Any C, K and N (the
    Pallas wrapper asserts they divide its blocks; the kernel masks the
    ragged edges).  On the card x and w share one dtype, float32 (FMA
    pipes, no TF32) or bfloat16 (tensor cores), and are contiguous."""
    _check_args(x, w)
    if not x.is_cuda:
        return ref.moe_gmm(x, w)
    E, C, K = x.shape
    N = w.shape[2]
    out = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out                  # nothing to launch
    lib = build.load("moe_gmm")
    err = lib.moe_gmm_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C,
                          K, N, _CODES[x.dtype],
                          torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "moe_gmm")
    with _count_lock:
        moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
