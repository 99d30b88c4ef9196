"""Expert grouped-matmul kernel wrapper — the port of
``repro/kernels/moe_gmm.py``.

:func:`moe_gmm` launches the hand-written Hopper kernel of
``csrc/moe_gmm.cu`` for CUDA tensors, on the current stream, and runs its
plain version (:func:`repro_torch.kernels.ref.moe_gmm`) for CPU tensors;
nothing falls back.  :func:`route` names which of the kernel's routes a
call takes.  ``moe_gmm.launches`` counts the kernel's launches (one a
call, whatever the route; plain-version calls count nothing).
"""

from __future__ import annotations

import threading

import torch

from . import build, ref

# The routes of csrc/moe_gmm.cu's C interface, by code.
ROUTES = ("fma", "mma_sync", "wgmma", "wgmma_decode")
_CODES = {name: code for code, name in enumerate(ROUTES)}
DTYPES = (torch.float32, torch.bfloat16)
DECODE_ROWS = 8         # C <= 8 takes the decode tile of the wgmma route
                        # (tma::kDecodeRows of csrc/moe_gmm.cu)
MAX_EXPERTS = 65535     # the grid's z extent of the mma_sync and fma routes
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
    if x.dtype not in DTYPES:
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


def route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The route of ``csrc/moe_gmm.cu`` that ``moe_gmm(x, w)`` takes on the
    card, from dtype, shape and alignment alone:

    * ``"fma"`` — float32, on the FMA pipes (no TF32);
    * ``"wgmma"`` — bfloat16 with K > 0 and K, N multiples of 8 and x, w
      at 16-byte aligned addresses (what TMA needs of base pointers and
      strides), C > 8: the swapped product outᵀ = wᵀ·xᵀ on ``wgmma``
      m64n160k16 fed by TMA, tiles of 128 columns of w by 160 rows of x;
    * ``"wgmma_decode"`` — the same with C <= 8: ``wgmma`` m64n8k16 on
      tiles of 256 columns of w by the 8 rows of x, a weight stream;
    * ``"mma_sync"`` — every other bfloat16 call (ragged K or N, views at
      unaligned offsets, K = 0): ``mma.sync``, its tiles staged element
      by element.
    """
    if x.dtype == torch.float32:
        return "fma"
    K, N = x.shape[2], w.shape[2]
    if (K > 0 and K % 8 == 0 and N % 8 == 0 and x.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0):
        return "wgmma_decode" if x.shape[1] <= DECODE_ROWS else "wgmma"
    return "mma_sync"


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched expert matmul: x (E, C, K) × w (E, K, N) -> (E, C, N) in
    x's dtype, accumulated in fp32 and cast once.  Any C, K and N (the
    Pallas wrapper asserts they divide its blocks; the kernel masks the
    ragged edges).  On the card x and w share one dtype, float32 (FMA
    pipes, no TF32) or bfloat16 (tensor cores), and are contiguous; the
    kernel's route follows from dtype, shape and alignment alone
    (:func:`route`).  A route that cannot run its operands raises (a
    tensor map the driver refuses, say): no call is retried on another."""
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
                          K, N, _CODES[route(x, w)],
                          torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "moe_gmm")
    with _count_lock:
        moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
