"""Public kernel entry points with dispatch — the port of
``repro/kernels/ops.py``.

* ``impl="cuda"`` — the hand-written kernel's wrapper: the kernel for CUDA
  tensors, its plain version for CPU tensors;
* ``impl="ref"``  — the plain-PyTorch version (:mod:`.ref`);
* ``impl=None``   — the same as ``"cuda"``: the kernel on the card.

Like the JAX ``ops``, every entry point takes views: a CUDA input that its
kernel wrapper would refuse (a non-contiguous view, or a misaligned one
where the wrapper reads 16-byte vectors) is copied to a fresh contiguous
tensor first (:func:`_as_kernel_input`); every other input reaches the
wrapper as it is, so no call's route changes and nothing falls back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import collective_stages as _stages
from . import flash_attention as _flash
from . import mamba2_ssd as _ssd
from . import mlstm_chunk as _mlstm
from . import moe_gmm as _gmm
from . import ref

IMPLS = (None, "cuda", "ref")


def _check_impl(name: str, impl: Optional[str]) -> None:
    if impl not in IMPLS:
        raise ValueError(f"{name}: impl must be one of {IMPLS}, "
                         f"got {impl!r}")


def _as_kernel_input(t: Optional[torch.Tensor], *,
                     aligned: bool = False) -> Optional[torch.Tensor]:
    """``t`` itself when a kernel wrapper takes it as it is: contiguous
    and, with ``aligned``, starting on a 16-byte boundary.  Otherwise a
    fresh contiguous copy, which the allocator aligns.  The entry points
    below apply it to CUDA inputs only: the plain versions take views."""
    if t is None or (t.is_contiguous()
                     and not (aligned and t.data_ptr() % 16)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Prefill attention: q (B, S, H, D), k/v (B, T, Hkv, D).  The Hopper
    kernel for CUDA tensors (its plain version on the CPU), or with
    ``impl="ref"`` the plain key-tile loop on any device."""
    _check_impl("flash_attention", impl)
    if impl == "ref":
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    if q.is_cuda:       # the bf16 kernel loads q, k, v by TMA
        aligned = q.dtype == torch.bfloat16
        q, k, v = (_as_kernel_input(t, aligned=aligned) for t in (q, k, v))
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


# Plain torch with no hand kernel, as in the JAX package: the decode path.
attention_ref = ref.attention


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------
def mamba2_ssd(x, dt, A, B, C, *, chunk: int = 128, init_state=None,
               impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan at any s: x (b, s, h, p), dt (b, s, h), A (h,),
    B/C (b, s, n).  As ``repro/kernels/ops.py``: ``chunk = min(chunk, s)``
    when the chunk does not divide s, and x/dt/B/C are zero-padded to a
    multiple of it (dt = 0 on padded steps: decay 1 and no input, so the
    final state is untouched) and y sliced back.  The Hopper kernel for
    CUDA tensors (its plain version on the CPU), or with ``impl="ref"``
    the plain ``ref.ssd_chunked`` on any device.  Returns (y, final state
    fp32)."""
    _check_impl("mamba2_ssd", impl)
    s = x.shape[1]
    chunk = min(chunk, s) if s % chunk else chunk
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    if impl == "ref":
        y, st = ref.ssd_chunked(x, dt, A, B, C, chunk=chunk,
                                init_state=init_state)
    else:
        if x.is_cuda:   # a misaligned x, B or C takes the fma route
            x, dt, A, B, C, init_state = (
                _as_kernel_input(t) for t in (x, dt, A, B, C, init_state))
        y, st = _ssd.mamba2_ssd(x, dt, A, B, C, chunk=chunk,
                                init_state=init_state)
    return (y[:, :s] if pad else y), st


# Plain torch with no hand kernel, as in the JAX package: the decode path.
ssd_decode_step = ref.ssd_decode_step


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_chunked(q, k, v, i_gate, f_gate, *, chunk: int, init=None,
                  impl: Optional[str] = None):
    """Chunkwise mLSTM at any s: q/k/v (b, s, h, d), i_gate/f_gate (b, s,
    h).  As ``repro/kernels/ops.py``: ``chunk = min(chunk, s)`` when the
    chunk does not divide s, and the inputs are padded to a multiple of it
    (i = -1e30 on padded steps, no insertion; f = 30, log sigmoid ~ 0, no
    decay: the state passes through) and y sliced back.  A zero initial
    state (``init`` None) runs the Hopper kernel for CUDA tensors (its
    plain version on the CPU); a given ``init`` (C, n, m), or
    ``impl="ref"``, the plain ``ref.mlstm_chunked``, as the JAX package
    routes it (its Pallas kernel has no initial state either).  Returns
    (y, (C, n, m) fp32)."""
    _check_impl("mlstm_chunked", impl)
    s = q.shape[1]
    chunk = min(chunk, s) if s % chunk else chunk
    pad = (-s) % chunk
    if pad:
        F = torch.nn.functional
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_gate = F.pad(i_gate, (0, 0, 0, pad), value=-1e30)
        f_gate = F.pad(f_gate, (0, 0, 0, pad), value=30.0)
    if impl != "ref" and init is None:
        if q.is_cuda:   # both routes read q, k, v in 16-byte vectors
            q, k, v = (_as_kernel_input(t, aligned=True) for t in (q, k, v))
            i_gate, f_gate = map(_as_kernel_input, (i_gate, f_gate))
        y, st = _mlstm.mlstm_chunk(q, k, v, i_gate, f_gate, chunk=chunk)
    else:
        y, st = ref.mlstm_chunked(q, k, v, i_gate, f_gate, chunk=chunk,
                                  init=init)
    return (y[:, :s] if pad else y), st


# Plain torch with no hand kernel, as in the JAX package: the decode path
# and the stepwise oracle.
mlstm_decode_step = ref.mlstm_decode_step
mlstm_sequential = ref.mlstm_sequential


# ---------------------------------------------------------------------------
# MoE expert matmul
# ---------------------------------------------------------------------------
def moe_gmm(x, w, *, impl: Optional[str] = None) -> torch.Tensor:
    """Batched expert matmul: x (E, C, K) × w (E, K, N) -> (E, C, N).  The
    Hopper kernel for CUDA tensors (its plain version on the CPU), or with
    ``impl="ref"`` the plain fp32 product on any device."""
    _check_impl("moe_gmm", impl)
    if impl == "ref":
        return ref.moe_gmm(x, w)
    if x.is_cuda:       # a misaligned bf16 x or w takes the mma_sync route
        x, w = _as_kernel_input(x), _as_kernel_input(w)
    return _gmm.moe_gmm(x, w)


# ---------------------------------------------------------------------------
# Fused collective stages (the Level-B executor tier; see
# repro_torch.kernels.collective_stages and repro_torch.core.lowering
# stage_impl=)
# ---------------------------------------------------------------------------
def combine_stage(acc, got, scale=None, *, accumulate: bool = True,
                  impl: Optional[str] = None, out=None) -> torch.Tensor:
    """Fused reduce-scatter combine: ``acc + dequant(got)`` in one pass.

    ``got`` may be in a narrower wire dtype (bf16, or int8 with
    ``scale``); ``accumulate=False`` is the allgather-leg chunk install.
    ``out`` (may be ``acc``) receives the result in place.
    """
    _check_impl("combine_stage", impl)
    if impl == "ref":
        return ref.combine_stage(acc, got, scale, accumulate=accumulate,
                                 out=out)
    return _stages.fused_combine(acc, got, scale, accumulate=accumulate,
                                 out=out)


def wire_scale(x: torch.Tensor) -> torch.Tensor:
    """``max(max|x|, 1e-20) / 127`` as a 0-d fp32 tensor on ``x``'s
    device (plain torch, outside the kernel, as the JAX package leaves it
    to XLA; no temporary of ``|x|`` is written)."""
    lo, hi = torch.aminmax(x)
    amax = torch.maximum(hi.abs(), lo.abs()).float()
    return torch.clamp_min(amax, 1e-20) / 127.0


def quantize_stage(x, *, impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 wire quantisation; returns ``(q, scale)``.

    The scale stays a 0-d fp32 tensor on the device: reading it on the
    host would synchronise every rank's stream once per round.
    """
    _check_impl("quantize_stage", impl)
    scale = wire_scale(x)
    if impl == "ref":
        return ref.quantize_stage(x, scale), scale
    return _stages.quantize_wire(x, scale), scale


def dequantize_stage(q, scale, dtype=torch.float32, *,
                     impl: Optional[str] = None, out=None) -> torch.Tensor:
    """``q × scale`` cast to ``dtype``: the decode of int8 wire chunks
    (into ``out`` when given)."""
    _check_impl("dequantize_stage", impl)
    if impl == "ref":
        return ref.dequantize_stage(q, scale, dtype, out=out)
    return _stages.dequantize_wire(q, scale, dtype, out=out)


def gs_stencil(block, top, left, bottom, right, *,
               impl: Optional[str] = None):
    """Fused Gauss–Seidel block stage: 4-point update, L1 residual and
    the four outgoing boundary edges in one pass over the block.
    Returns ``(new_block, residual, (top, bottom, left, right))``."""
    _check_impl("gs_stencil", impl)
    if impl == "ref":
        return ref.gs_stencil(block, top, left, bottom, right)
    if block.is_cuda:   # a misaligned block takes the scalar route; a halo
        block = _as_kernel_input(block)     # of another dtype is cast
        top, left, bottom, right = (
            _as_kernel_input(h) if h.dtype == block.dtype else h
            for h in (top, left, bottom, right))
    return _stages.gs_stencil(block, top, left, bottom, right)
