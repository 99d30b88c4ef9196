"""Plain-PyTorch versions of the port's kernels.

Each function computes what its hand-written kernel computes, in the same
arithmetic order, with ordinary tensor operations: the CPU path of the
kernel wrappers, the oracle the CPU tests hold the port against the JAX
package with, and the version ``chip_smoke.py`` compares each kernel to on
the card.  Counterpart of the collective-stage oracles in
``repro/kernels/ref.py`` (``combine_stage``, ``quantize_stage``,
``dequantize_stage`` and ``gs_stencil``).
"""

from __future__ import annotations

import torch


def gs_stencil(block: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
               bottom: torch.Tensor, right: torch.Tensor):
    """Fused Gauss–Seidel block stage: 4-point update, fp32 L1 residual
    and the four new boundary edges.

    Returns ``(new_block, residual, (top, bottom, left, right))``.  The
    update sums ``((up + down) + left) + right`` and then scales by 0.25,
    in fp32; the residual ``sum|new - old|`` uses the unrounded fp32
    ``new``; block and edges are rounded to the block's dtype.  The halos
    are rounded to the block's dtype first, as the Pallas wrapper does.
    """
    dt = block.dtype
    b = block.float()
    H, W = b.shape
    up = torch.cat([top.to(dt).reshape(1, W).float(), b[:-1, :]], dim=0)
    down = torch.cat([b[1:, :], bottom.to(dt).reshape(1, W).float()], dim=0)
    lft = torch.cat([left.to(dt).reshape(H, 1).float(), b[:, :-1]], dim=1)
    rgt = torch.cat([b[:, 1:], right.to(dt).reshape(H, 1).float()], dim=1)
    new = 0.25 * (up + down + lft + rgt)
    res = torch.sum(torch.abs(new - b))
    new = new.to(dt)
    return new, res, (new[0, :], new[-1, :], new[:, 0].contiguous(),
                      new[:, -1].contiguous())


def combine_stage(acc: torch.Tensor, got: torch.Tensor, scale=None, *,
                  accumulate: bool = True, out=None) -> torch.Tensor:
    """``acc + dequant(got)``: the fused combine of one reduce-scatter
    round, or with ``accumulate=False`` just ``dequant(got)`` (the
    allgather-leg install, which never reads ``acc``).

    ``got`` is cast to ``acc.dtype``, or with ``scale`` (a 0-d fp32
    tensor) first widened to fp32 and multiplied by it, then cast; the add
    runs in the promoted type and rounds once (a bf16 + bf16 add is an fp32
    add rounded to bf16).  ``out`` (may be ``acc`` itself) receives the
    result in place.
    """
    if scale is None:
        g = got.to(acc.dtype)
    else:
        g = (got.float() * scale).to(acc.dtype)
    if not accumulate:
        return g if out is None else out.copy_(g)
    return torch.add(acc, g, out=out)


def quantize_stage(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantisation: ``round(x / scale)`` in fp32 (a true
    division, rounding half to even), clipped to ±127."""
    q = torch.round(x.float() / scale)
    return q.clamp_(-127.0, 127.0).to(torch.int8)


def dequantize_stage(q: torch.Tensor, scale, dtype=torch.float32, *,
                     out=None) -> torch.Tensor:
    """``q × scale`` in fp32, cast to ``dtype`` (into ``out`` when
    given)."""
    v = (q.float() * scale).to(dtype)
    return v if out is None else out.copy_(v)
