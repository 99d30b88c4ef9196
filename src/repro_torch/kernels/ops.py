"""Public kernel entry points with dispatch — the port of
``repro/kernels/ops.py``.

* ``impl="cuda"`` — the hand-written kernel's wrapper: the kernel for CUDA
  tensors, its plain version for CPU tensors;
* ``impl="ref"``  — the plain-PyTorch version (:mod:`.ref`);
* ``impl=None``   — the same as ``"cuda"``: the kernel on the card.
"""

from __future__ import annotations

from typing import Optional

from . import collective_stages as _stages
from . import ref

IMPLS = (None, "cuda", "ref")


def gs_stencil(block, top, left, bottom, right, *,
               impl: Optional[str] = None):
    """Fused Gauss–Seidel block stage: 4-point update, L1 residual and
    the four outgoing boundary edges in one pass over the block.
    Returns ``(new_block, residual, (top, bottom, left, right))``."""
    if impl not in IMPLS:
        raise ValueError(f"gs_stencil: impl must be one of {IMPLS}, "
                         f"got {impl!r}")
    if impl == "ref":
        return ref.gs_stencil(block, top, left, bottom, right)
    return _stages.gs_stencil(block, top, left, bottom, right)
