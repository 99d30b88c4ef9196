"""Optimizer substrate: AdamW with fp32 master weights, clipping, schedules.

The port of ``repro/optim/__init__.py``.  The optimizer state is a tree
beside the parameter tree (:func:`repro_torch.models.model.param_tree`):
``m``, ``v`` and ``master`` have the parameters' structure, fp32.  Leaves
are tensors, taken in ``core/overlap.tree_flatten``'s order (dict keys
sorted, sequences in order), which is the order the reference's
``jax.tree_util`` takes them in.  A tuple in the tree holds the per-unit
parts of one leaf that the reference stacks along a leading ``repeats``
axis (``model.param_tree``'s layers): weight decay follows the stacked
leaf's rank, as the reference's ``ndim >= 2`` test sees it, so a
per-layer norm scale decays there and here alike.

Unlike the reference, which returns new trees, :func:`update` writes the
new moments, masters and parameters IN PLACE: a full-width model's AdamW
state is 12 bytes a parameter, and a functional copy of it would not fit
beside the original on one card.  ``step`` is a 0-d int32 tensor on the
host, as the reference's checkpoint stores it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..core.overlap import tree_flatten, tree_unflatten

__all__ = ["OptimConfig", "OptState", "lr_at", "init", "global_norm",
           "update", "decays"]


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor       # () int32, on the host
    m: Any                   # fp32, like params
    v: Any                   # fp32, like params
    master: Any              # fp32 master copy of params


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as a Python float."""
    return torch.tensor(x, dtype=torch.float32).item()


def lr_at(cfg: OptimConfig, step) -> float:
    """Linear warmup then cosine decay to ``min_lr_ratio``, in fp32 as the
    reference computes it (each operation rounded to fp32)."""
    f32 = torch.float32
    s = torch.as_tensor(step).to(f32)
    warm = cfg.peak_lr * s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return float(torch.where(s < cfg.warmup_steps, warm, cfg.peak_lr * cos))


def init(params) -> OptState:
    """Zero moments and fp32 masters for a parameter tree."""
    leaves, treedef = tree_flatten(params)
    zeros = lambda: tree_unflatten(treedef, [  # noqa: E731
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in leaves])
    master = tree_unflatten(treedef, [
        p.detach().to(torch.float32, copy=True) for p in leaves])
    return OptState(step=torch.zeros((), dtype=torch.int32), m=zeros(),
                    v=zeros(), master=master)


def _decays(tree, extra: int = 0, out: Optional[List[bool]] = None
            ) -> List[bool]:
    """Per leaf, in tree order: whether AdamW decays it, i.e. whether
    the reference's leaf has ``ndim >= 2`` (a tuple's parts are slices of
    one stacked leaf, which has one dimension more)."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _decays(tree[k], 0, out)
    elif isinstance(tree, (list, tuple)):
        for c in tree:
            _decays(c, 1 if isinstance(tree, tuple) else 0, out)
    else:
        out.append(tree.dim() + extra >= 2)
    return out


def decays(tree) -> List[bool]:
    """Per leaf of a parameter tree, in tree order: whether AdamW decays
    it (``_decays``; a leaf only needs ``dim()``)."""
    return _decays(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves, in tree order, of each leaf's sum of
    fp32 squares: a 0-d fp32 tensor on the leaves' device."""
    total = None
    for x in tree_flatten(tree)[0]:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: OptimConfig, grads, state: OptState, params, *,
           grad_norm: Optional[torch.Tensor] = None,
           decays: Optional[List[bool]] = None
           ) -> Tuple[Any, OptState, Dict[str, Any]]:
    """One AdamW step: clip by global norm, fp32 moments, bias correction,
    decay on leaves the reference sees with ``ndim >= 2`` only (see the
    module's note on tuples), fp32 masters cast back to
    each parameter's dtype.  ``grads`` has the parameters' structure (any
    floating dtype).  Updates ``state``'s trees and ``params`` in place and
    returns ``(params, new state, metrics)``: ``lr`` (float) and
    ``grad_norm`` (0-d fp32 tensor on the device, not read back).

    A sharded step passes one rank's blocks as the trees, the norm of the
    whole gradient as ``grad_norm`` and each leaf's decay as ``decays``
    (decided from the whole leaf's shape, never a block's)."""
    step = state.step + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = (torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                         max=1.0) if cfg.clip_norm else None)
    t = float(step)
    b1c = _f32(1 - _f32(cfg.b1) ** t)
    b2c = _f32(1 - _f32(cfg.b2) ** t)

    ps = tree_flatten(params)[0]
    gs, ms, vs, mas = (tree_flatten(x)[0] for x in
                       (grads, state.m, state.v, state.master))
    if not len(ps) == len(gs) == len(ms) == len(vs) == len(mas):
        raise ValueError("params, grads and optimizer state differ in "
                         "structure")
    for p, g, m, v, master, decay in zip(
            ps, gs, ms, vs, mas, _decays(params) if decays is None
            else decays):
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decay:               # decay matrices only (norms/bias exempt)
            delta.add_(master, alpha=cfg.weight_decay)
        master.sub_(delta, alpha=lr)
        p.copy_(master)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, OptState(step, state.m, state.v, state.master), metrics
