"""Pipeline parallelism: GPipe-style microbatch schedule over a stage axis
of a logical mesh — the port of ``repro/core/pipeline.py``.

Stages are the ranks along a mesh axis; activations travel stage→stage
through :meth:`repro_torch.core.mesh.LogicalMesh.ppermute`.  The schedule
is the classic GPipe ladder: with S stages and M microbatches the loop
runs M+S−1 ticks; stage s computes microbatch t−s at tick t, on its own
stream.  Bubble fraction = (S−1)/(M+S−1).  Communication pattern: one
``ppermute`` per tick.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .mesh import LogicalMesh
from .overlap import tree_flatten, tree_unflatten


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *,
                   mesh: LogicalMesh, stage_axis: str = "stage"
                   ) -> torch.Tensor:
    """Run ``stage_fn`` as a pipeline over ``stage_axis``.

    ``stage_params``: a tree of tensors with a leading stage dimension
    (stage ``s`` uses index ``s``); ``x``: (M, ...) microbatched inputs.
    Returns the (M, ...) outputs of the final stage — replicated on every
    rank in the reference, so one tensor here.
    """
    S = mesh.axis_size(stage_axis)
    M = x.shape[0]
    leaves, treedef = tree_flatten(stage_params)
    ranks = range(mesh.size)
    sid = [mesh.axis_index(r, stage_axis) for r in ranks]
    params = [tree_unflatten(treedef, [p[sid[r]] for p in leaves])
              for r in ranks]
    fwd_perm = [(i, (i + 1) % S) for i in range(S)]
    with mesh.region():
        inbuf, outbuf = [], []
        for r in ranks:
            with mesh.on(r):
                inbuf.append(torch.zeros_like(x[0]))
                outbuf.append(torch.zeros_like(x))
        for t in range(M + S - 1):
            ys = []
            for r in ranks:
                m = t - sid[r]          # microbatch index at this stage
                mb = min(max(m, 0), M - 1)
                with mesh.on(r):
                    # stage 0 reads the raw microbatch; others the permuted
                    x_in = x[mb] if sid[r] == 0 else inbuf[r]
                    y = stage_fn(params[r], x_in)
                    if not 0 <= m < M:
                        y = torch.zeros_like(y)
                    elif sid[r] == S - 1:   # last stage records its output
                        outbuf[r][mb] = y
                ys.append(y)
            # everyone ships their activation to the next stage
            inbuf = mesh.ppermute(ys, stage_axis, fwd_perm)
        # replicate the last stage's collected outputs to every stage
        masked = []
        for r in ranks:
            with mesh.on(r):
                masked.append(outbuf[r] * float(sid[r] == S - 1))
        out = mesh.psum(masked, stage_axis)
    return out[0]
