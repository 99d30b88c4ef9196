"""Gradient synchronisation schedules — the Level-B TAMPI adaptation, on
logical ranks.

The port of ``repro/core/overlap.py``.  The gradient synchronisation of a
data-parallel step comes in the reference's three shapes:

* ``fused``    — ONE allreduce over the whole flattened gradient: the
                 Fork-Join/Pure-MPI phase boundary;
* ``bucketed`` — one allreduce per parameter bucket with NO artificial
                 dependencies between them: the Interop/TAMPI pattern,
                 dependencies alone order the collectives;
* ``sentinel`` — the bucketed collectives serialised through a token, the
                 artificial sentinel dependency of paper §6.3/§7.1.  Here
                 the token is one CUDA event per rank
                 (:meth:`repro_torch.core.mesh.LogicalMesh.token`): before
                 bucket *k+1*'s first op every rank's stream waits until
                 bucket *k*'s reduction finished on EVERY rank
                 (``mesh.token_waits`` counts the waits; ``bucketed``
                 adds none).

Each bucket's reduction is one :func:`repro_torch.core.lowering.allreduce`
over the :class:`~repro_torch.core.mesh.LogicalMesh`.  Gradients are given
as one tree per rank (nested dicts, lists or tuples of tensors, flattened
in ``jax.tree_util``'s order: dict keys sorted, recursively — bucket
boundaries, and so the ring's chunking and the last bits of the result,
depend on that order), and come back the same way.

Memory: each rank's bucket is packed into one flat buffer in its wire
dtype (leaves copied in, converting on the fly), the rounds reduce it in
place, and the mean divides it in place before the cast back to each
leaf's dtype — the reference's values, without its functional copies.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..kernels import ref as kernel_ref
from ..kernels.ops import wire_scale
from . import lowering
from . import schedule as schedule_ir
from .mesh import LogicalMesh, Token
from .options import CollectiveOptions

DEFAULT_BUCKET_BYTES = 4 << 20

__all__ = ["sync_grads", "quantized_psum_mean", "halo_exchange_rows",
           "chained", "tree_flatten", "tree_unflatten",
           "DEFAULT_BUCKET_BYTES"]


# ---------------------------------------------------------------------------
# Trees in jax.tree_util's leaf order
# ---------------------------------------------------------------------------
def _flatten_into(t, leaves: List[Any]):
    if isinstance(t, dict):
        keys = sorted(t)
        return (dict, tuple(keys),
                tuple(_flatten_into(t[k], leaves) for k in keys))
    if isinstance(t, (list, tuple)):
        return (type(t), None, tuple(_flatten_into(c, leaves) for c in t))
    leaves.append(t)
    return None


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves in ``jax.tree_util`` order (dict keys sorted, recursively;
    lists and tuples in order) and a structure for :func:`tree_unflatten`.
    (Module-level recursion: a recursive closure would be a reference
    cycle holding the leaves until the cyclic collector ran.)"""
    leaves: List[Any] = []
    return leaves, _flatten_into(tree, leaves)


def _build(d, it):
    if d is None:
        return next(it)
    kind, keys, kids = d
    if kind is dict:
        return {k: _build(c, it) for k, c in zip(keys, kids)}
    return kind(_build(c, it) for c in kids)


def tree_unflatten(treedef, leaves: Sequence[Any]):
    return _build(treedef, iter(leaves))


def _make_buckets(nbytes: Sequence[int],
                  bucket_bytes: int) -> List[List[int]]:
    """Greedy byte-based bucketing of leaf indices (DDP-style).

    ``nbytes[i]`` is leaf i's byte count AS SENT (``size × wire-dtype
    itemsize``), so ``bucket_bytes`` bounds the actual message size.
    """
    buckets: List[List[int]] = []
    cur: List[int] = []
    acc = 0
    for i, b in enumerate(nbytes):
        cur.append(i)
        acc += b
        if acc >= bucket_bytes:
            buckets.append(cur)
            cur, acc = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def _wire_dtype(leaf: torch.Tensor, compress: Optional[str],
                policy: str) -> torch.dtype:
    """The dtype a leaf travels (and accumulates) in: fp32 by default,
    the leaf's own floating dtype under ``reduce_dtype="leaf"``, bf16
    under ``compress="bf16"``."""
    if compress == "bf16":
        return torch.bfloat16
    if compress is None and policy == "leaf" and leaf.is_floating_point():
        return leaf.dtype
    return torch.float32


def _pack(mesh: LogicalMesh, leaves: List[List[torch.Tensor]],
          sel: Sequence[int], sizes: Sequence[int],
          wdt: torch.dtype) -> List[torch.Tensor]:
    """Each rank's leaves ``sel`` end to end in one ``wdt`` buffer."""
    total = sum(sizes[i] for i in sel)
    out = []
    for r in range(mesh.size):
        with mesh.on(r):
            flat = torch.empty(total, dtype=wdt, device=mesh.device)
            off = 0
            for i in sel:
                flat[off:off + sizes[i]].copy_(leaves[r][i].reshape(-1))
                off += sizes[i]
        out.append(flat)
    return out


def sync_grads(grads: Sequence[Any], *, mesh: LogicalMesh, axes,
               mode: str = "bucketed",
               bucket_bytes: int = DEFAULT_BUCKET_BYTES,
               compress: Optional[str] = None, mean: bool = True,
               algorithm: Optional[str] = None, segments: int = 1,
               reduce_dtype: Optional[str] = None,
               hierarchical: Optional[bool] = None,
               stage_impl: Optional[str] = None,
               stage_wire: Optional[str] = None,
               options: Optional[CollectiveOptions] = None) -> List[Any]:
    """Reduce every rank's gradient tree over the DP ``axes`` of ``mesh``.

    ``grads[r]`` is rank ``r``'s tree; returns one reduced tree per rank
    (the mean over the axes unless ``mean=False``), leaves in their
    original dtypes.  ``mode`` picks the bucketing/ordering pattern
    (fused/bucketed/sentinel); ``algorithm`` picks each bucket's schedule
    — ``"native"`` (one ``psum``, the default), ``"ring"``/``"doubling"``
    (explicit rounds; single DP axis), with ``segments > 1`` pipelining
    the ring.  ``hierarchical=True`` needs exactly two DP axes in
    ``(inter, intra)`` order and reduces each bucket with the composed
    two-axis schedule.

    Presentation dtype: by default (``reduce_dtype="fp32"``) every leaf
    travels and accumulates in fp32; ``reduce_dtype="leaf"`` keeps
    floating leaves in their own dtype; ``compress="bf16"`` sends
    everything in bf16 and ``compress="int8"`` takes the quantised
    all-to-all path (:func:`quantized_psum_mean`).  Buckets are
    dtype-grouped and sized by bytes AS SENT.  ``options=`` takes a
    :class:`CollectiveOptions`.

    ``stage_impl`` (``None``/``"cuda"``/``"ref"``) routes each bucket's
    between-round stages through the stage tier (explicit-round
    algorithms only); ``stage_wire`` (``"bf16"``/``"int8"``) narrows the
    ring transport dtype per round.
    """
    (algorithm, segments, hierarchical, stage_impl, stage_wire,
     reduce_dtype) = CollectiveOptions.merge(
        options, algorithm=algorithm, segments=segments,
        hierarchical=hierarchical, stage_impl=stage_impl,
        stage_wire=stage_wire, reduce_dtype=reduce_dtype)
    algorithm = algorithm or "native"
    reduce_dtype = reduce_dtype or "fp32"
    hierarchical = bool(hierarchical)
    if isinstance(axes, str):
        axes = (axes,)
    axis_arg = tuple(axes)
    if compress == "int8" and (stage_impl is not None
                               or stage_wire is not None):
        raise ValueError("compress='int8' uses its own quantised "
                         "all_to_all path; drop stage_impl=/stage_wire=")
    if hierarchical:
        if len(axis_arg) != 2:
            raise ValueError(f"hierarchical grad sync needs exactly two "
                             f"DP axes (inter, intra), got {axis_arg}")
        if algorithm != "native" or segments != 1:
            raise ValueError("hierarchical=True picks the schedule; drop "
                             "algorithm=/segments=")
        algorithm = "hierarchical"
    if reduce_dtype not in ("fp32", "leaf"):
        raise ValueError(f"unknown reduce_dtype policy {reduce_dtype!r}; "
                         f"one of ['fp32', 'leaf']")
    if mode not in ("fused", "bucketed", "sentinel"):
        raise ValueError(f"unknown grad sync mode {mode!r}")
    if len(grads) != mesh.size:
        raise ValueError(f"need one gradient tree per rank ({mesh.size}), "
                         f"got {len(grads)}")
    flat = [tree_flatten(g) for g in grads]
    treedef = flat[0][1]
    leaves = [f[0] for f in flat]
    for r, (lv, td) in enumerate(flat):
        if td != treedef or [l.shape for l in lv] != \
                [l.shape for l in leaves[0]]:
            raise ValueError(f"rank {r}'s gradient tree differs from "
                             f"rank 0's")
    shapes = [l.shape for l in leaves[0]]
    sizes = [l.numel() for l in leaves[0]]
    ws = mesh.axis_size(axis_arg)

    def reduce_block(xs: List[torch.Tensor]) -> List[torch.Tensor]:
        if compress == "int8":
            assert len(axis_arg) == 1, "int8 path: single reduction axis"
            out = quantized_psum_mean([x.float() for x in xs], axis_arg[0],
                                      mesh=mesh)
            n_axis = mesh.axis_size(axis_arg[0])
            for r in range(mesh.size):
                with mesh.on(r):       # sync_grads divides later
                    out[r] = out[r] * n_axis
            return out
        if compress == "bf16":
            for r in range(mesh.size):
                with mesh.on(r):
                    xs[r] = xs[r].to(torch.bfloat16)
        xs = lowering.allreduce(xs, axis_arg, mesh=mesh,
                                algorithm=algorithm, segments=segments,
                                stage_impl=stage_impl,
                                stage_wire=stage_wire, inplace=True)
        for r in range(mesh.size):
            with mesh.on(r):
                xs[r] = xs[r].float()
        return xs

    # Leaves group by their presentation dtype in EVERY mode, so the
    # per-leaf numerics are identical whichever mode is selected.
    groups: Dict[torch.dtype, List[int]] = {}
    for i, l in enumerate(leaves[0]):
        groups.setdefault(_wire_dtype(l, compress, reduce_dtype),
                          []).append(i)
    out: List[List[Optional[torch.Tensor]]] = [
        [None] * len(sizes) for _ in range(mesh.size)]

    def finish(sel: Sequence[int], reduced: List[torch.Tensor]) -> None:
        for r in range(mesh.size):
            with mesh.on(r):
                if mean:
                    reduced[r].div_(ws)
                off = 0
                for i in sel:
                    out[r][i] = reduced[r][off:off + sizes[i]].view(
                        shapes[i]).to(leaves[r][i].dtype, copy=True)
                    off += sizes[i]

    with mesh.region():
        if mode == "fused":
            # one collective per wire dtype — the fork-join phase boundary
            for wdt, idxs in groups.items():
                finish(idxs, reduce_block(
                    _pack(mesh, leaves, idxs, sizes, wdt)))
        else:
            token: Optional[Token] = None
            for wdt, idxs in groups.items():
                itemsize = 1 if compress == "int8" else wdt.itemsize
                nbytes = [sizes[i] * itemsize for i in idxs]
                for b in _make_buckets(nbytes, bucket_bytes):
                    sel = [idxs[j] for j in b]
                    if mode == "sentinel" and token is not None:
                        # Serialise on the previous collective — the
                        # artificial dependency the paper's technique
                        # removes.
                        mesh.wait_token(token)
                    finish(sel, reduce_block(
                        _pack(mesh, leaves, sel, sizes, wdt)))
                    if mode == "sentinel":
                        token = mesh.token()
    return [tree_unflatten(treedef, o) for o in out]


# ---------------------------------------------------------------------------
# int8 quantized reduction (gradient compression, 4x wire reduction)
# ---------------------------------------------------------------------------
def quantized_psum_mean(xs: List[torch.Tensor], axis: str, *,
                        mesh: LogicalMesh) -> List[torch.Tensor]:
    """Mean-reduce each rank's flat fp32 vector over ``axis`` with int8 on
    the wire.

    Reduce-scatter leg: per-rank symmetric int8 quantisation (scales
    exchanged as 0-d device tensors), shards moved with an int8
    ``all_to_all``, dequantised and summed in fp32; allgather leg: the
    reduced shard is re-quantised and gathered in int8.  Plain PyTorch,
    as the reference is plain jnp.
    """
    world = mesh.axis_size(axis)
    n = xs[0].numel()
    pad = (-n) % world
    qs, scales = [], []
    with mesh.region():
        for r in range(mesh.size):
            with mesh.on(r):
                x = xs[r].reshape(-1)
                if pad:
                    x = torch.cat([x, x.new_zeros(pad)])
                scale = wire_scale(x)
                qs.append(kernel_ref.quantize_stage(x, scale).view(world, -1))
                scales.append(scale)
        recv = mesh.all_to_all(qs, axis)        # my shard of everyone's q
        gscales = mesh.all_gather(scales, axis)         # (world,) fp32
        q2s, s2s = [], []
        for r in range(mesh.size):
            with mesh.on(r):
                partial = torch.sum(recv[r].float() * gscales[r][:, None],
                                    dim=0) / world
                s2 = wire_scale(partial)
                q2s.append(kernel_ref.quantize_stage(partial, s2))
                s2s.append(s2)
        gathered = mesh.all_gather(q2s, axis)   # (world, n/world) int8
        gs2 = mesh.all_gather(s2s, axis)
        out = []
        for r in range(mesh.size):
            with mesh.on(r):
                o = (gathered[r].float() * gs2[r][:, None]).reshape(-1)
                out.append(o[:n] if pad else o)
    return out


# ---------------------------------------------------------------------------
# Halo exchange schedules (Gauss–Seidel, paper §7.1 at Level B)
# ---------------------------------------------------------------------------
def halo_exchange_rows(xs: List[torch.Tensor], axis_name: str, *,
                       mesh: LogicalMesh, width: int = 1
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Exchange boundary rows with both neighbours along ``axis_name``.

    ``xs[r]`` is rank ``r``'s local (rows, cols) block of a 1-D row
    decomposition.  Returns (top halos, bottom halos), one per rank,
    received from the previous/next rank (zeros at the domain edges):
    the 1-D non-periodic neighbourhood schedule — the same
    :func:`repro_torch.core.schedule.build_neighbor` IR the host-side
    :class:`repro_torch.core.collectives.HaloExchange` interprets —
    lowered to one ppermute per direction.
    """
    n = mesh.axis_size(axis_name)
    sched = schedule_ir.build_neighbor(lowering.chain_topology(n))
    got = lowering.lower_neighbor(
        sched, {(0, 1): [x[-width:] for x in xs],
                (0, -1): [x[:width] for x in xs]}, axis_name, mesh=mesh)
    return got[(0, -1)], got[(0, 1)]


def chained(xs: List[torch.Tensor], token: Optional[Token], *,
            mesh: LogicalMesh) -> Tuple[List[torch.Tensor], Token]:
    """Serialise ``xs`` on ``token`` (sentinel-style artificial
    dependency): every rank's stream waits for the token on every rank;
    returns ``xs`` unchanged and a new token recorded after them."""
    if token is not None:
        mesh.wait_token(token)
    return xs, mesh.token()
