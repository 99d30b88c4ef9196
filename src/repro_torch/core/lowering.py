"""Level-B executor: schedule IR lowered to rounds over logical ranks.

The port of ``repro/core/lowering.py``, the second consumer of
:mod:`repro_torch.core.schedule` (the first is the host interpreter in
:mod:`repro_torch.core.collectives`).  The JAX package emits each round as
a ``lax.ppermute`` inside ``shard_map``; here the ranks are the logical
ranks of a :class:`repro_torch.core.mesh.LogicalMesh` on one device, a
per-rank value is a list with one tensor per rank, each round is one
:meth:`~repro_torch.core.mesh.LogicalMesh.ppermute` (one set of peer
copies), and rank ``r``'s elementwise work runs on rank ``r``'s stream.
Every function takes the mesh as ``mesh=``.

The same strategies as the reference, chosen by the schedule:

* **Explicit rounds** — ring (any rank count, any segment count) and
  recursive-doubling (power-of-two rank counts) allreduces as ``2(n-1)·S``
  ring rounds and ``log2 n`` butterfly rounds, mirroring the schedule's
  transfers chunk for chunk (``sends_per_rank``).  Non-power-of-two
  doubling is one ``psum``, as in the reference.
* **Fused node** — ``algorithm="native"``: one ``psum`` over the axes.
* **Neighbourhood** — ``lower_neighbor``: one ``ppermute`` per direction,
  pairs read off the schedule's transfers; ranks with no pair get zeros.
* **Hierarchical two-axis** — intra-axis ring reduce-scatter and
  allgather rounds around an inter-axis butterfly (or one ``psum`` for a
  non-power-of-two pod count).

**Stage tier** (``stage_impl=``): the between-round elementwise stages —
reduce-scatter combine, allgather install, wire cast/dequant — go through
:mod:`repro_torch.kernels.ops`: ``"cuda"`` the hand-written Hopper
kernels (their plain versions for CPU tensors), ``"ref"`` the plain
PyTorch versions, ``None`` the plain add of the unfused path.
``stage_wire="bf16"|"int8"`` narrows the ring transport dtype as in the
reference: reduce-scatter rounds quantise the outgoing chunk and the
fused combine dequantises while accumulating; the allgather leg
quantises each reduced chunk once at its owner, forwards the wire bytes
around the ring and every rank decodes all chunks at the end, so all
ranks compute bit-identical results.  Under the int8 wire that final
decode is the ``dequantize_wire`` kernel (``ops.dequantize_stage``), the
reference kernel's stated role; it computes exactly what the reference's
``combine_stage(accumulate=False)`` does there.

**In place.**  The reference is functional (``chunks.at[...].set``).  The
port updates each rank's flat buffer in place to save memory: with
``inplace=True`` that buffer is the caller's tensor itself (when no
padding is needed) and the caller's inputs are overwritten; by default
each input is copied first.  Results may be views of that buffer.  Each
round's received buffers are dropped before the next round's
``ppermute`` allocates its own, so one round's worth is alive at a time.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..kernels import ops as kernel_ops
from . import schedule as schedule_ir
from .mesh import LogicalMesh
from .options import CollectiveOptions
from .schedule import Schedule, Send

Axes = Union[str, Sequence[str]]
Values = List[torch.Tensor]

_WIRE_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def _check_stage_opts(algorithm: str, stage_impl: Optional[str],
                      wire: Optional[str]) -> None:
    if stage_impl not in kernel_ops.IMPLS:
        raise ValueError(f"unknown stage_impl {stage_impl!r}; the port's "
                         f"stage tiers are {kernel_ops.IMPLS} (the unfused "
                         f"add, the hand-written CUDA kernels, their plain "
                         f"PyTorch versions)")
    if wire is None:
        return
    if wire not in _WIRE_DTYPES:
        raise ValueError(f"unknown stage_wire dtype {wire!r}; choose from "
                         f"{sorted(_WIRE_DTYPES)}")
    if stage_impl is None:
        raise ValueError("stage_wire= needs a fused stage tier; pass "
                         "stage_impl=")
    if algorithm != "ring":
        raise ValueError(f"wire cast covers explicit ring rounds only, "
                         f"not algorithm={algorithm!r}")


def _single_axis(axis_name: Axes, what: str) -> str:
    if isinstance(axis_name, str):
        return axis_name
    axes = tuple(axis_name)
    if len(axes) != 1:
        raise ValueError(f"{what} lowers over a single mesh axis, got "
                         f"{axes}; use algorithm='native' for axis tuples")
    return axes[0]


def _two_axes(axis_name: Axes) -> Tuple[str, str]:
    """``(inter, intra)`` mesh axes of a hierarchical lowering."""
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    if len(axes) != 2:
        raise ValueError(f"hierarchical allreduce lowers over exactly two "
                         f"mesh axes (inter, intra), got {axes}")
    return axes[0], axes[1]


def _check_world(sched: Schedule, mesh: LogicalMesh, axis_name: str) -> None:
    n = mesh.axis_size(axis_name)
    if sched.n != n:
        raise ValueError(f"schedule is for {sched.n} ranks but axis "
                         f"{axis_name!r} has {n} shards")


def _check_values(mesh: LogicalMesh, xs: Sequence[torch.Tensor]) -> None:
    if len(xs) != mesh.size:
        raise ValueError(f"need one tensor per rank ({mesh.size}), got "
                         f"{len(xs)}")
    shape = xs[0].shape
    for x in xs:
        if x.shape != shape or x.dtype != xs[0].dtype:
            raise ValueError(f"per-rank values differ in shape or dtype: "
                             f"{tuple(x.shape)} {x.dtype} vs "
                             f"{tuple(shape)} {xs[0].dtype}")


def sends_per_rank(sched: Schedule) -> int:
    """Transfer rounds each rank issues — the lowered ppermute count per
    explicit-round leg (structural-equivalence hook for tests)."""
    return max(sum(isinstance(op, Send) for op in prog)
               for prog in sched.programs)


def _flats(mesh: LogicalMesh, xs: Values, pieces: int,
           inplace: bool) -> Tuple[Values, int]:
    """Each rank's flat working buffer, zero-padded to a multiple of
    ``pieces``; returns (buffers, padding)."""
    m = xs[0].numel()
    pad = (-m) % pieces
    out = []
    for r, x in enumerate(xs):
        with mesh.on(r):
            flat = x.reshape(-1)
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            elif not inplace:
                flat = flat.clone()
            out.append(flat)
    return out, pad


def _unflat(flats: Values, xs: Values, pad: int) -> Values:
    m = xs[0].numel()
    return [(f[:m] if pad else f).view(x.shape) for f, x in zip(flats, xs)]


# ---------------------------------------------------------------------------
# Allreduce lowerings
# ---------------------------------------------------------------------------
def allreduce(xs: Values, axes: Axes, *, mesh: LogicalMesh,
              algorithm: Optional[str] = None, segments: int = 1,
              sched: Optional[Schedule] = None,
              stage_impl: Optional[str] = None,
              stage_wire: Optional[str] = None,
              options: Optional[CollectiveOptions] = None,
              inplace: bool = False) -> Values:
    """Sum-allreduce the per-rank tensors ``xs`` over ``axes`` of ``mesh``
    with a chosen schedule.

    ``algorithm="native"`` (the default) is one ``psum``;
    ``"ring"``/``"doubling"``/``"hierarchical"`` build (or take) a
    schedule and run its explicit rounds.  ``stage_impl`` routes the
    between-round stages through the stage tier (``"cuda"``/``"ref"``;
    ``None`` keeps the plain add); ``stage_wire`` narrows the ring
    transport dtype (``"bf16"``/``"int8"``; needs ``stage_impl``, ring
    only).  ``options=`` takes a :class:`CollectiveOptions`.  ``inplace=True``
    lets the rounds overwrite ``xs`` (see the module docstring).
    """
    algorithm, segments, stage_impl, stage_wire = CollectiveOptions.merge(
        options, algorithm=algorithm, segments=segments,
        stage_impl=stage_impl, stage_wire=stage_wire)
    if algorithm is None:
        algorithm = "native"
    if sched is None and algorithm == "native":
        if stage_impl is not None or stage_wire is not None:
            raise ValueError("native lowering is one fused psum node — "
                             "no stages to fuse; drop "
                             "stage_impl=/stage_wire=")
        _check_values(mesh, xs)
        with mesh.region():
            return mesh.psum(xs, axes)
    _check_stage_opts(algorithm if sched is None else sched.algorithm,
                      stage_impl, stage_wire)
    if sched is None and algorithm == "hierarchical":
        if segments != 1:
            # mirror Collectives._resolve: the composed schedule is fixed,
            # silently dropping segments would fake pipelining.
            raise ValueError("hierarchical allreduce fixes the composed "
                             "schedule; drop segments=")
        inter_axis, intra_axis = _two_axes(axes)
        sched = schedule_ir.build_hierarchical(mesh.axis_size(intra_axis),
                                               mesh.axis_size(inter_axis))
    if sched is None:
        axis = _single_axis(axes, f"allreduce[{algorithm}]")
        sched = schedule_ir.build("allreduce", algorithm,
                                  mesh.axis_size(axis), segments=segments)
    return lower_allreduce(sched, xs, axes, mesh=mesh, stage_impl=stage_impl,
                           stage_wire=stage_wire, inplace=inplace)


def lower_allreduce(sched: Schedule, xs: Values, axes: Axes, *,
                    mesh: LogicalMesh,
                    stage_impl: Optional[str] = None,
                    stage_wire: Optional[str] = None,
                    options: Optional[CollectiveOptions] = None,
                    inplace: bool = False) -> Values:
    """Run an allreduce schedule as explicit rounds over ``mesh``.

    The schedule fixes algorithm and segmentation, so ``options=`` may
    only set the stage-tier knobs here.
    """
    stage_impl, stage_wire = CollectiveOptions.merge(
        options, stage_impl=stage_impl, stage_wire=stage_wire)
    if sched.name != "allreduce":
        raise ValueError(f"expected an allreduce schedule, got "
                         f"{sched.name!r}")
    _check_stage_opts(sched.algorithm, stage_impl, stage_wire)
    _check_values(mesh, xs)
    with mesh.region():
        if sched.algorithm == "hierarchical":
            return _hierarchical_allreduce(mesh, sched, xs, axes,
                                           stage_impl=stage_impl,
                                           inplace=inplace)
        axis = _single_axis(axes, f"allreduce[{sched.algorithm}]")
        _check_world(sched, mesh, axis)
        if sched.n == 1:
            flats, pad = _flats(mesh, xs, 1, inplace)
            return _unflat(flats, xs, pad)
        if sched.algorithm == "ring":
            return _ring_allreduce(mesh, xs, axis, sched.n, sched.segments,
                                   stage_impl=stage_impl, wire=stage_wire,
                                   inplace=inplace)
        if sched.algorithm == "doubling":
            if sched.n & (sched.n - 1):
                # fold/unfold needs rank-asymmetric control flow, which
                # the SPMD reference cannot express — the fused node is
                # the honest equivalent.
                return mesh.psum(xs, axis)
            flats, pad = _flats(mesh, xs, 1, inplace)
            flats = _butterfly_allreduce(mesh, flats, axis, sched.n,
                                         stage_impl=stage_impl)
            return _unflat(flats, xs, pad)
    raise ValueError(f"cannot lower algorithm {sched.algorithm!r}")


def _ring_allreduce(mesh: LogicalMesh, xs: Values, axis: str, n: int,
                    segments: int, stage_impl: Optional[str] = None,
                    wire: Optional[str] = None,
                    inplace: bool = False) -> Values:
    """Ring allreduce as ``2(n-1)·S`` explicit ppermute rounds.

    Mirrors the host schedule chunk for chunk: reduce-scatter rounds send
    chunk ``(r-1-k) % n`` and combine into ``(r-2-k) % n``; allgather
    rounds forward chunk ``(r-k) % n``.  With ``stage_impl`` each round's
    combine is one stage-tier call writing into the rank's buffer; with
    ``wire`` the transport travels in the narrow dtype — int8 rounds
    permute the quantised chunk plus its 0-d device scale, and the
    allgather leg quantises each reduced chunk once at its owner and
    decodes everywhere at the end.
    """
    ranks = range(mesh.size)
    idx = [mesh.axis_index(r, axis) for r in ranks]
    flats, pad = _flats(mesh, xs, n * segments, inplace)
    chunks = [f.view(n, segments, -1) for f in flats]
    fwd = [(i, (i + 1) % n) for i in range(n)]
    for k in range(n - 1):              # reduce-scatter leg
        for s in range(segments):
            sends = [chunks[r][(idx[r] - 1 - k) % n, s] for r in ranks]
            rows = [chunks[r][(idx[r] - 2 - k) % n, s] for r in ranks]
            if stage_impl is None:
                gots = mesh.ppermute(sends, axis, fwd)
                for r in ranks:
                    with mesh.on(r):
                        rows[r].add_(gots[r])
                del gots
                continue
            gscales: List[Optional[torch.Tensor]] = [None] * mesh.size
            if wire == "int8":
                scales = []
                for r in ranks:
                    with mesh.on(r):
                        q, scale = kernel_ops.quantize_stage(
                            sends[r], impl=stage_impl)
                    sends[r] = q
                    scales.append(scale)
                gscales = mesh.ppermute(scales, axis, fwd)
            elif wire == "bf16":
                for r in ranks:
                    with mesh.on(r):
                        sends[r] = sends[r].to(torch.bfloat16)
            gots = mesh.ppermute(sends, axis, fwd)
            for r in ranks:
                with mesh.on(r):
                    kernel_ops.combine_stage(rows[r], gots[r], gscales[r],
                                             impl=stage_impl, out=rows[r])
            del gots, gscales
    if wire is None:
        for k in range(n - 1):          # allgather leg
            for s in range(segments):
                gots = mesh.ppermute(
                    [chunks[r][(idx[r] - k) % n, s] for r in ranks], axis,
                    fwd)
                for r in ranks:
                    with mesh.on(r):
                        chunks[r][(idx[r] - k - 1) % n, s].copy_(gots[r])
                del gots
        return _unflat(flats, xs, pad)
    # Allgather leg in wire dtype: each rank owns reduced chunk ``idx``
    # after the RS leg — quantise it ONCE, forward the wire payload (+ the
    # int8 scale) around the ring, then decode every chunk (own included)
    # so all ranks decode identical wire bytes.
    wdt = _WIRE_DTYPES[wire]
    wchunks, scales = [], []
    for r in ranks:
        with mesh.on(r):
            wchunks.append(torch.empty(chunks[r].shape, dtype=wdt,
                                       device=chunks[r].device))
            scales.append(torch.zeros((n, segments), dtype=torch.float32,
                                      device=chunks[r].device))
            for s in range(segments):
                own = chunks[r][idx[r], s]
                if wire == "int8":
                    q, scale = kernel_ops.quantize_stage(own, impl=stage_impl)
                    wchunks[r][idx[r], s].copy_(q)
                    scales[r][idx[r], s].copy_(scale)
                else:
                    wchunks[r][idx[r], s].copy_(own)
    for k in range(n - 1):
        for s in range(segments):
            src = [(idx[r] - k) % n for r in ranks]
            gots = mesh.ppermute([wchunks[r][src[r], s] for r in ranks],
                                 axis, fwd)
            gscales = (mesh.ppermute([scales[r][src[r], s] for r in ranks],
                                     axis, fwd)
                       if wire == "int8" else None)
            for r in ranks:
                tgt = (idx[r] - k - 1) % n
                with mesh.on(r):
                    wchunks[r][tgt, s].copy_(gots[r])
                    if gscales is not None:
                        scales[r][tgt, s].copy_(gscales[r])
            del gots, gscales
    for r in ranks:
        with mesh.on(r):
            for i in range(n):
                for s in range(segments):
                    row = chunks[r][i, s]
                    if wire == "int8":
                        kernel_ops.dequantize_stage(
                            wchunks[r][i, s], scales[r][i, s], row.dtype,
                            impl=stage_impl, out=row)
                    else:
                        kernel_ops.combine_stage(
                            row, wchunks[r][i, s], None, accumulate=False,
                            impl=stage_impl, out=row)
    return _unflat(flats, xs, pad)


def _hierarchical_allreduce(mesh: LogicalMesh, sched: Schedule, xs: Values,
                            axes: Axes, stage_impl: Optional[str] = None,
                            inplace: bool = False) -> Values:
    """Run a :func:`repro_torch.core.schedule.build_hierarchical` schedule
    over two mesh axes, ``(inter, intra)`` in the schedule's major→minor
    order: ``intra-1`` reduce-scatter rounds along the intra axis (send
    chunk ``(l-1-k) % n_i``, combine into ``(l-2-k) % n_i``), the inter
    allreduce of the owned chunk (butterfly rounds for a power-of-two pod
    count, else one ``psum``), and ``intra-1`` allgather rounds back."""
    inter_axis, intra_axis = _two_axes(axes)
    sizes = dict(sched.axes)
    n_e, n_i = sizes["inter"], sizes["intra"]
    if (mesh.axis_size(inter_axis) != n_e
            or mesh.axis_size(intra_axis) != n_i):
        raise ValueError(
            f"schedule is for an (inter={n_e}) × (intra={n_i}) grid but "
            f"axes ({inter_axis!r}, {intra_axis!r}) have sizes "
            f"({mesh.axis_size(inter_axis)}, {mesh.axis_size(intra_axis)})")
    ranks = range(mesh.size)
    flats, pad = _flats(mesh, xs, n_i, inplace)
    if n_e * n_i == 1:
        return _unflat(flats, xs, pad)
    chunks = [f.view(n_i, -1) for f in flats]
    li = [mesh.axis_index(r, intra_axis) for r in ranks]
    fwd = [(i, (i + 1) % n_i) for i in range(n_i)]
    for k in range(n_i - 1):            # stage 1: intra reduce-scatter
        gots = mesh.ppermute([chunks[r][(li[r] - 1 - k) % n_i]
                              for r in ranks], intra_axis, fwd)
        for r in ranks:
            row = chunks[r][(li[r] - 2 - k) % n_i]
            with mesh.on(r):
                if stage_impl is None:
                    row.add_(gots[r])
                else:
                    kernel_ops.combine_stage(row, gots[r], impl=stage_impl,
                                             out=row)
        del gots
    own = [chunks[r][li[r]] for r in ranks]
    if n_e > 1:                         # stage 2: inter allreduce
        if n_e & (n_e - 1):
            summed = mesh.psum(own, inter_axis)
            for r in ranks:
                with mesh.on(r):
                    own[r].copy_(summed[r])
        else:                           # in place on the owned rows
            _butterfly_allreduce(mesh, own, inter_axis, n_e,
                                 stage_impl=stage_impl)
    for k in range(n_i - 1):            # stage 3: intra allgather
        gots = mesh.ppermute([chunks[r][(li[r] - k) % n_i] for r in ranks],
                             intra_axis, fwd)
        for r in ranks:
            with mesh.on(r):
                chunks[r][(li[r] - k - 1) % n_i].copy_(gots[r])
        del gots
    return _unflat(flats, xs, pad)


def _butterfly_allreduce(mesh: LogicalMesh, xs: Values, axis: str, n: int,
                         stage_impl: Optional[str] = None) -> Values:
    """Recursive doubling as ``log2 n`` bidirectional ppermute rounds
    (power-of-two rank counts), accumulating into ``xs`` in place."""
    mask = 1
    while mask < n:
        perm = [(i, i ^ mask) for i in range(n)]
        gots = mesh.ppermute(xs, axis, perm)
        for r in range(mesh.size):
            with mesh.on(r):
                if stage_impl is None:
                    xs[r].add_(gots[r])
                else:
                    kernel_ops.combine_stage(xs[r], gots[r], impl=stage_impl,
                                             out=xs[r])
        del gots
        mask <<= 1
    return xs


# ---------------------------------------------------------------------------
# Neighbourhood lowering
# ---------------------------------------------------------------------------
def lower_neighbor(sched: Schedule, sends: Dict[Any, Values],
                   axis_name: str, *, mesh: LogicalMesh
                   ) -> Dict[Any, Values]:
    """Lower a neighbourhood schedule to one ppermute per direction.

    ``sends[d]`` holds every rank's outgoing payload toward direction
    ``d`` (one tensor per rank — SPMD); the result maps each direction to
    the payloads received *from* the neighbour in that direction.  The
    permutation pairs are read off the schedule's transfers, so
    non-periodic boundary ranks — which have no pair — receive
    ``ppermute``'s zeros.
    """
    if sched.output_kind != "dirs":
        raise ValueError("lower_neighbor needs a neighbourhood schedule "
                         "(build_neighbor)")
    _check_world(sched, mesh, axis_name)
    by_dir: Dict[Any, list] = {}
    for t in sched.transfers():
        _, d = t.src_buf            # ("s", direction)
        by_dir.setdefault(d, []).append((t.src, t.dst))
    out: Dict[Any, Values] = {}
    with mesh.region():
        for d, payloads in sends.items():
            pairs = sorted(by_dir.get(d, []))
            opp = (d[0], -d[1])
            if not pairs:           # degenerate grid: no such edge at all
                zeros = []
                for r, p in enumerate(payloads):
                    with mesh.on(r):
                        zeros.append(torch.zeros_like(p))
                out[opp] = zeros
                continue
            out[opp] = mesh.ppermute(payloads, axis_name, pairs)
    return out


def chain_topology(n: int) -> Tuple[Tuple[Tuple[Tuple[int, int], int],
                                          ...], ...]:
    """1-D non-periodic chain topology (row decomposition), the shape
    :meth:`repro_torch.core.tac.CartGroup.topology` produces for
    ``cart_create((n,))``."""
    topo = []
    for r in range(n):
        dirs = []
        if r > 0:
            dirs.append(((0, -1), r - 1))
        if r < n - 1:
            dirs.append(((0, 1), r + 1))
        topo.append(tuple(dirs))
    return tuple(topo)
