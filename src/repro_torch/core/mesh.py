"""Logical-rank mesh on one device — :class:`LogicalMesh` is the port's
counterpart of ``repro/launch/mesh.make_mesh`` plus what ``shard_map``
gives the Level-B lowerings of ``repro.core.lowering``.

The JAX package runs its in-graph collectives as SPMD programs over a
device mesh: each shard executes the same body, asks
``lax.axis_index(axis)`` who it is, and moves data with ``lax.ppermute``,
``psum``, ``all_gather`` and ``all_to_all``.  Here the shards are logical
ranks held by one process on one device.  A per-rank value is a list with
one tensor per rank, in rank order (row-major over the mesh axes, the
first axis major), and the SPMD body becomes a loop over ranks in which
rank ``r``'s work is issued on rank ``r``'s own CUDA stream
(:meth:`LogicalMesh.on`).

Data crosses ranks only through :meth:`LogicalMesh.ppermute` and the
collectives built on it.  Each transfer is one peer copy made on the
receiver's stream after an event wait on the sender's, the source tensor
is ``record_stream``-ed onto the receiver's stream (so the caching
allocator cannot hand its memory out while the copy still reads it), and
the sender's stream waits for the copy before its next operation (so an
in-place update by the sender cannot race the copy: a send completes
before its buffer is reused).  On the CPU there are no streams and every
transfer is a plain copy.

:meth:`LogicalMesh.region` brackets an SPMD call: the rank streams wait
for the caller's stream on entry, and the caller's stream waits for all
of them on exit, so inputs made before the call and results read after it
need no further synchronisation.

:func:`ad_all_gather`, :func:`ad_reduce_scatter` and :func:`ad_psum` are
the collectives as autograd functions, each one node over every rank's
value; their backward passes are the adjoint collectives (``all_gather``
and ``reduce_scatter`` are each other's, ``psum``'s is ``psum``).
Autograd runs a node's backward on the stream that was current when its
forward ran, after that stream has waited for every incoming gradient: the
backward therefore makes the rank streams wait for it before its
collective and makes it wait for them after (:meth:`LogicalMesh.fork`,
:meth:`LogicalMesh.join`), so the gradients it returns are ready on it.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

Axes = Union[str, Sequence[str]]

__all__ = ["LogicalMesh", "resolve_device", "Token", "ad_all_gather",
           "ad_reduce_scatter", "ad_psum", "COLLECTIVES", "current_rank",
           "current_collective", "nbytes"]

COLLECTIVES = ("ppermute", "psum", "all_gather", "reduce_scatter",
               "all_to_all")

# the rank whose work is being issued, and the collective running
_state = threading.local()


def current_rank() -> Optional[int]:
    """The rank whose work the calling thread issues now (inside
    :meth:`LogicalMesh.on` or a transfer), else None."""
    return getattr(_state, "rank", None)


def current_collective() -> Optional[str]:
    """The outermost collective the calling thread runs now, else None."""
    return getattr(_state, "coll", None)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _On:
    """:meth:`LogicalMesh.on`: rank ``rank`` is :func:`current_rank` and,
    on CUDA, its stream the current stream."""

    __slots__ = ("rank", "stream", "prev")

    def __init__(self, rank: int, stream) -> None:
        self.rank, self.stream = rank, stream

    def __enter__(self) -> None:
        self.prev = getattr(_state, "rank", None)
        _state.rank = self.rank
        if self.stream is not None:
            self.stream.__enter__()

    def __exit__(self, *exc) -> None:
        if self.stream is not None:
            self.stream.__exit__(*exc)
        _state.rank = self.prev


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA device when none is named; without CUDA a
    call that names no device raises instead of running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        device = "cuda"
    return torch.device(device)


class Token:
    """A point in every rank's stream (one CUDA event per rank; nothing on
    the CPU), the port's form of the sentinel token of
    ``repro.core.overlap.chained``."""

    __slots__ = ("events",)

    def __init__(self, events: List[Optional[torch.cuda.Event]]) -> None:
        self.events = events


class LogicalMesh:
    """``shape`` logical ranks named by ``axis_names`` on one ``device``.

    ``shape`` maps each axis to its size, in order, like a jax mesh's.
    ``coll_calls[kind][r]`` (see the module's note) counts the calls of
    collective ``kind`` that rank ``r`` took part in (every rank executes
    every call, as in SPMD, whether or not it has a pair);
    ``token_waits[r]`` counts the sentinel waits on its stream
    (:meth:`wait_token`).
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None) -> None:
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} differ in length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh axis sizes must be positive, got {shape}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.device = resolve_device(device)
        self.streams: Optional[List[torch.cuda.Stream]] = (
            [torch.cuda.Stream(self.device) for _ in range(self.size)]
            if self.device.type == "cuda" else None)
        self.reset_counts()
        self._depth = threading.local()

    def __repr__(self) -> str:
        return (f"LogicalMesh({tuple(self.shape.values())}, "
                f"{self.axis_names}, device={str(self.device)!r})")

    def reset_counts(self) -> None:
        self.coll_calls: Dict[str, List[int]] = {
            k: [0] * self.size for k in COLLECTIVES}
        self.coll_bytes: Dict[str, List[int]] = {
            k: [0] * self.size for k in COLLECTIVES}
        self.coll_group_bytes: Dict[Tuple[str, int], List[int]] = {}
        self.coll_tag_bytes: Dict[Tuple[str, str], List[int]] = {}
        self.token_waits = [0] * self.size

    def count(self, kind: str, rank: int, operand_bytes: int, group: int,
              tag: Optional[str] = None) -> None:
        """One call of collective ``kind`` on ``rank``: its operand bytes
        and the size of the group it ran over; with ``tag`` (``"fsdp"``
        for the sharded model's weight gathers and their gradients) its
        bytes are also summed in ``coll_tag_bytes[(kind, tag)]``."""
        self.coll_calls[kind][rank] += 1
        self.coll_bytes[kind][rank] += operand_bytes
        for table, key in ((self.coll_group_bytes, (kind, group)),
                           (self.coll_tag_bytes, (kind, tag))):
            if key[1] is None:
                continue
            per = table.get(key)
            if per is None:
                per = table[key] = [0] * self.size
            per[rank] += operand_bytes

    @contextlib.contextmanager
    def collective(self, kind: str) -> Iterator[bool]:
        """Run collective ``kind``: yields whether the call is outermost
        (the one to count); inside, :func:`current_collective` names the
        outermost collective."""
        prev = getattr(_state, "coll", None)
        _state.coll = prev or kind
        try:
            yield prev is None
        finally:
            _state.coll = prev

    def _count_all(self, kind: str, xs: Sequence[torch.Tensor],
                   axis: Axes) -> None:
        g = self.axis_size(axis)
        for r, x in enumerate(xs):
            self.count(kind, r, nbytes(x), g)

    # -- axes ----------------------------------------------------------------
    def _axes(self, axis: Axes) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"unknown mesh axis {a!r}; axes are "
                                 f"{self.axis_names}")
        return axes

    def axis_size(self, axis: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axis))

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index along every axis (row-major)."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} out of range for {self.size}")
        out: Dict[str, int] = {}
        for a in reversed(self.axis_names):
            rank, out[a] = divmod(rank, self.shape[a])
        return out

    def axis_index(self, rank: int, axis: Axes) -> int:
        """``lax.axis_index(axis)`` on rank ``rank``; over an axis tuple,
        the combined index with the first axis major."""
        c = self.coords(rank)
        idx = 0
        for a in self._axes(axis):
            idx = idx * self.shape[a] + c[a]
        return idx

    def groups(self, axis: Axes) -> List[List[int]]:
        """The ranks that share every coordinate off ``axis``, one list per
        group, each ordered by :meth:`axis_index` along ``axis``."""
        axes = self._axes(axis)
        by_rest: Dict[Tuple[int, ...], List[Tuple[int, int]]] = {}
        for r in range(self.size):
            c = self.coords(r)
            rest = tuple(c[a] for a in self.axis_names if a not in axes)
            by_rest.setdefault(rest, []).append((self.axis_index(r, axes), r))
        return [[r for _, r in sorted(g)] for g in by_rest.values()]

    # -- streams -------------------------------------------------------------
    def on(self, rank: int) -> _On:
        """Issue work as rank ``rank``: its stream is the current one, and
        it is :func:`current_rank`."""
        return _On(rank, None if self.streams is None
                   else torch.cuda.stream(self.streams[rank]))

    def fork(self) -> None:
        """Every rank's stream waits for the caller's (current) stream."""
        if self.streams is not None:
            caller = torch.cuda.current_stream(self.device)
            for s in self.streams:
                s.wait_stream(caller)

    def join(self) -> None:
        """The caller's (current) stream waits for every rank's stream."""
        if self.streams is not None:
            caller = torch.cuda.current_stream(self.device)
            for s in self.streams:
                caller.wait_stream(s)

    @contextlib.contextmanager
    def region(self) -> Iterator["LogicalMesh"]:
        """An SPMD call: rank streams start after the caller's stream and
        the caller's stream resumes after all of them.  Re-entrant."""
        depth = getattr(self._depth, "n", 0)
        outer = depth == 0 and self.streams is not None
        if outer:
            caller = torch.cuda.current_stream(self.device)
            for s in self.streams:
                s.wait_stream(caller)
        self._depth.n = depth + 1
        try:
            yield self
        finally:
            self._depth.n = depth
            if outer:
                for s in self.streams:
                    caller.wait_stream(s)

    def _transfer(self, x: torch.Tensor, src: int, dst: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A copy of rank ``src``'s ``x`` made on rank ``dst``'s stream (as
        rank ``dst``'s work), into ``out`` (a tensor or view of rank
        ``dst``'s) when given."""
        if self.streams is None:
            with _On(dst, None):
                return x.clone() if out is None else out.copy_(x)
        s_src, s_dst = self.streams[src], self.streams[dst]
        if src != dst:
            s_dst.wait_event(s_src.record_event())
        with self.on(dst):
            y = torch.empty_like(x, memory_format=torch.contiguous_format) \
                if out is None else out
            y.copy_(x)
        if src != dst:
            x.record_stream(s_dst)
            s_src.wait_event(s_dst.record_event())
        return y

    # -- collectives over an axis -------------------------------------------
    def _check_values(self, xs: Sequence[torch.Tensor], what: str) -> None:
        if len(xs) != self.size:
            raise ValueError(f"{what}: need one value per rank "
                             f"({self.size}), got {len(xs)}")

    def ppermute(self, xs: Sequence[torch.Tensor], axis: Axes,
                 perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """``lax.ppermute``: within every group along ``axis``, the rank at
        axis index ``i`` sends to the one at ``j`` for each ``(i, j)`` in
        ``perm``; a rank with no incoming pair receives zeros."""
        self._check_values(xs, "ppermute")
        n = self.axis_size(axis)
        srcs = [i for i, _ in perm]
        dsts = [j for _, j in perm]
        if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
                or not all(0 <= k < n for k in srcs + dsts)):
            raise ValueError(f"ppermute: {list(perm)} is not a partial "
                             f"permutation of {n} axis indices")
        out: List[Optional[torch.Tensor]] = [None] * self.size
        with self.collective("ppermute") as outer:
            for g in self.groups(axis):
                for i, j in perm:
                    out[g[j]] = self._transfer(xs[g[i]], g[i], g[j])
            for r in range(self.size):
                if out[r] is None:
                    with self.on(r):
                        out[r] = torch.zeros_like(xs[r])
        if outer:
            self._count_all("ppermute", xs, axis)
        return out

    def psum(self, xs: Sequence[torch.Tensor], axis: Axes
             ) -> List[torch.Tensor]:
        """``lax.psum`` over ``axis``: each group's values summed in axis
        order on the group's first rank, then copied to every member."""
        self._check_values(xs, "psum")
        out: List[Optional[torch.Tensor]] = [None] * self.size
        with self.collective("psum") as outer:
            for g in self.groups(axis):
                root = g[0]
                with self.on(root):
                    total = xs[root].clone()
                for q in g[1:]:
                    got = self._transfer(xs[q], q, root)
                    with self.on(root):
                        total.add_(got)
                out[root] = total
                for q in g[1:]:
                    out[q] = self._transfer(total, root, q)
        if outer:
            self._count_all("psum", xs, axis)
        return out

    def all_gather(self, xs: Sequence[torch.Tensor], axis: Axes,
                   dim: int = 0, tiled: bool = False) -> List[torch.Tensor]:
        """``lax.all_gather(x, axis, axis=dim, tiled=tiled)``: every rank
        gets its group's values in axis order, stacked along a new
        dimension ``dim``, or with ``tiled`` concatenated along ``dim``
        (each value copied once, into its place)."""
        self._check_values(xs, "all_gather")
        out: List[Optional[torch.Tensor]] = [None] * self.size
        with self.collective("all_gather") as outer:
            for g in self.groups(axis):
                for r in g:
                    x = xs[r]
                    shape = list(x.shape)
                    if tiled:
                        shape[dim] *= len(g)
                    else:
                        shape.insert(dim, len(g))
                    with self.on(r):
                        y = torch.empty(shape, dtype=x.dtype,
                                        device=x.device)
                    for i, q in enumerate(g):
                        part = y.narrow(dim, i * x.shape[dim],
                                        x.shape[dim]) \
                            if tiled else y.select(dim, i)
                        self._transfer(xs[q], q, r, out=part)
                    out[r] = y
        if outer:
            self._count_all("all_gather", xs, axis)
        return out

    def reduce_scatter(self, xs: Sequence[torch.Tensor], axis: Axes,
                       dim: int = 0) -> List[torch.Tensor]:
        """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
        ``dim`` is cut into one block per group member, and the member at
        axis index ``i`` gets the sum of block ``i`` of every member's
        value, summed in axis order on the member itself, as
        :meth:`psum` sums."""
        self._check_values(xs, "reduce_scatter")
        n = self.axis_size(axis)
        for x in xs:
            if x.dim() <= dim or x.shape[dim] % n:
                raise ValueError(f"reduce_scatter: dimension {dim} of "
                                 f"{tuple(x.shape)} does not split over "
                                 f"{n} ranks")
        out: List[Optional[torch.Tensor]] = [None] * self.size
        with self.collective("reduce_scatter") as outer:
            for g in self.groups(axis):
                for i, r in enumerate(g):
                    k = xs[r].shape[dim] // n
                    total = None
                    for q in g:
                        got = self._transfer(xs[q].narrow(dim, i * k, k),
                                             q, r)
                        with self.on(r):
                            total = got if total is None else total.add_(got)
                    out[r] = total
        if outer:
            self._count_all("reduce_scatter", xs, axis)
        return out

    def all_to_all(self, xs: Sequence[torch.Tensor], axis: Axes
                   ) -> List[torch.Tensor]:
        """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
        tiled=False)``: each rank's value has a leading dimension of the
        axis size; rank at index ``i`` receives ``stack_j(x_j[i])``."""
        self._check_values(xs, "all_to_all")
        n = self.axis_size(axis)
        for x in xs:
            if x.dim() == 0 or x.shape[0] != n:
                raise ValueError(f"all_to_all: leading dimension must be "
                                 f"the axis size {n}, got {tuple(x.shape)}")
        out: List[Optional[torch.Tensor]] = [None] * self.size
        with self.collective("all_to_all") as outer:
            for g in self.groups(axis):
                for i, r in enumerate(g):
                    parts = [self._transfer(xs[q][i], q, r) for q in g]
                    with self.on(r):
                        out[r] = torch.stack(parts)
        if outer:
            self._count_all("all_to_all", xs, axis)
        return out

    # -- the sentinel's artificial dependency --------------------------------
    def token(self) -> Token:
        """A token recorded now on every rank's stream."""
        if self.streams is None:
            return Token([None] * self.size)
        return Token([s.record_event() for s in self.streams])

    def wait_token(self, token: Token) -> None:
        """Every rank's stream waits for the token's point on EVERY rank's
        stream: nothing issued after this on any rank starts before all
        ranks reached the token."""
        for r in range(self.size):
            self.token_waits[r] += 1
            if self.streams is not None:
                for ev in token.events:
                    self.streams[r].wait_event(ev)


# ---------------------------------------------------------------------------
# differentiable collectives (one autograd node over every rank's value)
# ---------------------------------------------------------------------------
def _zeros_for(mesh: LogicalMesh, grads, like) -> List[torch.Tensor]:
    """Each rank's gradient, zeros where autograd gave none."""
    out = []
    for r, (g, (shape, dtype)) in enumerate(zip(grads, like)):
        if g is None:
            with mesh.on(r):
                g = torch.zeros(shape, dtype=dtype, device=mesh.device)
        out.append(g)
    return out


def _shapes(xs) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    return [(tuple(x.shape), x.dtype) for x in xs]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, *xs):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ys = mesh.all_gather(list(xs), axis, dim=dim, tiled=True)
        ctx.like = _shapes(ys)
        return tuple(ys)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        mesh = ctx.mesh
        mesh.fork()
        out = mesh.reduce_scatter(_zeros_for(mesh, gs, ctx.like), ctx.axis,
                                  ctx.dim)
        mesh.join()
        return (None, None, None) + tuple(out)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dim, *xs):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ys = mesh.reduce_scatter(list(xs), axis, dim=dim)
        ctx.like = _shapes(ys)
        return tuple(ys)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        mesh = ctx.mesh
        mesh.fork()
        out = mesh.all_gather(_zeros_for(mesh, gs, ctx.like), ctx.axis,
                              dim=ctx.dim, tiled=True)
        mesh.join()
        return (None, None, None) + tuple(out)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        ys = mesh.psum(list(xs), axis)
        ctx.like = _shapes(ys)
        return tuple(ys)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        mesh = ctx.mesh
        mesh.fork()
        out = mesh.psum(_zeros_for(mesh, gs, ctx.like), ctx.axis)
        mesh.join()
        return (None, None) + tuple(out)


def ad_all_gather(mesh: LogicalMesh, xs: Sequence[torch.Tensor], axis: Axes,
                  dim: int = 0) -> List[torch.Tensor]:
    """Tiled :meth:`LogicalMesh.all_gather` along ``dim`` that autograd
    differentiates: the backward reduce-scatters the gradients along
    ``dim`` (each rank's block summed over the group)."""
    return list(_AllGather.apply(mesh, axis, dim, *xs))


def ad_reduce_scatter(mesh: LogicalMesh, xs: Sequence[torch.Tensor],
                      axis: Axes, dim: int = 0) -> List[torch.Tensor]:
    """:meth:`LogicalMesh.reduce_scatter` that autograd differentiates:
    the backward all-gathers the gradients along ``dim``."""
    return list(_ReduceScatter.apply(mesh, axis, dim, *xs))


def ad_psum(mesh: LogicalMesh, xs: Sequence[torch.Tensor], axis: Axes
            ) -> List[torch.Tensor]:
    """:meth:`LogicalMesh.psum` that autograd differentiates.  Its
    backward is its adjoint, a ``psum`` of the gradients: the port's
    sharded steps count every loss term on one rank only, so a value
    replicated by a ``psum`` is differentiated once per copy and the
    copies' gradients add up.  (Megatron counts the loss on every model
    rank instead and makes this backward the identity.)"""
    return list(_Psum.apply(mesh, axis, *xs))
