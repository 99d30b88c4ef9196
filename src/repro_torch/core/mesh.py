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
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

Axes = Union[str, Sequence[str]]

__all__ = ["LogicalMesh", "resolve_device", "Token"]


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
    ``ppermute_calls[r]`` counts the ``ppermute`` calls rank ``r`` took
    part in (every rank executes every call, as in SPMD, whether or not it
    has a pair); ``psum_calls[r]`` counts the ``psum`` calls it took part
    in; ``token_waits[r]`` counts the sentinel waits on its stream
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
        self.ppermute_calls = [0] * self.size
        self.psum_calls = [0] * self.size
        self.token_waits = [0] * self.size
        self._depth = threading.local()

    def __repr__(self) -> str:
        return (f"LogicalMesh({tuple(self.shape.values())}, "
                f"{self.axis_names}, device={str(self.device)!r})")

    def reset_counts(self) -> None:
        self.ppermute_calls = [0] * self.size
        self.psum_calls = [0] * self.size
        self.token_waits = [0] * self.size

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
    def on(self, rank: int):
        """Issue work as rank ``rank``: its stream is the current one."""
        if self.streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[rank])

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

    def _transfer(self, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """A copy of rank ``src``'s ``x`` made on rank ``dst``'s stream."""
        if self.streams is None:
            return x.clone()
        s_src, s_dst = self.streams[src], self.streams[dst]
        if src != dst:
            s_dst.wait_event(s_src.record_event())
        with torch.cuda.stream(s_dst):
            y = torch.empty_like(x, memory_format=torch.contiguous_format)
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
        for g in self.groups(axis):
            for i, j in perm:
                out[g[j]] = self._transfer(xs[g[i]], g[i], g[j])
        for r in range(self.size):
            self.ppermute_calls[r] += 1
            if out[r] is None:
                with self.on(r):
                    out[r] = torch.zeros_like(xs[r])
        return out

    def psum(self, xs: Sequence[torch.Tensor], axis: Axes
             ) -> List[torch.Tensor]:
        """``lax.psum`` over ``axis``: each group's values summed in axis
        order on the group's first rank, then copied to every member."""
        self._check_values(xs, "psum")
        out: List[Optional[torch.Tensor]] = [None] * self.size
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
        for r in range(self.size):
            self.psum_calls[r] += 1
        return out

    def all_gather(self, xs: Sequence[torch.Tensor], axis: Axes
                   ) -> List[torch.Tensor]:
        """``lax.all_gather``: every rank gets its group's values stacked
        along a new leading dimension, in axis order."""
        self._check_values(xs, "all_gather")
        out: List[Optional[torch.Tensor]] = [None] * self.size
        for g in self.groups(axis):
            for r in g:
                parts = [self._transfer(xs[q], q, r) for q in g]
                with self.on(r):
                    out[r] = torch.stack(parts)
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
        for g in self.groups(axis):
            for i, r in enumerate(g):
                parts = [self._transfer(xs[q][i], q, r) for q in g]
                with self.on(r):
                    out[r] = torch.stack(parts)
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
