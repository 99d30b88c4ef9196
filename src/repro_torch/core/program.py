"""Compiled schedule programs — persistent plans for the Level-A executor.

The reference Level-A executor (:func:`repro_torch.core.collectives._interpret`)
re-walks the schedule IR on every call: per op it re-tests the op's type,
re-derives the wire tag through a fresh ``tag()`` closure, re-translates
communicator-local ranks through ``CommGroup``'s indirection, and re-decides
what to wait on by probing a ``pending`` dict.  That per-operation setup
cost is what the calibrated per-call ``overhead`` constant in
BENCH_baseline.json measures, and it is exactly the cost persistent
operations exist to amortise (``MPI_Allreduce_init``-style plans, cf.
*Designing and Prototyping Extensions to MPI in MPICH*; *MPI Progress For
All*).

This module compiles each (schedule, communicator, op, tag-family) triple
ONCE into a :class:`CompiledProgram` — a flat per-rank list of
``(waits, action)`` steps where

* the wait set is **precomputed** from the schedule's static wait plan
  (:meth:`repro_torch.core.schedule.Schedule.wait_plan`): which receives an op
  consumes is a property of the IR, not of the run;
* ``Send``/``Recv`` actions are **pre-bound closures** posting straight to
  the underlying world transport: peer ranks are pre-translated via
  :meth:`repro_torch.core.tac.CommGroup.translate_many` and each step carries a
  pre-built tag template — at call time only the per-call ``key`` (the tag
  epoch) is inserted, so group indirection and tag assembly vanish from
  the steady state;
* compute actions (``Combine``/``Pack``/``Slice``/...) are closures with
  the combine function pre-resolved — no isinstance dispatch.

Programs are cached immutably (:func:`compile_schedule`), keyed by the
*identities* of the schedule and communicator plus the op and tag family.
Identity keying is deliberate: schedules are lru-cached by their builders
(``schedule.build``/``build_neighbor``/``build_hierarchical``), so equal
requests share one object, and hashing a frozen ``Schedule`` would
recursively hash thousands of ops per call — costing more than the
interpretation it replaces.  The cache holds strong references to the
schedule and communicator, so a cached id can never be recycled by the
garbage collector while its entry lives; eviction (FIFO beyond
``CACHE_MAX``) drops the whole entry.

Execution (:meth:`CompiledProgram.gen`) still produces a generator with
the interpreter's exact driving contract — yields a handle (or list) when
a wait is genuinely outstanding, accepts the payload(s) via ``send()``,
returns the rank result through ``StopIteration`` — so all three drivers
(inline waits, blocking-mode progress engine, event-bound progress engine)
and the group driver run compiled and interpreted ranks interchangeably.
The wire protocol (tags, posting order) is identical op-for-op, so a
compiled rank interoperates with an interpreted peer on the same
communicator.  One deliberate fast path: a wait whose handle already
completed (eager matching) is consumed **without suspending**, skipping
the generator round-trip the interpreter pays.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import trace as _trc
from . import tac
from .schedule import (Combine, Concat, Const, Copy, Pack, Recv, Schedule,
                       Send, Slice, Unpack)

__all__ = ["CompiledProgram", "compile_schedule", "cache_stats",
           "clear_cache", "CACHE_MAX", "bind_inputs", "NamedOp",
           "as_payload"]

# ---------------------------------------------------------------------------
# Payloads.  A ``torch.Tensor`` payload stays a tensor on its own device
# through every op of a schedule (split, concatenate, combine); anything
# else is a numpy array and takes the numpy path unchanged.
# ---------------------------------------------------------------------------
class NamedOp:
    """A named reduction: the numpy ufunc on arrays, the torch op of the
    same name on tensors (computed on the tensor's device).  Both accept
    ``out=``, which is what the arena combine writes through."""

    __slots__ = ("name", "ufunc", "torch_fn")

    def __init__(self, name: str, ufunc: np.ufunc, torch_fn) -> None:
        self.name = name
        self.ufunc = ufunc
        self.torch_fn = torch_fn

    def __call__(self, a, b, out=None):
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            if not isinstance(a, torch.Tensor):
                a = torch.as_tensor(a, device=b.device)
            elif not isinstance(b, torch.Tensor):
                b = torch.as_tensor(b, device=a.device)
            if out is None:
                return self.torch_fn(a, b)
            return self.torch_fn(a, b, out=out)
        if out is None:
            return self.ufunc(a, b)
        return self.ufunc(a, b, out=out)

    def __repr__(self) -> str:
        return f"NamedOp({self.name!r})"


def as_payload(value):
    """A tensor as it is (never through numpy); anything else as an array."""
    return value if isinstance(value, torch.Tensor) else np.asarray(value)


def split_flat(value, parts: int):
    """``np.array_split`` of the flattened payload (``tensor_split`` for a
    tensor: the same chunk sizes, views on the same device)."""
    if isinstance(value, torch.Tensor):
        return list(torch.tensor_split(value.reshape(-1), parts))
    return np.array_split(np.asarray(value).reshape(-1), parts)


def concat_flat(values):
    """The flattened payloads end to end (``torch.cat`` for tensors)."""
    if any(isinstance(v, torch.Tensor) for v in values):
        return torch.cat([v.reshape(-1) for v in values])
    return np.concatenate([np.asarray(v).reshape(-1) for v in values])


def shape_of(value):
    return (tuple(value.shape) if isinstance(value, torch.Tensor)
            else np.asarray(value).shape)


# Reserved env key under which a caller-owned buffer arena rides along a
# run.  An arena maps combine-output buffer names to pre-allocated numpy
# arrays (or tensors) that named-op combines write into with ``out=`` instead of
# allocating a fresh result per round — the zero-copy half of a
# persistent plan (MPI_Allreduce_init's pre-registered buffers).  The
# arena is only sound when the holder serialises iterations: a run must
# complete (every receive consumed by the peers) before the next one is
# posted, because the in-process transport passes arrays by reference
# and the next iteration overwrites them in place.  That is exactly the
# MPI persistent-request contract (wait before re-start), and it is what
# :class:`repro_torch.core.collectives.PersistentCollective` guarantees.
_ARENA = "__arena__"


def bind_inputs(sched: Schedule, value, blocks, sends):
    """Initial buffer environment for one rank; returns (env, shape).

    Shared input binding of both Level-A executors (the interpreter
    imports it as ``_bind_inputs``); see
    :class:`repro_torch.core.schedule.Schedule` for the input kinds.
    """
    env: Dict[Any, Any] = {}
    shape = None
    kind = sched.input_kind
    if kind == "value":
        env["in"] = value
    elif kind == "array":
        env["in"] = as_payload(value)
    elif kind == "chunks":
        arr = as_payload(value)
        shape = shape_of(arr)
        outer = split_flat(arr, sched.n_chunks or sched.n)
        if sched.segments == 1:
            for i, c in enumerate(outer):
                env[("c", i)] = c
        else:
            for i, c in enumerate(outer):
                segs = split_flat(c, sched.segments)
                for s, seg in enumerate(segs):
                    env[("c", i, s)] = seg
    elif kind == "blocks":
        for d in range(sched.n):
            env[("b", d)] = blocks[d]
    elif kind == "dirs":
        for d, v in sends.items():
            env[("s", d)] = v
    elif kind != "none":            # pragma: no cover - new input kinds
        raise ValueError(f"unknown input kind {kind!r}")
    return env, shape


# ---------------------------------------------------------------------------
# Step compilation.  Each op becomes action(env, pending, key): Sends post
# through the pre-bound transport, Recvs deposit their handle in
# ``pending``, compute ops write ``env``.  The per-call ``key`` (tag epoch)
# is the only value not baked in.
# ---------------------------------------------------------------------------
def _compile_op(o, rank: int, isend, irecv, wranks, mktag, op):
    if isinstance(o, Send):
        src, dst, tag = wranks[rank], wranks[o.peer], mktag(o.tag)
        buf = o.buf

        def action(env, pending, key):
            isend(env[buf], src=src, dst=dst, tag=tag(key))
    elif isinstance(o, Recv):
        src, dst, tag = wranks[o.peer], wranks[rank], mktag(o.tag)
        buf = o.buf

        def action(env, pending, key):
            pending[buf] = irecv(src=src, dst=dst, tag=tag(key))
    elif isinstance(o, Combine):
        if op is None:
            raise ValueError(
                f"schedule combines ({o!r}) but no op was compiled in")
        out, a, b = o.out, o.a, o.b
        if isinstance(op, NamedOp):
            # Named reductions accept ``out=`` — under an arena the
            # combine writes into a persistent per-output buffer instead
            # of allocating: a numpy array for arrays, a tensor on the
            # operands' device for tensors.
            def action(env, pending, key):
                va, vb = env[a], env[b]
                arena = env.get(_ARENA)
                if arena is None:
                    env[out] = op(va, vb)
                elif (isinstance(va, np.ndarray)
                        and isinstance(vb, np.ndarray)
                        and va.shape == vb.shape):
                    buf = arena.get(out)
                    rt = np.result_type(va, vb)
                    if (not isinstance(buf, np.ndarray)
                            or buf.shape != va.shape or buf.dtype != rt):
                        buf = np.empty(va.shape, rt)
                        arena[out] = buf
                    env[out] = op(va, vb, out=buf)
                elif (isinstance(va, torch.Tensor)
                        and isinstance(vb, torch.Tensor)
                        and va.shape == vb.shape
                        and va.device == vb.device):
                    buf = arena.get(out)
                    rt = torch.result_type(va, vb)
                    if (not isinstance(buf, torch.Tensor)
                            or buf.shape != va.shape or buf.dtype != rt
                            or buf.device != va.device):
                        buf = torch.empty_like(va, dtype=rt)
                        arena[out] = buf
                    env[out] = op(va, vb, out=buf)
                else:
                    env[out] = op(va, vb)
        else:
            def action(env, pending, key):
                env[out] = op(env[a], env[b])
    elif isinstance(o, Copy):
        out, src_buf = o.out, o.src

        def action(env, pending, key):
            env[out] = env[src_buf]
    elif isinstance(o, Pack):
        out, parts = o.out, o.parts

        def action(env, pending, key):
            env[out] = tuple(env[p] for p in parts)
    elif isinstance(o, Unpack):
        outs, src_buf = o.outs, o.src

        def action(env, pending, key):
            for b, v in zip(outs, env[src_buf]):
                env[b] = v
    elif isinstance(o, Slice):
        out, src_buf, parts, index = o.out, o.src, o.parts, o.index

        def action(env, pending, key):
            env[out] = split_flat(env[src_buf], parts)[index]
    elif isinstance(o, Concat):
        out, parts, like = o.out, o.parts, o.like

        def action(env, pending, key):
            flat = concat_flat([env[p] for p in parts])
            env[out] = flat if like is None else flat.reshape(
                shape_of(env[like]))
    elif isinstance(o, Const):
        out, value = o.out, o.value

        def action(env, pending, key):
            env[out] = value
    else:                           # pragma: no cover - new op kinds
        raise TypeError(f"cannot compile op {o!r}")
    return action


def _compile_finish(sched: Schedule) -> Optional[Callable]:
    """The rank-independent parts of result formation, pre-dispatched."""
    kind = sched.output_kind
    if kind == "none":
        return None
    if kind == "concat":
        chunk_bufs = sched.chunk_bufs

        def finish(env, shape, rank):
            return concat_flat([env[c] for c in chunk_bufs]).reshape(shape)
    elif kind == "buf":
        out_bufs = sched.out_bufs

        def finish(env, shape, rank):
            out = out_bufs[rank]
            if out is None:
                return None
            v = env[out]
            # Under an arena the final combine result lives in a reused
            # buffer; hand the caller a copy so the next iteration's
            # in-place writes cannot reach a result already returned.
            if _ARENA in env:
                if isinstance(v, np.ndarray):
                    return v.copy()
                if isinstance(v, torch.Tensor):
                    return v.clone()
            return v
    elif kind == "list":
        names = tuple(("g", i) for i in range(sched.n))

        def finish(env, shape, rank):
            return [env[g] for g in names]
    elif kind == "dirs":
        rv_dirs = sched.in_dirs or sched.out_dirs

        def finish(env, shape, rank):
            return {d: env[("rv", d)] for d in rv_dirs[rank]}
    else:                           # pragma: no cover - new output kinds
        raise ValueError(f"unknown output kind {kind!r}")
    return finish


class _RankPlan:
    """One rank's straight-line program: ``(waits, action)`` steps plus the
    trailing receives completion must drain."""

    __slots__ = ("steps", "tail")

    def __init__(self, steps, tail) -> None:
        self.steps = steps
        self.tail = tail


class CompiledProgram:
    """A schedule pre-bound to one communicator, op and tag family.

    Construction resolves everything rank-independent (transport, rank
    translation table, output formation); per-rank step lists compile
    lazily on first use — a collective caller only ever runs its own
    rank — and are retained for the program's lifetime, so iterating
    callers (persistent collectives, halo exchanges, solver loops) pay
    compilation once.

    ``head`` is the tag-family prefix: step tags are
    ``head + (key, sub)`` — with ``sub`` baked in at compile time —
    namespaced through ``("grp", gid, ...)`` exactly as the communicator
    itself would, so compiled and interpreted ranks of the same
    collective match on the wire.
    """

    __slots__ = ("sched", "comm", "op", "head", "epoch", "_ranks",
                 "_finish", "_isend", "_irecv", "_wranks", "_mktag",
                 "_lock")

    def __init__(self, sched: Schedule, comm, *, op: Optional[Callable],
                 head: Tuple[Any, ...]) -> None:
        if sched.n != comm.size:
            raise ValueError(f"schedule is for n={sched.n} ranks but the "
                             f"communicator has size {comm.size}")
        self.sched = sched
        self.comm = comm
        self.op = op
        self.head = head
        self.epoch = epoch_of(comm)
        self._ranks: List[Optional[_RankPlan]] = [None] * sched.n
        self._finish = _compile_finish(sched)
        self._lock = threading.Lock()
        if isinstance(comm, tac.CommGroup):
            # Pre-translate the whole group ONCE (MPI_Group_translate_ranks)
            # and post straight to the world transport with the group's
            # ("grp", gid, ...) tag namespace baked into the template.
            world = comm.world
            self._wranks = tuple(
                comm.translate_many(range(comm.size), world))
            self._isend, self._irecv = world.isend, world.irecv
            gid = comm.gid

            def mktag(sub):
                def tag(key):
                    return ("grp", gid, head + (key, sub))
                return tag
        else:
            # CommWorld — or any duck-typed communicator without group
            # indirection: local ranks are transport ranks.
            self._wranks = tuple(range(sched.n))
            self._isend, self._irecv = comm.isend, comm.irecv

            def mktag(sub):
                def tag(key):
                    return head + (key, sub)
                return tag
        self._mktag = mktag

    # -- per-rank compilation ----------------------------------------------
    def _rank_plan(self, rank: int) -> _RankPlan:
        plan = self._ranks[rank]
        if plan is None:
            with self._lock:
                plan = self._ranks[rank]
                if plan is None:
                    ops, tail = self.sched.wait_plan(rank)
                    steps = tuple(
                        (waits, _compile_op(o, rank, self._isend,
                                            self._irecv, self._wranks,
                                            self._mktag, self.op))
                        for o, waits in ops)
                    plan = _RankPlan(steps, tail)
                    self._ranks[rank] = plan
        return plan

    # -- execution ----------------------------------------------------------
    def gen(self, rank: int, key: Any, *, value=None, blocks=None,
            sends=None, arena: Optional[Dict[Any, Any]] = None):
        """One rank's compiled run — same generator contract as the
        interpreter: yields outstanding handle(s), result via
        ``StopIteration``.  Binding and validation happen on first
        advance (generator semantics), matching ``_interpret``.

        ``arena`` is an optional caller-owned, per-rank dict of reusable
        combine buffers (see :data:`_ARENA`); pass the same dict on every
        iteration to eliminate per-round result allocations.  The caller
        must not re-post before the previous run completed."""
        if not 0 <= rank < self.sched.n:
            raise ValueError(
                f"rank {rank} out of range for n={self.sched.n}")
        if epoch_of(self.comm) != self.epoch:
            raise StaleProgramError(
                f"compiled program {self.head!r} was built at communicator "
                f"epoch {self.epoch} but the communicator is now at epoch "
                f"{epoch_of(self.comm)} (a rank failed or the communicator "
                f"was revoked) — recompile via compile_schedule()")
        plan = self._rank_plan(rank)
        return self._run(plan, rank, key, value, blocks, sends, arena)

    def _run(self, plan, rank, key, value, blocks, sends, arena=None):
        env, shape = bind_inputs(self.sched, value, blocks, sends)
        if arena is not None:
            env[_ARENA] = arena
        pending: Dict[Any, Any] = {}
        rounds = 0
        for waits, action in plan.steps:
            if waits:
                if len(waits) == 1:
                    b = waits[0]
                    h = pending.pop(b)
                    # Fast path: eager matching often completes the recv
                    # before its consumer runs — take the result without
                    # suspending (the interpreter would yield regardless).
                    env[b] = h.result if h.test() else (yield h)
                else:
                    hs = [pending.pop(b) for b in waits]
                    if all(h.test() for h in hs):
                        for b, h in zip(waits, hs):
                            env[b] = h.result
                    else:
                        vals = yield hs
                        for b, v in zip(waits, vals):
                            env[b] = v
                rounds += 1
                if _trc.TRACING:
                    _trc.TRACER.instant("collective", "round", rank=rank,
                                        step=rounds, waits=len(waits))
            action(env, pending, key)
        tail = plan.tail
        if tail:
            if len(tail) == 1:
                h = pending.pop(tail[0])
                env[tail[0]] = h.result if h.test() else (yield h)
            else:
                hs = [pending.pop(b) for b in tail]
                if all(h.test() for h in hs):
                    for b, h in zip(tail, hs):
                        env[b] = h.result
                else:
                    vals = yield hs
                    for b, v in zip(tail, vals):
                        env[b] = v
            if _trc.TRACING:
                _trc.TRACER.instant("collective", "round", rank=rank,
                                    step=rounds + 1, waits=len(tail))
        finish = self._finish
        return None if finish is None else finish(env, shape, rank)


# ---------------------------------------------------------------------------
# The plan cache.
# ---------------------------------------------------------------------------
CACHE_MAX = 256

_cache: Dict[Tuple[int, int, int, Any, Any], CompiledProgram] = {}
_cache_lock = threading.Lock()
_stats = {"hits": 0, "misses": 0, "evictions": 0}


class StaleProgramError(RuntimeError):
    """A compiled program outlived its communicator epoch.

    Raised by :meth:`CompiledProgram.gen` when the communicator was
    revoked or lost a rank after the program was compiled; the holder
    must recompile (``compile_schedule`` with the bumped epoch in its key
    returns a fresh program).  Persistent wrappers
    (:class:`repro_torch.core.collectives.PersistentCollective`,
    :class:`repro_torch.core.collectives.HaloExchange`) do this automatically.
    """


def epoch_of(comm) -> int:
    """The communicator's failure epoch (0 for epoch-less communicators).

    :class:`repro_torch.core.tac.CommWorld` bumps its ``epoch`` on every
    ``fail_rank``/``revoke``; a :class:`~repro_torch.core.tac.CommGroup`
    inherits the parent world's.  The epoch is part of the plan-cache
    key, so a failure invalidates every cached plan over the affected
    communicator without any explicit flush.
    """
    return getattr(comm, "epoch", 0)


def compile_schedule(sched: Schedule, comm, *, op: Optional[Callable] = None,
                     head: Tuple[Any, ...] = ("prog",)) -> CompiledProgram:
    """The cached entry point: one :class:`CompiledProgram` per
    (schedule identity, communicator identity, communicator epoch, op,
    tag family).

    ``op`` must be the *resolved* combine callable (``_op_fn`` output) —
    named ops resolve to shared module-level functions, so ``"sum"``
    callers share an entry.  Insertion order doubles as the FIFO eviction
    order beyond :data:`CACHE_MAX`; entries pin their schedule and
    communicator (see module docstring on identity keying).  The epoch
    term (:func:`epoch_of`) makes failure recovery automatic: after a
    ``fail_rank``/``revoke`` the old entries are unreachable and the
    first caller compiles a fresh plan.
    """
    key = (id(sched), id(comm), epoch_of(comm), op, head)
    with _cache_lock:
        prog = _cache.get(key)
        if prog is not None:
            _stats["hits"] += 1
            return prog
    prog = CompiledProgram(sched, comm, op=op, head=head)
    with _cache_lock:
        cached = _cache.setdefault(key, prog)
        if cached is prog:
            _stats["misses"] += 1
            while len(_cache) > CACHE_MAX:
                _cache.pop(next(iter(_cache)))
                _stats["evictions"] += 1
        else:
            _stats["hits"] += 1
    return cached


def cache_stats() -> Dict[str, int]:
    """Snapshot of plan-cache counters (plus current ``size``)."""
    with _cache_lock:
        out = dict(_stats)
        out["size"] = len(_cache)
    return out


def clear_cache() -> None:
    """Drop every cached program (tests; releases pinned communicators)."""
    with _cache_lock:
        _cache.clear()
        for k in _stats:
            _stats[k] = 0
