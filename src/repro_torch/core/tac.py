"""TAC — Task-Aware Collectives: the TAMPI analogue for PyTorch (paper §6).

TAMPI intercepts MPI calls and re-expresses them against the pause/resume and
external-events APIs.  Under PyTorch the "MPI layer" is CUDA's stream-ordered
asynchronous launch: work enqueued on a stream is in flight until a
``torch.cuda.Event`` recorded after it completes (``Event.query()`` is the
non-blocking completion test, ``Event.synchronize()`` the blocking wait),
``Tensor.to(device, non_blocking=True)`` is an asynchronous transfer, and
host-side channels give point-to-point semantics between logical ranks.  TAC
wraps those operations in the two modes the paper defines:

* **Blocking mode** (§6.1, Fig. 3): ``tac.wait(handle)`` from inside a task
  converts a blocking wait into *test → register ticket → pause task*; a
  polling service tests the pending tickets and unblocks tasks on
  completion.  The hardware thread never blocks inside the "MPI library".

* **Non-blocking mode** (§6.2, Fig. 4): ``tac.iwait(handle)`` /
  ``tac.iwaitall(handles)`` bind the handles to the calling task's event
  counter and return immediately.  The task may finish; its dependencies are
  released only when the bound operations complete.  No context switch, no
  live stack, no extra scheduler round trips.

Both modes are enabled by initialising TAC with the ``TASK_MULTIPLE``
threading level (§6.3).  Without it, the wrappers fall back to the plain
blocking wait — the "PMPI" path of Fig. 3/4 — and programs must serialise
communication tasks themselves (the *sentinel* pattern, §7.1).
"""

from __future__ import annotations

import concurrent.futures
import itertools
import math
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..obs import trace as _tr
from ..obs.registry import REGISTRY as _REGISTRY
from .continuations import PushCompletion
from .events import (current_task, get_current_blocking_context,
                     get_current_event_counter,
                     increase_current_task_event_counter,
                     decrease_task_event_counter, block_current_task,
                     unblock_task, BlockingContext, EventCounter)
from .executor import TaskRuntime

# -- threading levels (§6.3) -------------------------------------------------
THREAD_SINGLE = 0
THREAD_FUNNELED = 1
THREAD_SERIALIZED = 2
THREAD_MULTIPLE = 3
TASK_MULTIPLE = 4  # monotonically greater than THREAD_MULTIPLE (§6.3)

_provided_level = THREAD_MULTIPLE
_level_lock = threading.Lock()


def init(required: int = TASK_MULTIPLE) -> int:
    """Initialise TAC, requesting a threading level (cf. MPI_Init_thread).

    Returns the *provided* level.  ``TASK_MULTIPLE`` is always available in
    this runtime; programs may still request less to emulate legacy MPI
    libraries (the benchmarks use this to build the Sentinel versions).
    """
    global _provided_level
    with _level_lock:
        _provided_level = min(required, TASK_MULTIPLE)
        return _provided_level


def query_thread() -> int:
    return _provided_level


def is_enabled() -> bool:
    """True when the TASK_MULTIPLE interoperability mechanism is active."""
    return _provided_level >= TASK_MULTIPLE


# ---------------------------------------------------------------------------
# Failure model (ULFM: MPI_ERR_PROC_FAILED / MPI_ERR_REVOKED)
# ---------------------------------------------------------------------------
class RankFailedError(RuntimeError):
    """A peer involved in this operation is dead (MPI_ERR_PROC_FAILED).

    Raised from ``handle.result`` (and therefore from :func:`wait`, from a
    continuation's reader, and from a collective's consumer) — never from
    the posting call itself, matching ULFM's error-on-completion model.
    ``rank`` is the failed world rank when known.
    """

    def __init__(self, rank: Optional[int] = None,
                 message: Optional[str] = None) -> None:
        self.rank = rank
        if message is None:
            message = (f"rank {rank} failed" if rank is not None
                       else "a peer rank failed")
        super().__init__(message)


class CommRevokedError(RankFailedError):
    """The communicator was revoked (MPI_ERR_REVOKED).

    A subclass of :class:`RankFailedError` so recovery code that catches
    the failure also catches the revocation that propagates it.  After a
    revoke, every pending and future operation on the communicator fails
    with this error until the survivors complete a :meth:`CommWorld.shrink`
    agreement.
    """

    def __init__(self, rank: Optional[int] = None,
                 message: Optional[str] = None) -> None:
        super().__init__(rank, message or "communicator revoked")


# ---------------------------------------------------------------------------
# Asynchronous handles ("MPI_Request" analogues)
# ---------------------------------------------------------------------------
class AsyncHandle:
    """A testable/waitable in-flight operation — THE async protocol.

    This is the one contract every asynchronous surface in the runtime
    speaks (documented here once; ``docs/api.md`` lists the conforming
    types):

    * ``test() -> bool`` — non-blocking completion probe (``MPI_Test``);
    * ``wait() -> Any``  — OS-level blocking wait (the 'PMPI' path),
      returning the result;
    * ``result``         — the completed operation's value; raises the
      stored error for erroneous completions (ULFM's
      error-on-completion model).

    Everything that consumes handles — :func:`wait`/:func:`iwait`/
    :func:`iwaitall`/:func:`waitall`,
    :meth:`repro_torch.core.executor.TaskRuntime.taskwait`,
    and :meth:`repro_torch.core.continuations.ContinuationEngine.attach`
    — accepts exactly this protocol (loose inputs are coerced by
    :func:`as_handle`), and
    everything that produces asynchrony — :class:`ArrayHandle`,
    :class:`EventHandle` (and its send/recv/collective subclasses),
    :class:`FutureHandle`, :class:`CompositeHandle`,
    :class:`~repro_torch.core.continuations.Continuation` — returns it.
    Push-capable handles additionally expose ``on_complete(cb)``
    (:class:`~repro_torch.core.continuations.PushCompletion`), which the
    continuation engine uses for O(completions) notification; handles
    without it are re-tested from the engine's fallback poll list.
    """

    def test(self) -> bool:
        raise NotImplementedError

    def wait(self) -> Any:
        """OS-level blocking wait (the 'PMPI' path). Returns the result."""
        raise NotImplementedError

    @property
    def result(self) -> Any:
        return getattr(self, "_result", None)


def _tensor_leaves(value: Any) -> List[torch.Tensor]:
    """The tensors in ``value``: a tensor, or nested lists, tuples and dict
    values of them (the port's counterpart of a JAX pytree's leaves)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensor_leaves(v)]
    if isinstance(value, dict):
        return [t for v in value.values() for t in _tensor_leaves(v)]
    return []


def _record_event(tensors: Sequence[torch.Tensor]) -> Optional[Any]:
    """One ``torch.cuda.Event`` recorded on the current stream of the CUDA
    tensors' device, or ``None`` when no tensor lies on a CUDA device."""
    devices = {t.device for t in tensors if t.is_cuda}
    if not devices:
        return None
    if len(devices) > 1:
        raise ValueError(f"ArrayHandle over tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(devices.pop()))
    return event


class ArrayHandle(AsyncHandle):
    """Completion of stream-ordered work that produces tensors.

    Construction records ONE ``torch.cuda.Event`` on the current stream of
    the CUDA tensors' device: it completes once every kernel and copy
    enqueued on that stream so far — the work producing ``value`` — has
    run.  ``test()`` is ``event.query()``, the exact analogue of
    ``MPI_Test`` for CUDA's asynchronous launch; ``wait()`` is
    ``event.synchronize()``.  A handle over CPU tensors (or no tensors) is
    complete at construction.  ``inputs`` names further tensors whose
    device work gates completion (a device-to-host copy's source).  The
    handle is push-less, like its JAX counterpart, so it rides the
    continuation engine's poll list.
    """

    def __init__(self, value: Any, *, inputs: Sequence[Any] = ()) -> None:
        self._result = value
        self._event = _record_event(_tensor_leaves(value)
                                    + _tensor_leaves(list(inputs)))

    def test(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> Any:
        if self._event is not None:
            self._event.synchronize()
        return self._result


class EventHandle(PushCompletion, AsyncHandle):
    """A manually completed handle (asynchronous host work, I/O, ...).

    Supports **push** completion notification
    (:class:`repro_torch.core.continuations.PushCompletion`):
    :meth:`~repro_torch.core.continuations.PushCompletion.on_complete`
    registers a callback that :meth:`complete` invokes at match time —
    the hook the continuation engine uses to make progress
    O(completions) instead of O(in-flight ops) per poll.  ``complete``
    is idempotent (the first completion wins and fires the callbacks
    exactly once) — a buffered send may be locally complete before its
    match confirms it.

    A handle may also complete *erroneously* via :meth:`fail` — the ULFM
    failure path: the handle is done (``test()`` is True, callbacks fire,
    waiters wake) but ``result`` re-raises the stored exception on every
    consumer.  That is what lets a dead peer surface as a
    :class:`RankFailedError` at task granularity instead of a hung
    ``taskwait``: the failure rides the exact same push-notification
    plumbing as success.
    """

    def __init__(self) -> None:
        super().__init__()
        self._result: Any = None
        self.error: Optional[BaseException] = None
        if _tr.TRACING:
            # Handle-lifecycle tracing: the in-flight span opens here
            # (post time) and closes on complete/fail.  The posting
            # task's rank attributes the span (per-rank overlap
            # accounting); outside task code the span stays unattributed.
            self._t_post = time.monotonic()
            task = current_task()
            self._obs_rank = None if task is None else task.rank
            _REGISTRY.gauge("tac.inflight_handles").inc()

    def _trace_done(self) -> None:
        """Close the in-flight span (first completion only)."""
        t_post = getattr(self, "_t_post", None)
        if t_post is None:
            return
        _REGISTRY.gauge("tac.inflight_handles").dec()
        _tr.TRACER.span("handle", "inflight", t_post, time.monotonic(),
                        rank=self._obs_rank, kind=type(self).__name__,
                        ok=self.error is None)

    @property
    def result(self) -> Any:
        if self.error is not None:
            raise self.error
        return self._result

    def fail(self, exc: BaseException) -> None:
        """Complete erroneously: consumers of ``result`` re-raise ``exc``.

        Idempotent like :meth:`complete`, and a no-op on an
        already-successful handle (the first completion wins — a message
        delivered before the failure was detected stays delivered).
        """
        with self._cb_lock:
            if self._done:
                return
            self.error = exc
            self._done = True
            if self._waiter is not None:
                self._waiter.set()
            cbs, self._cbs = self._cbs, []
        if _tr.TRACING:
            self._trace_done()
        for cb in cbs:
            cb(self)

    def complete(self, result: Any = None) -> None:
        # Open-coded _complete_once(assign): this runs 2-3 times per
        # transfer (O(n²) per allreduce) and the closure-pair allocation
        # is measurable there.  Semantics are identical.
        with self._cb_lock:
            if self._done:
                return
            self._result = result
            self._done = True
            if self._waiter is not None:
                self._waiter.set()
            cbs, self._cbs = self._cbs, []
        if _tr.TRACING:
            self._trace_done()
        for cb in cbs:
            cb(self)

    def wait(self) -> Any:
        self._wait_event().wait()
        return self.result


class FutureHandle(AsyncHandle):
    """Adapter for ``concurrent.futures.Future``."""

    def __init__(self, future: Any) -> None:
        self._future = future

    def test(self) -> bool:
        return self._future.done()

    def wait(self) -> Any:
        return self._future.result()

    def on_complete(self, cb: Callable[["FutureHandle"], None]) -> None:
        """Push notification via ``Future.add_done_callback``."""
        self._future.add_done_callback(lambda _f: cb(self))

    @property
    def result(self) -> Any:
        return self._future.result() if self._future.done() else None


class CompositeHandle(AsyncHandle):
    def __init__(self, handles: Sequence[AsyncHandle]) -> None:
        self._handles = list(handles)

    def test(self) -> bool:
        return all(h.test() for h in self._handles)

    def wait(self) -> Any:
        return [h.wait() for h in self._handles]

    @property
    def result(self) -> Any:
        return [h.result for h in self._handles]


def run_async(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> ArrayHandle:
    """Launch a tensor computation and return its completion handle.

    CUDA launches are asynchronous, so this returns as soon as the work is
    enqueued on the current stream — the handle completes when the kernels
    producing the result tensors have run.
    """
    return ArrayHandle(fn(*args, **kwargs))


def transfer(value: Any, target: Any) -> ArrayHandle:
    """Asynchronous device transfer (the point-to-point data motion):
    ``.to(target, non_blocking=True)`` of a tensor, or of each tensor in a
    list or tuple, on the current stream, plus its completion event."""
    def move(v: Any) -> Any:
        if isinstance(v, (list, tuple)):
            return type(v)(move(x) for x in v)
        return v.to(target, non_blocking=True)
    return ArrayHandle(move(value), inputs=[value])


# ---------------------------------------------------------------------------
# CommWorld: logical ranks with MPI point-to-point semantics
# ---------------------------------------------------------------------------
class _SendHandle(EventHandle):
    def __init__(self, payload: Any, synchronous: bool) -> None:
        super().__init__()
        self.payload = payload
        if not synchronous:
            # Buffered send: locally complete immediately (MPI_Isend on a
            # small message); synchronous send completes on match (MPI_Issend).
            # No other thread can hold a reference during __init__, so the
            # completion publishes lock-free (complete() stays idempotent:
            # the match-time re-complete sees _done and returns).
            self._result = payload
            self._done = True
            if _tr.TRACING:
                # complete() will early-return on the match-time call, so
                # close the (zero-length) in-flight span here.
                self._trace_done()


class _RecvHandle(EventHandle):
    pass


class CommWorld:
    """``size`` logical ranks with ordered, tagged point-to-point messaging.

    Matching follows MPI semantics: messages between the same (src, dst, tag)
    triple are non-overtaking; matching is eager (performed at post time
    under the world lock).  Payloads are passed by reference — callers
    sharing device arrays get zero-copy semantics on a single host, which is
    the honest analogue of intra-node MPI.
    """

    def __init__(self, size: int) -> None:
        self.size = size
        self._lock = threading.Lock()
        self._msgs: dict = {}   # (src, dst, tag) -> list[_SendHandle]
        self._recvs: dict = {}  # (src, dst, tag) -> list[_RecvHandle]
        self.stats = {"messages": 0, "bytes": 0}
        self._group_seq = itertools.count()   # communicator context ids
        self._split_calls = [0] * size        # per-rank split generation
        self._splits: Dict[int, dict] = {}    # generation -> rank -> call
        # -- failure model (ULFM) -------------------------------------------
        self.epoch = 0                        # bumped on fail/revoke/shrink
        self._failed: set = set()             # dead world ranks
        self._revoked = False                 # whole-world revoke in effect
        self._revoked_groups: set = set()     # revoked group context ids
        self._shrink_calls = [0] * size       # per-rank shrink generation
        self._shrinks: Dict[int, dict] = {}   # generation -> rank -> handle
        self._fault_hook: Optional[Callable] = None   # FaultInjector tap

    def _key(self, src: int, dst: int, tag: Any) -> Tuple[int, int, Any]:
        return (src, dst, tag)

    def _group_revoked(self, tag: Any) -> Any:
        """The revoked group whose tag space ``tag`` lies in, else None."""
        if (isinstance(tag, tuple) and len(tag) == 3 and tag[0] == "grp"
                and tag[1] in self._revoked_groups):
            return tag[1]
        return None

    def _failed_op(self, handle: EventHandle, src: int, dst: int,
                   tag: Any = None) -> EventHandle:
        """Fail a fresh handle for an op that can never complete."""
        gid = self._group_revoked(tag)
        if self._revoked:
            handle.fail(CommRevokedError())
        elif gid is not None:
            handle.fail(CommRevokedError(
                message=f"communicator {gid!r} revoked"))
        else:
            if src in self._failed:
                dead: Optional[int] = src
            elif dst in self._failed:
                dead = dst
            else:
                dead = next(iter(self._failed), None)
            handle.fail(RankFailedError(dead))
        return handle

    def isend(self, payload: Any, *, src: int, dst: int, tag: Any = 0,
              synchronous: bool = False) -> _SendHandle:
        if not (0 <= src < self.size and 0 <= dst < self.size):
            raise ValueError(f"rank out of range: {src}->{dst}")
        hook = self._fault_hook
        if hook is not None:
            hook("isend", src, dst, tag)
        h = _SendHandle(payload, synchronous)
        key = self._key(src, dst, tag)
        matched = None
        with self._lock:
            # Checked under the lock that revoke() and fail_rank() sweep
            # the pending ops under: checked before it, a revoke landing
            # in between would miss this op and leave it pending forever.
            dead = (self._revoked or src in self._failed
                    or dst in self._failed
                    or self._group_revoked(tag) is not None)
            if not dead:
                self.stats["messages"] += 1
                recvs = self._recvs.get(key)
                if recvs:
                    matched = recvs.pop(0)
                else:
                    self._msgs.setdefault(key, []).append(h)
        if dead:
            # ULFM: an op naming a dead peer (or posted on a revoked
            # communicator) completes erroneously instead of matching.
            return self._failed_op(_SendHandle(payload, True), src, dst,
                                   tag)
        if matched is not None:
            if _tr.TRACING:
                _tr.TRACER.instant("handle", "match", src=src, dst=dst,
                                   rank=getattr(h, "_obs_rank", None))
            # Complete OUTSIDE the world lock: completion may push a
            # continuation whose dispatch posts messages (needs the lock).
            matched.complete(payload)
            if not h._done:                 # buffered sends already are
                h.complete(payload)
        return h

    def irecv(self, *, src: int, dst: int, tag: Any = 0) -> _RecvHandle:
        hook = self._fault_hook
        if hook is not None:
            hook("irecv", src, dst, tag)
        key = self._key(src, dst, tag)
        r = _RecvHandle()
        matched = None
        with self._lock:
            dead = (self._revoked or src in self._failed
                    or dst in self._failed
                    or self._group_revoked(tag) is not None)
            if not dead:
                msgs = self._msgs.get(key)
                if msgs:
                    matched = msgs.pop(0)
                else:
                    self._recvs.setdefault(key, []).append(r)
        if dead:
            return self._failed_op(r, src, dst, tag)
        if matched is not None:
            if _tr.TRACING:
                _tr.TRACER.instant("handle", "match", src=src, dst=dst,
                                   rank=getattr(r, "_obs_rank", None))
            if not matched._done:           # synchronous send: confirm match
                matched.complete(matched.payload)   # outside the lock
            r.complete(matched.payload)
        return r

    # Blocking conveniences (intercepted like MPI_Recv/MPI_Ssend, Fig. 3).
    def recv(self, *, src: int, dst: int, tag: Any = 0) -> Any:
        return wait(self.irecv(src=src, dst=dst, tag=tag))

    def send(self, payload: Any, *, src: int, dst: int, tag: Any = 0) -> None:
        wait(self.isend(payload, src=src, dst=dst, tag=tag))

    def ssend(self, payload: Any, *, src: int, dst: int, tag: Any = 0) -> None:
        wait(self.isend(payload, src=src, dst=dst, tag=tag, synchronous=True))

    # -- rank-translation hooks ---------------------------------------------
    # A CommWorld is its own trivial "group": these identity hooks let
    # schedule-IR consumers (the host interpreter, the lowering, the
    # hierarchical composition) translate communicator-local ranks
    # uniformly without testing for CommGroup.
    def world_rank(self, rank: int) -> int:
        """Communicator-local rank -> world rank (identity for the world)."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} out of range for size {self.size}")
        return rank

    def group_rank(self, world_rank: int) -> Optional[int]:
        """World rank -> communicator-local rank (identity for the world)."""
        return world_rank if 0 <= world_rank < self.size else None

    # -- sub-communicators (MPI_Comm_split / MPI_Comm_group / Cart) ---------
    def group(self, ranks: Sequence[int]) -> "CommGroup":
        """A sub-communicator over ``ranks`` (group-local order as given).

        Central construction: call once, share the returned object among
        the member ranks.  Every call mints a fresh context id, so two
        groups over the same ranks still have disjoint tag spaces (as two
        ``MPI_Comm_dup``-ed communicators would).
        """
        return CommGroup(self, ranks, ("g", next(self._group_seq)))

    def split(self, color: Any, key: int = 0, *, rank: int) -> "GroupHandle":
        """MPI_Comm_split: a collective group construction.

        Every world rank calls once per split *generation* (its n-th call
        joins the n-th split, matching MPI's same-order rule).  Returns a
        handle that completes when the last rank has called; ``result`` is
        this rank's :class:`CommGroup` — the ranks that passed an equal
        ``color``, ordered by ``(key, world rank)`` — or ``None`` when
        ``color`` is ``None`` (MPI_UNDEFINED).  The handle is task-aware:
        ``tac.wait(handle)`` inside a task pauses instead of spinning.
        """
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} out of range for size {self.size}")
        handle = GroupHandle()
        if self._revoked or self._failed:
            # A split needs every world rank; with a dead member it can
            # never complete — fail fast (survivors shrink() instead).
            return self._failed_op(handle, rank, rank)
        ready = None
        with self._lock:
            gen = self._split_calls[rank]
            self._split_calls[rank] += 1
            entry = self._splits.setdefault(gen, {})
            entry[rank] = (color, key, handle)
            if len(entry) == self.size:
                ready = self._splits.pop(gen)
        if ready is not None:
            # Build the groups and complete the handles OUTSIDE the world
            # lock: a completing handle may wake a waiter that immediately
            # posts messages (which need the lock).
            by_color: Dict[Any, List[Tuple[int, int]]] = {}
            for r, (c, k, _) in ready.items():
                if c is not None:
                    by_color.setdefault(c, []).append((k, r))
            groups = {
                c: CommGroup(self, [r for _, r in sorted(members)],
                             ("split", gen, c))
                for c, members in by_color.items()}
            for r, (c, _, h) in ready.items():
                h.complete(None if c is None else groups[c])
        return handle

    def cart_create(self, dims: Sequence[int],
                    periodic: Any = False) -> "CartGroup":
        """Cartesian sub-communicator over the first ``prod(dims)`` ranks
        (MPI_Cart_create, row-major rank order).  ``periodic`` is a bool or
        a per-dimension sequence."""
        n = math.prod(int(d) for d in dims)
        if n > self.size:
            raise ValueError(f"cartesian grid {tuple(dims)} needs {n} ranks,"
                             f" world has {self.size}")
        return CartGroup(self, range(n), ("cart", next(self._group_seq)),
                         dims, periodic)

    def dist_graph_create(
            self, adjacency: Sequence[Sequence[int]],
            directed: bool = False) -> "DistGraphGroup":
        """Distributed-graph sub-communicator over the first
        ``len(adjacency)`` ranks (the ``MPI_Dist_graph_create_adjacent``
        analogue for unstructured meshes).

        ``adjacency[r]`` lists rank ``r``'s neighbours (group-local
        numbering).  Like :meth:`cart_create` the construction is
        central: build once, share the group.  By default the adjacency
        must be symmetric (every edge declared by both endpoints — the
        ``sources == destinations`` case of the MPI call, which is what
        an unstructured-mesh halo exchange needs) and self-loop-free.
        With ``directed=True``, ``adjacency[r]`` lists rank ``r``'s
        *out*-neighbours (its destinations) and edges may be one-way —
        the general ``MPI_Dist_graph_create_adjacent`` case; in-neighbour
        lists are derived (:meth:`DistGraphGroup.in_neighbor_dirs`).  The
        group's :meth:`DistGraphGroup.topology` feeds
        :func:`repro_torch.core.schedule.build_neighbor` exactly like a
        Cartesian grid's, so :class:`~repro_torch.core.collectives.HaloExchange`
        and ``Collectives.neighbor_alltoall`` work unchanged over it.
        """
        n = len(adjacency)
        if n > self.size:
            raise ValueError(f"graph with {n} ranks exceeds world size "
                             f"{self.size}")
        return DistGraphGroup(self, range(n),
                              ("graph", next(self._group_seq)), adjacency,
                              directed=directed)

    # -- ULFM failure detection, revoke, and shrink -------------------------
    @property
    def failed(self) -> frozenset:
        """The dead world ranks (MPI_Comm_failure_ack / get_failed)."""
        with self._lock:
            return frozenset(self._failed)

    @property
    def alive(self) -> Tuple[int, ...]:
        """The surviving world ranks, ascending."""
        with self._lock:
            return tuple(r for r in range(self.size)
                         if r not in self._failed)

    @property
    def revoked(self) -> bool:
        return self._revoked

    def fail_rank(self, rank: int) -> None:
        """Kill ``rank``: the failure-detection entry point.

        Every *pending* send/recv naming the dead rank completes
        erroneously with :class:`RankFailedError` — pushed through the
        handles' completion callbacks, so both notification backends
        observe the failure with zero new polling.  Every *future* op
        naming it fails at post time.  Pending ``split`` generations can
        never complete (they need all ranks) and are failed too.  The
        communicator epoch is bumped, invalidating epoch-keyed compiled
        plans (:func:`repro_torch.core.program.epoch_of`).  Idempotent.
        """
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} out of range for size {self.size}")
        to_fail: List[EventHandle] = []
        with self._lock:
            if rank in self._failed:
                return
            self._failed.add(rank)
            self.epoch += 1
            for store in (self._msgs, self._recvs):
                for key in [k for k in store if rank in k[:2]]:
                    to_fail.extend(store.pop(key))
            split_handles = [h for entry in self._splits.values()
                             for (_c, _k, h) in entry.values()]
            self._splits.clear()
            ready = self._shrink_ready_locked()
        # Fail OUTSIDE the lock: failing completes the handles, and a
        # completion callback may post messages (which need the lock).
        exc = RankFailedError(rank)
        for h in to_fail:
            h.fail(exc)
        for h in split_handles:
            h.fail(exc)
        # A shrink agreement pending on only this rank's vote is now
        # decided: the dead rank no longer gets a say.
        self._complete_shrinks(ready)

    def revoke(self) -> None:
        """Revoke the communicator (MPI_Comm_revoke).

        Any survivor that observes a :class:`RankFailedError` calls this
        to propagate the failure: every pending operation — whoever it
        names — completes erroneously with :class:`CommRevokedError`, and
        new operations fail at post time, so no peer can stay parked on a
        handle whose partner aborted.  The revocation stays in effect
        until a :meth:`shrink` agreement completes.  Idempotent per
        revocation window.
        """
        with self._lock:
            if self._revoked:
                return
            self._revoked = True
            self.epoch += 1
            to_fail = [h for hs in self._msgs.values() for h in hs]
            to_fail += [h for hs in self._recvs.values() for h in hs]
            self._msgs.clear()
            self._recvs.clear()
            split_handles = [h for entry in self._splits.values()
                             for (_c, _k, h) in entry.values()]
            self._splits.clear()
        exc = CommRevokedError()
        for h in to_fail:
            h.fail(exc)
        for h in split_handles:
            h.fail(exc)

    def revoke_group(self, gid: Any) -> None:
        """Revoke one sub-communicator's traffic only (its tag space):
        pending group ops fail now, and ops posted on the group later fail
        at post time (a revoked communicator stays revoked; the survivors
        shrink to a new one).  Without the latter, a rank posting its
        round after a peer's revoke would park forever on peers that have
        already aborted theirs."""
        def is_group_tag(tag: Any) -> bool:
            return (isinstance(tag, tuple) and len(tag) == 3
                    and tag[0] == "grp" and tag[1] == gid)
        with self._lock:
            self._revoked_groups.add(gid)
            self.epoch += 1
            to_fail = []
            for store in (self._msgs, self._recvs):
                for key in [k for k in store if is_group_tag(k[2])]:
                    to_fail.extend(store.pop(key))
        exc = CommRevokedError(message=f"communicator {gid!r} revoked")
        for h in to_fail:
            h.fail(exc)

    def shrink(self, *, rank: int) -> GroupHandle:
        """ULFM MPI_Comm_shrink: survivors agree on a shrunken communicator.

        A collective agreement among the *live* ranks (same generation
        counting as :meth:`split`): the returned handle completes once
        every survivor of this generation has called, with a
        :class:`CommGroup` over the survivors (ascending world-rank
        order, dense group-local numbering) as its result — all callers
        of one generation share the same group object, so compiled-plan
        caches are shared too.  Completing the agreement ends any active
        :meth:`revoke` window.  A caller that is itself dead — or dies
        mid-agreement — gets its handle failed instead; the agreement
        then completes without its vote (``fail_rank`` re-checks pending
        generations).  The handle is task-aware like ``split``'s.
        """
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} out of range for size {self.size}")
        handle = GroupHandle()
        with self._lock:
            if rank in self._failed:
                dead_caller = True
                ready: List[tuple] = []
            else:
                dead_caller = False
                gen = self._shrink_calls[rank]
                self._shrink_calls[rank] += 1
                self._shrinks.setdefault(gen, {})[rank] = handle
                ready = self._shrink_ready_locked()
        if dead_caller:
            handle.fail(RankFailedError(rank))
            return handle
        self._complete_shrinks(ready)
        return handle

    def _shrink_ready_locked(self) -> List[tuple]:
        """Pop the shrink generations whose surviving voters all arrived.

        Caller holds ``_lock``.  Returns ``(gen, votes, survivors,
        epoch)`` records for :meth:`_complete_shrinks` to finish outside
        the lock.
        """
        survivors = tuple(r for r in range(self.size)
                          if r not in self._failed)
        ready = []
        for gen in sorted(self._shrinks):
            entry = self._shrinks[gen]
            if all(r in entry for r in survivors):
                ready.append((gen, self._shrinks.pop(gen), survivors,
                              self.epoch))
        return ready

    def _complete_shrinks(self, ready: List[tuple]) -> None:
        for gen, entry, survivors, epoch in ready:
            group = CommGroup(self, survivors, ("shrink", epoch, gen))
            with self._lock:
                # The agreement is the recovery point: survivors hold a
                # working communicator again, so the revocation window
                # closes before any completion callback can observe it.
                self._revoked = False
            for r, h in entry.items():
                if r in self._failed:
                    h.fail(RankFailedError(r))
                else:
                    h.complete(group)


class GroupHandle(EventHandle):
    """Completion of a collective group construction (``CommWorld.split``)."""


class CommGroup:
    """An ordered subset of a CommWorld's ranks — the MPI sub-communicator.

    Group-local ranks ``0..size-1`` map onto the parent world's ranks in
    ``ranks`` order.  All traffic flows through the parent world, but every
    tag is namespaced by the group's context id, so a group's channels can
    never match the world's (or another group's) — the isolated context of
    an MPI communicator.  Non-overtaking order per ``(src, dst, tag)`` is
    inherited from the world.  A :class:`~repro_torch.core.collectives.Collectives`
    instance accepts a group anywhere it accepts a world.
    """

    def __init__(self, world: CommWorld, ranks: Sequence[int],
                 gid: Any) -> None:
        ranks = tuple(int(r) for r in ranks)
        if not ranks:
            raise ValueError("a group needs at least one rank")
        if len(set(ranks)) != len(ranks):
            raise ValueError(f"duplicate ranks in group: {ranks}")
        for r in ranks:
            if not 0 <= r < world.size:
                raise ValueError(f"world rank {r} out of range "
                                 f"(world size {world.size})")
        self.world = world
        self.ranks = ranks
        self.gid = gid
        self._to_group = {wr: gr for gr, wr in enumerate(ranks)}

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def stats(self) -> dict:
        return self.world.stats

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(gid={self.gid!r}, "
                f"ranks={self.ranks})")

    # -- rank translation (MPI_Group_translate_ranks) -----------------------
    def world_rank(self, rank: int) -> int:
        """Group-local rank -> parent world rank."""
        self._check(rank)
        return self.ranks[rank]

    def group_rank(self, world_rank: int) -> Optional[int]:
        """Parent world rank -> group-local rank (None if not a member)."""
        return self._to_group.get(world_rank)

    def translate(self, rank: int, other: "CommGroup") -> Optional[int]:
        """This group's ``rank`` in ``other``'s numbering (None if absent)."""
        return other.group_rank(self.world_rank(rank))

    def translate_many(self, ranks: Sequence[int],
                       other: "CommGroup") -> List[Optional[int]]:
        """MPI_Group_translate_ranks: batch :meth:`translate`."""
        return [self.translate(r, other) for r in ranks]

    # -- failure model (delegated to the parent world) ----------------------
    @property
    def epoch(self) -> int:
        """The parent world's communicator epoch (conservative: any
        failure/revoke anywhere invalidates this group's compiled plans
        too — see :func:`repro_torch.core.program.epoch_of`)."""
        return self.world.epoch

    @property
    def failed(self) -> frozenset:
        """The dead *group-local* ranks of this group."""
        return frozenset(gr for gr, wr in enumerate(self.ranks)
                         if wr in self.world.failed)

    def revoke(self) -> None:
        """Revoke this sub-communicator only (its tag space): pending and
        later group traffic fails with :class:`CommRevokedError`; the
        world and sibling groups are untouched."""
        self.world.revoke_group(self.gid)

    # -- rebuild helpers (the recovery path) --------------------------------
    def cart(self, dims: Sequence[int], periodic: Any = False) -> "CartGroup":
        """Re-shape this group's members as a Cartesian topology.

        The recovery step after :meth:`CommWorld.shrink`: the shrunken
        group's dense ranks get grid coordinates again so persistent
        neighbourhood schedules can be rebuilt.  A fresh context id is
        minted — old in-flight tags can never match the new topology.
        """
        n = math.prod(int(d) for d in dims)
        if n != self.size:
            raise ValueError(f"cartesian grid {tuple(dims)} needs {n} "
                             f"ranks, group has {self.size}")
        return CartGroup(self.world, self.ranks,
                         ("cart", next(self.world._group_seq)),
                         dims, periodic)

    def graph(self, adjacency: Sequence[Sequence[int]],
              directed: bool = False) -> "DistGraphGroup":
        """Re-shape this group's members as a distributed graph (the
        unstructured-mesh sibling of :meth:`cart`)."""
        if len(adjacency) != self.size:
            raise ValueError(f"graph with {len(adjacency)} ranks does not "
                             f"cover group size {self.size}")
        return DistGraphGroup(self.world, self.ranks,
                              ("graph", next(self.world._group_seq)),
                              adjacency, directed=directed)

    # -- point-to-point (group-local ranks, namespaced tags) ----------------
    def _check(self, rank: int) -> None:
        if not 0 <= rank < len(self.ranks):
            raise ValueError(f"group rank {rank} out of range "
                             f"(group size {len(self.ranks)})")

    def _tag(self, tag: Any) -> Any:
        return ("grp", self.gid, tag)

    def isend(self, payload: Any, *, src: int, dst: int, tag: Any = 0,
              synchronous: bool = False) -> _SendHandle:
        self._check(src)
        self._check(dst)
        return self.world.isend(payload, src=self.ranks[src],
                                dst=self.ranks[dst], tag=self._tag(tag),
                                synchronous=synchronous)

    def irecv(self, *, src: int, dst: int, tag: Any = 0) -> _RecvHandle:
        self._check(src)
        self._check(dst)
        return self.world.irecv(src=self.ranks[src], dst=self.ranks[dst],
                                tag=self._tag(tag))

    def recv(self, *, src: int, dst: int, tag: Any = 0) -> Any:
        return wait(self.irecv(src=src, dst=dst, tag=tag))

    def send(self, payload: Any, *, src: int, dst: int, tag: Any = 0) -> None:
        wait(self.isend(payload, src=src, dst=dst, tag=tag))

    def ssend(self, payload: Any, *, src: int, dst: int, tag: Any = 0) -> None:
        wait(self.isend(payload, src=src, dst=dst, tag=tag, synchronous=True))


class _NeighborTopology:
    """Shared ``topology()`` for groups with persistent neighbour lists
    (:class:`CartGroup`, :class:`DistGraphGroup`)."""

    def topology(self):
        """All ranks' neighbour lists as one hashable tuple.

        ``topology()[r] == tuple(neighbor_dirs(r))`` — the value that
        keys the cached neighbourhood schedule
        (:func:`repro_torch.core.schedule.build_neighbor`): two topologies of
        the same shape share one schedule object.
        """
        return tuple(tuple(self.neighbor_dirs(r))
                     for r in range(self.size))


class CartGroup(_NeighborTopology, CommGroup):
    """Cartesian process topology over a sub-communicator (MPI_Cart_create).

    Group-local ranks are laid out row-major over ``dims``; ``periodic``
    marks wrap-around dimensions.  The neighbourhood collectives
    (:class:`~repro_torch.core.collectives.HaloExchange`,
    ``Collectives.neighbor_alltoall``) take their persistent neighbour
    lists from this topology.
    """

    def __init__(self, world: CommWorld, ranks: Sequence[int], gid: Any,
                 dims: Sequence[int], periodic: Any = False) -> None:
        dims = tuple(int(d) for d in dims)
        if not dims or any(d <= 0 for d in dims):
            raise ValueError(f"invalid cartesian dims {dims}")
        if isinstance(periodic, (bool, int)):
            periodic = (bool(periodic),) * len(dims)
        else:
            periodic = tuple(bool(p) for p in periodic)
            if len(periodic) != len(dims):
                raise ValueError("periodic must match dims "
                                 f"({len(periodic)} != {len(dims)})")
        super().__init__(world, ranks, gid)
        if math.prod(dims) != self.size:
            raise ValueError(f"dims {dims} do not cover {self.size} ranks")
        self.dims = dims
        self.periodic = periodic

    @property
    def ndim(self) -> int:
        return len(self.dims)

    def coords(self, rank: int) -> Tuple[int, ...]:
        """Group rank -> cartesian coordinates (row-major)."""
        self._check(rank)
        out = []
        for d in reversed(self.dims):
            rank, c = divmod(rank, d)
            out.append(c)
        return tuple(reversed(out))

    def rank_at(self, coords: Sequence[int]) -> Optional[int]:
        """Coordinates -> group rank; periodic dims wrap, out-of-range
        coordinates in non-periodic dims give ``None`` (off the grid)."""
        if len(coords) != self.ndim:
            raise ValueError(f"expected {self.ndim} coordinates, "
                             f"got {len(coords)}")
        rank = 0
        for c, d, p in zip(coords, self.dims, self.periodic):
            if p:
                c %= d
            elif not 0 <= c < d:
                return None
            rank = rank * d + c
        return rank

    def shift(self, rank: int, dim: int,
              disp: int = 1) -> Tuple[Optional[int], Optional[int]]:
        """MPI_Cart_shift: ``(source, destination)`` for a shift of
        ``disp`` along ``dim`` — either end is ``None`` off a
        non-periodic edge."""
        if not 0 <= dim < self.ndim:
            raise ValueError(f"dim {dim} out of range for {self.dims}")
        c = list(self.coords(rank))
        dst = list(c)
        dst[dim] += disp
        src = list(c)
        src[dim] -= disp
        return self.rank_at(src), self.rank_at(dst)

    def neighbor_dirs(
            self, rank: int) -> List[Tuple[Tuple[int, int], int]]:
        """Persistent neighbour list: ``[((dim, ±1), neighbour rank)]`` in
        deterministic (dim, -1 then +1) order, off-grid directions
        omitted.  A direction is *from this rank's perspective*: ``(0, -1)``
        is the neighbour one step down in dimension 0."""
        dirs = []
        for dim in range(self.ndim):
            for disp in (-1, 1):
                _, dst = self.shift(rank, dim, disp)
                if dst is not None and dst != rank:
                    dirs.append(((dim, disp), dst))
        return dirs

    def neighbors(self, rank: int) -> List[int]:
        """Neighbour group ranks in ``neighbor_dirs`` order."""
        return [nbr for _, nbr in self.neighbor_dirs(rank)]


class DistGraphGroup(_NeighborTopology, CommGroup):
    """Unstructured-graph process topology (MPI_Dist_graph_create_adjacent).

    The non-Cartesian sibling of :class:`CartGroup`: neighbour lists come
    from an explicit adjacency instead of grid coordinates.  In the
    symmetric (default) case a neighbour *direction* is ``((lo, hi), ±1)``
    — the undirected edge's endpoint pair plus which way along it this
    rank sends (``+1`` from the lower-ranked endpoint) — so reciprocity
    holds exactly as on a grid: rank ``r``'s direction ``d`` toward ``q``
    is matched by ``q``'s direction ``(d[0], -d[1])`` toward ``r``, which
    is what :func:`repro_torch.core.schedule.build_neighbor` requires of a
    topology.

    With ``directed=True`` the adjacency lists *out*-neighbours and edges
    may be one-way: the edge ``u → v`` is the send direction
    ``((u, v), +1)`` at ``u`` and the receive direction ``((u, v), -1)``
    at ``v`` (:meth:`in_neighbor_dirs`).  A graph declaring both
    ``u → v`` and ``v → u`` therefore carries two independent one-way
    edges with distinct direction labels.  :meth:`in_topology` hands the
    per-rank receive-direction lists to ``build_neighbor`` so asymmetric
    exchanges validate and schedule correctly.
    """

    def __init__(self, world: CommWorld, ranks: Sequence[int], gid: Any,
                 adjacency: Sequence[Sequence[int]],
                 directed: bool = False) -> None:
        super().__init__(world, ranks, gid)
        self.directed = bool(directed)
        adj = []
        for r, nbrs in enumerate(adjacency):
            nbrs = sorted({int(q) for q in nbrs})
            for q in nbrs:
                if not 0 <= q < self.size:
                    raise ValueError(f"rank {r}: neighbour {q} out of "
                                     f"range for graph size {self.size}")
                if q == r:
                    raise ValueError(f"rank {r}: self-loop in adjacency")
            adj.append(tuple(nbrs))
        self.adjacency = tuple(adj)
        if self.directed:
            in_adj: List[List[int]] = [[] for _ in range(self.size)]
            for r, nbrs in enumerate(self.adjacency):
                for q in nbrs:
                    in_adj[q].append(r)
            self.in_adjacency = tuple(tuple(sorted(s)) for s in in_adj)
        else:
            for r, nbrs in enumerate(self.adjacency):
                for q in nbrs:
                    if r not in self.adjacency[q]:
                        raise ValueError(
                            f"asymmetric adjacency: {r} lists {q} but {q} "
                            f"does not list {r} (every edge must be "
                            f"declared by both endpoints; pass "
                            f"directed=True for one-way edges)")
            self.in_adjacency = self.adjacency

    def neighbor_dirs(self, rank: int) -> List[Tuple[Tuple[Any, int], int]]:
        """Persistent *send* neighbour list in ascending-neighbour order
        (deterministic, like the grid's): ``[(((lo, hi), ±1), neighbour)]``
        for a symmetric graph, ``[(((rank, q), +1), q)]`` for a directed
        one."""
        self._check(rank)
        if self.directed:
            return [(((rank, q), 1), q) for q in self.adjacency[rank]]
        return [(((min(rank, q), max(rank, q)), 1 if rank < q else -1), q)
                for q in self.adjacency[rank]]

    def in_neighbor_dirs(
            self, rank: int) -> List[Tuple[Tuple[Any, int], int]]:
        """Persistent *receive* neighbour list ``[(direction, source)]``.

        For a symmetric graph this equals :meth:`neighbor_dirs` (every
        receive direction is also a send direction); for a directed graph
        it lists the in-edges ``(((q, rank), -1), q)``.
        """
        self._check(rank)
        if not self.directed:
            return self.neighbor_dirs(rank)
        return [(((q, rank), -1), q) for q in self.in_adjacency[rank]]

    def in_topology(self):
        """Per-rank receive-direction lists for
        :func:`repro_torch.core.schedule.build_neighbor`'s ``in_topology``
        argument — ``None`` for a symmetric graph (receives mirror
        sends), a hashable tuple-of-tuples of direction labels for a
        directed one."""
        if not self.directed:
            return None
        return tuple(tuple(d for d, _ in self.in_neighbor_dirs(r))
                     for r in range(self.size))

    def neighbors(self, rank: int) -> List[int]:
        """Out-neighbour group ranks in ``neighbor_dirs`` order."""
        return [nbr for _, nbr in self.neighbor_dirs(rank)]

    def in_neighbors(self, rank: int) -> List[int]:
        """In-neighbour group ranks in ``in_neighbor_dirs`` order."""
        return [nbr for _, nbr in self.in_neighbor_dirs(rank)]


# ---------------------------------------------------------------------------
# The AsyncHandle protocol coercion — ONE async-wait surface
# ---------------------------------------------------------------------------
def as_handle(obj: Any) -> AsyncHandle:
    """Coerce ``obj`` to the :class:`AsyncHandle` protocol.

    The single normalisation point of the public async surface: whatever
    :func:`wait`/:func:`iwait`/:func:`iwaitall`,
    :meth:`repro_torch.core.executor.TaskRuntime.taskwait` and
    :meth:`repro_torch.core.continuations.ContinuationEngine.attach` accept
    goes through here.  Accepted inputs:

    * anything already satisfying the protocol (``test()``/``wait()``/
      ``result`` — every :class:`AsyncHandle` subclass,
      :class:`~repro_torch.core.collectives.CollectiveHandle`, and
      :class:`~repro_torch.core.continuations.Continuation`), returned as-is;
    * a ``concurrent.futures.Future`` (wrapped in :class:`FutureHandle`);
    * a tensor, or a dict of tensors (wrapped in :class:`ArrayHandle` —
      the stream-ordered work producing it is the in-flight operation);
    * a list/tuple of any of the above (wrapped in
      :class:`CompositeHandle`).
    """
    if isinstance(obj, AsyncHandle):
        return obj
    if callable(getattr(obj, "test", None)) and \
            callable(getattr(obj, "wait", None)):
        return obj          # duck-typed protocol (e.g. Continuation)
    if isinstance(obj, concurrent.futures.Future):
        return FutureHandle(obj)
    if isinstance(obj, (list, tuple)):
        return CompositeHandle([as_handle(h) for h in obj])
    return ArrayHandle(obj)


# ---------------------------------------------------------------------------
# Deprecated ticket-pool shims (pre-fold entry points)
# ---------------------------------------------------------------------------
def _ticket_pool_deprecated(name: str) -> None:
    warnings.warn(
        f"tac.{name} is deprecated: the TAC ticket pool was folded into "
        f"the runtime's ContinuationEngine (runtime.continuations), the "
        f"single completion dispatcher for both notify backends; attach "
        f"callbacks there instead",
        DeprecationWarning, stacklevel=3)


class _Ticket:
    """Deprecated record of the retired ticket pool (shim)."""

    __slots__ = ("handle", "waiter", "counter", "n_events")

    def __init__(self, handle: AsyncHandle,
                 waiter: Optional[BlockingContext] = None,
                 counter: Optional[EventCounter] = None,
                 n_events: int = 1) -> None:
        _ticket_pool_deprecated("_Ticket")
        self.handle = handle
        self.waiter = waiter      # blocking mode: context to unblock
        self.counter = counter    # non-blocking mode: counter to decrease
        self.n_events = n_events


class _TicketPool:
    """Deprecated facade over the runtime's :class:`ContinuationEngine`.

    The ticket pool is no longer an independent completion path: ``add``
    attaches the ticket's unblock/decrease action to the continuation
    engine (which re-tests push-less handles from its fallback poll list
    — the old pool's discipline), and ``pending`` reads the engine's
    fallback-list length.  No polling service of its own is registered.
    """

    def __init__(self, runtime: TaskRuntime) -> None:
        _ticket_pool_deprecated("_TicketPool")
        self._runtime = runtime

    def add(self, ticket: _Ticket) -> None:
        eng = self._runtime.continuations
        if ticket.waiter is not None:
            waiter = ticket.waiter
            eng.attach(ticket.handle, lambda: unblock_task(waiter))
        if ticket.counter is not None:
            counter, n = ticket.counter, ticket.n_events
            eng.attach(ticket.handle,
                       lambda: decrease_task_event_counter(counter, n))

    @property
    def pending(self) -> int:
        return self._runtime.continuations.polled


def _pool(runtime: TaskRuntime) -> _TicketPool:
    _ticket_pool_deprecated("_pool")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return _TicketPool(runtime)


def _use_continuations(runtime: TaskRuntime) -> bool:
    """Deprecated: the continuation engine is the only completion
    dispatcher now; ``notify="polling"`` is a compatibility mode of the
    SAME engine (``push=False``), so there is no branch left to take."""
    _ticket_pool_deprecated("_use_continuations")
    return True


# ---------------------------------------------------------------------------
# The two interoperability modes
# ---------------------------------------------------------------------------
def wait(handle: Any) -> Any:
    """Task-aware blocking wait (§6.1, Fig. 3).

    Accepts anything :func:`as_handle` accepts.  Inside a task with
    TASK_MULTIPLE enabled: test; if incomplete, attach a resume callback
    to the runtime's continuation engine and *pause the task* — the
    worker runs other ready tasks until the completion dispatch unblocks
    us (pushed at match time under ``notify="continuation"``; re-tested
    from the engine's poll list under the ``notify="polling"``
    compatibility mode).  Otherwise: plain blocking wait (the PMPI path).
    """
    handle = as_handle(handle)
    task = current_task()
    if is_enabled() and task is not None:
        if handle.test():
            return handle.result
        ctx = get_current_blocking_context()
        task._runtime.continuations.attach(
            handle, lambda: unblock_task(ctx))
        block_current_task(ctx)
        return handle.result
    handle.wait()
    return handle.result


def waitall(handles: Sequence[Any]) -> List[Any]:
    """Blocking wait on several handles with a single pause/resume cycle."""
    coerced = [as_handle(h) for h in handles]
    wait(CompositeHandle(coerced))
    return [h.result for h in coerced]


def iwait(handle: Any) -> None:
    """TAMPI_Iwait (§6.2, Fig. 4): bind ``handle`` to the task's events.

    Accepts anything :func:`as_handle` accepts and returns immediately.
    The calling task's dependencies are released only once the task
    finishes *and* the handle completes.  The buffers produced by the
    operation must not be consumed inside this task after the call —
    consumers declare dependencies instead (Fig. 5).
    """
    handle = as_handle(handle)
    task = current_task()
    if is_enabled() and task is not None:
        if handle.test():
            return
        cnt = get_current_event_counter()
        increase_current_task_event_counter(cnt, 1)
        if _tr.TRACING:
            _tr.TRACER.instant("handle", "bind", rank=task.rank,
                               task=task.name, n_events=1)

            def _decrease(cnt=cnt, task=task) -> None:
                decrease_task_event_counter(cnt, 1)
                # §4.3 made visible: the dependency release deferred to
                # completion time, firing from the dispatch thread.
                _tr.TRACER.instant("handle", "dep-release", rank=task.rank,
                                   task=task.name, n_events=1)

            task._runtime.continuations.attach(handle, _decrease)
            return
        task._runtime.continuations.attach(
            handle, lambda: decrease_task_event_counter(cnt, 1))
        return
    handle.wait()


def iwaitall(handles: Sequence[Any]) -> None:
    """TAMPI_Iwaitall (§6.2): bind several handles to the task's events."""
    task = current_task()
    if is_enabled() and task is not None:
        pending = [h for h in map(as_handle, handles) if not h.test()]
        if not pending:
            return
        cnt = get_current_event_counter()
        increase_current_task_event_counter(cnt, len(pending))
        n = len(pending)
        if _tr.TRACING:
            _tr.TRACER.instant("handle", "bind", rank=task.rank,
                               task=task.name, n_events=n)

            def _decrease(cnt=cnt, n=n, task=task) -> None:
                decrease_task_event_counter(cnt, n)
                _tr.TRACER.instant("handle", "dep-release", rank=task.rank,
                                   task=task.name, n_events=n)

            task._runtime.continuations.attach(pending, _decrease)
            return
        task._runtime.continuations.attach(
            pending, lambda: decrease_task_event_counter(cnt, n))
        return
    for h in map(as_handle, handles):
        h.wait()
