"""Task-aware collectives layered on CommWorld point-to-point (paper §6,
extended to collectives).

The paper applies the pause/resume and external-events APIs to MPI
point-to-point; follow-on work (*Callback-based Completion Notification
using MPI Continuations*; *MPI Progress For All*) shows the same two modes
extend naturally to collectives when completion is driven by a
progress/notification engine instead of per-call blocking.  This module
implements that design for the host runtime:

* Every collective is described ONCE as **data** — a
  :class:`repro_torch.core.schedule.Schedule`, a DAG of
  ``Send``/``Recv``/``Combine``/``Slice``... ops over abstract
  communicator-local ranks (see :mod:`repro_torch.core.schedule`).  This module
  is the schedule IR's **Level-A executor**: :func:`_interpret` walks one
  rank's program, posting ``isend``/``irecv`` through the communicator —
  a :class:`~repro_torch.core.tac.CommWorld` or any
  :class:`~repro_torch.core.tac.CommGroup` sub-communicator — and yielding the
  handles it must wait on.  The in-graph **Level-B executor** for the
  same IR is :mod:`repro.core.lowering`.  Two algorithm families are
  provided per collective:

  - ``ring``      — neighbour rounds (ring/chain/pairwise): ``n-1`` steps,
                    bandwidth-optimal for large payloads.
  - ``doubling``  — logarithmic schedules (recursive doubling /
                    dissemination / binomial tree / Bruck): ``⌈log2 n⌉``
                    steps, latency-optimal for small payloads.  Non-power-
                    of-two rank counts are handled by folding (reductions)
                    or by the Bruck construction (gathers/all-to-all),
                    which works for any ``n`` directly.
  - ``"auto"``    — pick by minimum predicted α-β cost
                    (:func:`repro_torch.core.schedule.best_schedule`) for the
                    actual payload size, including the segment count of
                    the pipelined ring allreduce.

* Each collective runs in one of the paper's two interoperability modes:

  - ``mode="blocking"`` (§6.1): the call returns the rank's result; inside
    a task the rounds are advanced by the progress engine and the task
    pays a *single* test → register ticket → pause on the completion
    handle (one pause per collective, not per round — per-round pausing
    would deadlock help-first nested blocking, whose LIFO stacks cannot
    interleave two in-flight multi-round schedules).  Outside a task (or
    without ``TASK_MULTIPLE``) the schedule is driven inline with plain
    OS-level waits, exactly like the point-to-point wrappers.

  - ``mode="event"`` (§6.2): the call returns a
    :class:`CollectiveHandle` *immediately* and binds one external event
    to the calling task.  The remaining rounds are advanced by a
    :class:`ProgressEngine` registered as a polling service — the
    continuation/progress-engine design of the follow-on papers: no live
    stack, no context switch, sends of later rounds are posted by the
    polling thread as their inputs arrive.  The task's dependencies are
    released only when the collective completes; successors read
    ``handle.result``.

Determinism: the combine operand order is part of the schedule, so every
rank applies the operator in matching order and finishes with a bitwise-
identical result (for commutative IEEE ops like add/max).  Tag space is
isolated per call — either through the per-rank call sequence (MPI's
"same order on every rank" rule) or an explicit ``key`` for programs
whose task schedulers may reorder independent collectives.

Beyond the seven world-wide collectives this module provides the
*neighbourhood* layer over Cartesian groups —
:meth:`Collectives.neighbor_alltoall` and the persistent
:class:`HaloExchange` — :class:`HierarchicalCollectives` (an allreduce
composed from three schedules over two nested sub-groups), and
**persistent collectives** (:meth:`Collectives.persistent`, the
``MPI_Allreduce_init`` analogue): since schedules are data, a pre-built
handle can be re-posted every iteration with a fresh tag space.
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs import trace as _trc
from . import tac
from . import program as program_ir
from . import schedule as schedule_ir
from .options import CollectiveOptions, renamed_kwarg
from .program import NamedOp, as_payload, concat_flat, shape_of, split_flat
from .program import bind_inputs as _bind_inputs
from .schedule import (Combine, Concat, Const, Copy, Pack, Recv, Schedule,
                       Send, Slice, Unpack)
from .events import (current_task, get_current_event_counter,
                     increase_current_task_event_counter,
                     decrease_task_event_counter)

__all__ = ["Collectives", "CollectiveHandle", "ProgressEngine", "n_rounds",
           "HaloExchange", "HierarchicalCollectives",
           "PersistentCollective", "ALGORITHMS", "MODES", "EXECUTORS"]

ALGORITHMS = ("ring", "doubling")
MODES = ("blocking", "event")
# Level-A executors: "compiled" caches each (schedule, communicator, op,
# tag-family) as a flat pre-bound program (repro_torch.core.program) — the
# steady-state default; "interpreted" re-walks the IR per call
# (_interpret) — the reference executor.  Wire protocol (tags, posting
# order) is identical, so mixed-executor ranks interoperate.
EXECUTORS = ("compiled", "interpreted")


def _norm_executor(executor: str) -> str:
    if executor not in EXECUTORS:
        raise ValueError(f"unknown executor {executor!r}; "
                         f"one of {EXECUTORS}")
    return executor

# Named reductions: numpy payloads combine with the ufunc, tensor payloads
# with the torch op of the same name on their own device.
_OPS: Dict[str, Callable] = {
    "sum": NamedOp("sum", np.add, torch.add),
    "prod": NamedOp("prod", np.multiply, torch.mul),
    "max": NamedOp("max", np.maximum, torch.maximum),
    "min": NamedOp("min", np.minimum, torch.minimum)}

_ALG_ALIASES = {"ring": "ring", "chain": "ring", "pairwise": "ring",
                "doubling": "doubling", "recursive-doubling": "doubling",
                "rd": "doubling", "tree": "doubling", "bruck": "doubling",
                "dissemination": "doubling", "auto": "auto"}
_MODE_ALIASES = {"blocking": "blocking", "wait": "blocking",
                 "event": "event", "iwait": "event",
                 "nonblocking": "event", "non-blocking": "event"}


def _op_fn(op) -> Callable:
    if callable(op):
        return op
    try:
        return _OPS[op]
    except KeyError:
        raise ValueError(f"unknown reduction op {op!r}; "
                         f"use one of {sorted(_OPS)} or a callable")


def _norm_alg(algorithm: str) -> str:
    try:
        return _ALG_ALIASES[algorithm]
    except KeyError:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"aliases: {sorted(_ALG_ALIASES)}")


def _norm_mode(mode: str) -> str:
    try:
        return _MODE_ALIASES[mode]
    except KeyError:
        raise ValueError(f"unknown mode {mode!r}; "
                         f"aliases: {sorted(_MODE_ALIASES)}")


def n_rounds(name: str, algorithm: str, size: int) -> int:
    """Message rounds on the critical path — the closed-form latency model.

    Equals ``schedule.build(name, algorithm, size).rounds`` (asserted in
    tests/test_schedule.py) but needs no schedule construction; for
    payload-size-aware predictions use
    :meth:`repro_torch.core.schedule.Schedule.cost` instead.
    """
    alg = _norm_alg(algorithm)
    if alg == "auto":
        raise ValueError('n_rounds needs a concrete algorithm, not "auto" '
                         '(auto is payload-size dependent — use '
                         'Schedule.cost / Collectives.predict)')
    if size <= 1:
        return 0
    log2_ceil = max(1, math.ceil(math.log2(size)))
    if alg == "doubling":
        # Reductions butterfly over 2^⌊log2 n⌋ after folding the remainder
        # ranks (+1 fold and +1 unfold round when n is not a power of two).
        butterfly = size.bit_length() - 1
        extra = 0 if size & (size - 1) == 0 else 2
        return {"allreduce": butterfly + extra,
                "reduce_scatter": butterfly + extra,
                "reduce": log2_ceil, "bcast": log2_ceil,
                "barrier": log2_ceil, "allgather": log2_ceil,
                "alltoall": log2_ceil}[name]
    return {"allreduce": 2 * (size - 1)}.get(name, size - 1)


class CollectiveHandle(tac.EventHandle):
    """Completion handle of an event-bound collective (result at release).

    A schedule failure (bad payloads, a raising ``op``, a dead peer's
    :class:`~repro_torch.core.tac.RankFailedError`...) completes the handle via
    :meth:`~repro_torch.core.tac.EventHandle.fail`; ``result`` re-raises it on
    whichever thread consumes the collective, so errors surface instead
    of killing the polling service or hanging ``taskwait``.
    """


# ---------------------------------------------------------------------------
# Generator-driven state machines + progress engine
# ---------------------------------------------------------------------------
class _Machine:
    """One rank's collective schedule, advanced as its handles complete.

    The generator yields the handle (or list of handles) it waits on; the
    driver sends the received payload(s) back in.  ``advance`` is *not*
    re-entrant: callers must ensure one thread at a time (the progress
    engine serialises via the polling registry's per-service lock; the
    group driver is single-threaded).
    """

    __slots__ = ("gen", "handle", "counter", "comm", "steps", "done",
                 "_waiting", "_started")

    def __init__(self, gen, handle: CollectiveHandle,
                 counter=None, comm=None) -> None:
        self.gen = gen
        self.handle = handle
        self.counter = counter
        self.comm = comm        # revoked on peer failure (ULFM recovery)
        self.steps = 0          # resolved waits — progress indicator
        self.done = False
        self._waiting: Any = None
        self._started = False

    def advance(self) -> bool:
        """Run until the next incomplete wait; True once finished."""
        if self.done:
            return True
        try:
            if not self._started:
                self._started = True
                self._waiting = next(self.gen)
            while True:
                w = self._waiting
                many = isinstance(w, (list, tuple))
                hs = list(w) if many else [w]
                if not all(h.test() for h in hs):
                    return False
                res = [h.result for h in hs] if many else hs[0].result
                self.steps += 1
                if _trc.TRACING:
                    # One resolved wait == one round of this rank's
                    # schedule advanced (by whichever progress thread).
                    _trc.TRACER.instant("collective", "round",
                                        step=self.steps, waits=len(hs))
                self._waiting = self.gen.send(res)
        except StopIteration as stop:
            self.done = True
            self.handle.complete(stop.value)
            if self.counter is not None:
                decrease_task_event_counter(self.counter, 1)
            return True
        except BaseException as exc:  # noqa: BLE001 - surfaced via handle
            # A raising schedule must not kill the polling thread or leave
            # the task's event counter bound forever — fail the handle
            # (consumers re-raise) and release the dependency.
            self.done = True
            if (self.comm is not None
                    and isinstance(exc, tac.RankFailedError)
                    and not isinstance(exc, tac.CommRevokedError)):
                # ULFM recovery step 1: the rank that observes a peer
                # failure mid-collective revokes the communicator, so
                # every *other* rank's pending rounds fail too instead of
                # parking forever on sends the aborted ranks will never
                # post.  CommRevokedError is excluded — a machine killed
                # by the revoke itself must not re-revoke.
                revoke = getattr(self.comm, "revoke", None)
                if revoke is not None:
                    revoke()
            self.handle.fail(exc)
            if self.counter is not None:
                decrease_task_event_counter(self.counter, 1)
            return True


class ProgressEngine:
    """Advances event-bound collective machines to completion.

    The notification engine of the follow-on papers (*Callback-based
    Completion Notification using MPI Continuations*; *MPI Progress For
    All*): completion is detected and *continued* (next rounds posted,
    results combined, dependencies released) by the runtime's progress
    threads, never by a blocked caller.  Two backends:

    * ``notify="polling"`` — a registered polling service re-``advance``s
      every pending machine each tick: O(in-flight machines) handle
      tests per poll (``stats["tests"]`` counts them).
    * ``notify="continuation"`` — each machine, when it parks on an
      incomplete wait, **re-arms a continuation on its next awaited
      handle(s)** via the runtime's
      :class:`repro_torch.core.continuations.ContinuationEngine`; the machine
      is advanced exactly when something it waits on completes — O(1)
      dispatches per completion, zero re-polling, no machine list at
      all.  Event-bound dependency release
      (:func:`repro_torch.core.events.decrease_task_event_counter`) fires from
      the continuation callback (inside :meth:`_Machine.advance`).

    ``stats``: ``polls`` (service invocations), ``tests`` (machines
    re-advanced by polling — the O(in-flight × ticks) term), ``rearms``
    (continuations armed — O(completions)).
    """

    def __init__(self, notify: str = "polling",
                 continuations: Any = None) -> None:
        if notify not in ("polling", "continuation"):
            raise ValueError(f"unknown notify backend {notify!r}")
        if notify == "continuation" and continuations is None:
            raise ValueError('notify="continuation" needs a '
                             'ContinuationEngine (continuations=)')
        self.notify = notify
        self._continuations = continuations
        self._lock = threading.Lock()
        self._machines: List[_Machine] = []
        self._armed = 0
        self.stats: Dict[str, int] = {"polls": 0, "tests": 0, "rearms": 0}

    def submit(self, machine: _Machine) -> None:
        # First advance on the caller's thread (posts the initial sends);
        # the machine only becomes visible to the poller/continuation if
        # still pending, so `advance` never runs concurrently.
        if machine.advance():
            return
        if self.notify == "continuation":
            with self._lock:
                self._armed += 1
            self._arm(machine)
            return
        with self._lock:
            self._machines.append(machine)

    # -- continuation backend ----------------------------------------------
    def _arm(self, machine: _Machine) -> None:
        """Attach a continuation to the machine's next awaited handles."""
        w = machine._waiting
        handles = list(w) if isinstance(w, (list, tuple)) else [w]
        with self._lock:
            self.stats["rearms"] += 1
        self._continuations.attach(
            handles, lambda: self._continue(machine))

    def _continue(self, machine: _Machine) -> None:
        if machine.advance():
            with self._lock:
                self._armed -= 1
        else:
            self._arm(machine)

    # -- polling backend ----------------------------------------------------
    def poll(self, _data: Any) -> bool:
        with self._lock:
            snapshot = list(self._machines)
            self.stats["polls"] += 1
            self.stats["tests"] += len(snapshot)
        finished = [m for m in snapshot if m.advance()]
        if finished:
            with self._lock:
                self._machines = [m for m in self._machines
                                  if m not in finished]
        return False  # stay registered

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._machines) + self._armed


def _engine(runtime) -> ProgressEngine:
    eng = getattr(runtime, "_coll_engine", None)
    if eng is None:
        with runtime._lock:
            eng = getattr(runtime, "_coll_engine", None)
            if eng is None:
                if getattr(runtime, "notify", "polling") == "continuation":
                    # Machines ride the runtime's continuation engine —
                    # its single service; nothing new to register.
                    eng = ProgressEngine(
                        notify="continuation",
                        continuations=runtime.continuations)
                else:
                    eng = ProgressEngine()
                    runtime._register_service(
                        "collective progress engine", eng.poll)
                runtime._coll_engine = eng  # type: ignore[attr-defined]
    return eng


def _drive_blocking(gen):
    """Drive a schedule with task-aware waits (pause/resume per round)."""
    try:
        w = next(gen)
        while True:
            if isinstance(w, (list, tuple)):
                res = tac.waitall(list(w))
            else:
                res = tac.wait(w)
            w = gen.send(res)
    except StopIteration as stop:
        return stop.value


def _execute_schedule(gen, mode: str, comm=None):
    """Run one rank's schedule in an interoperability mode (normalized).

    Shared by every collective family (world-wide, neighbourhood,
    hierarchical, persistent).  Outside a task (or without TASK_MULTIPLE)
    the schedule is driven inline with OS-level waits — the PMPI path.
    Inside a task the progress engine advances the rounds from the polling
    service: ``blocking`` pays one pause on the completion handle,
    ``event`` binds the handle to the task's event counter and returns it
    immediately.  ``comm`` is the communicator to revoke if a peer dies
    mid-schedule (see :meth:`_Machine.advance`).
    """
    task = current_task()
    if not (tac.is_enabled() and task is not None):
        result = _drive_blocking(gen)
        if mode == "blocking":
            return result
        handle = CollectiveHandle()
        handle.complete(result)
        return handle
    handle = CollectiveHandle()
    if mode == "blocking":
        _engine(task._runtime).submit(_Machine(gen, handle, comm=comm))
        return tac.wait(handle)
    counter = get_current_event_counter()
    increase_current_task_event_counter(counter, 1)
    _engine(task._runtime).submit(_Machine(gen, handle, counter, comm=comm))
    return handle


def _drive_group(machines: Sequence[_Machine]) -> None:
    """Round-robin all ranks' machines on the calling thread.

    The deterministic single-threaded driver: used by the sequential
    ('pure'/fork-join) benchmark versions and by tests that need a
    collective without a task runtime.  All matching is in-memory and
    eager, so a full pass with zero progress means the schedule itself is
    stuck — reported instead of spinning.
    """
    pending = [m for m in machines if not m.advance()]
    while pending:
        progressed = False
        nxt = []
        for m in pending:
            before = m.steps
            if m.advance() or m.steps != before:
                progressed = True
            if not m.done:
                nxt.append(m)
        if nxt and not progressed:
            # A failed rank stalls its peers (their recvs never match);
            # surface the root cause rather than the symptom.
            for m in machines:
                if m.handle.error is not None:
                    raise m.handle.error
            names = [getattr(m.gen, "__name__", "?") for m in nxt]
            raise RuntimeError(
                f"collective group stalled: {len(nxt)} ranks cannot "
                f"progress ({names}) — mismatched call order or rank set")
        pending = nxt


# ---------------------------------------------------------------------------
# The Level-A executor: one generator interprets any Schedule.
# Posts isends, yields irecv handle(s), receives the payload(s) via
# send(); StopIteration.value is the rank's result.
# ---------------------------------------------------------------------------
def _interpret(sched: Schedule, comm, rank: int, tag, *, value=None,
               op=None, blocks=None, sends=None):
    """Execute rank ``rank``'s program of ``sched`` over ``comm``.

    The host-side (Level A) consumer of the schedule IR: ops run in
    program order; ``Recv`` posts the ``irecv`` immediately (eager
    matching), and the generator only *yields* — a single handle or a
    batched list — when an op actually reads a buffer that is still in
    flight.  The same generator therefore serves all three drivers
    (inline PMPI waits, the blocking-mode progress engine, the event-bound
    progress engine) and any communicator with ``isend``/``irecv`` —
    world, sub-group, or Cartesian group, whose namespaced tags and rank
    translation apply transparently.
    """
    if not 0 <= rank < sched.n:
        raise ValueError(f"rank {rank} out of range for n={sched.n}")
    env, shape = _bind_inputs(sched, value, blocks, sends)
    pending: Dict[Any, Any] = {}    # buffer -> in-flight irecv handle

    def _reads_of(o):
        return [b for b in o.reads if b in pending]

    for o in sched.programs[rank]:
        needed = _reads_of(o)
        if len(needed) == 1:
            env[needed[0]] = yield pending.pop(needed[0])
        elif needed:
            handles = [pending.pop(b) for b in needed]
            vals = yield handles
            for b, v in zip(needed, vals):
                env[b] = v
        if isinstance(o, Send):
            comm.isend(env[o.buf], src=rank, dst=o.peer, tag=tag(o.tag))
        elif isinstance(o, Recv):
            pending[o.buf] = comm.irecv(src=o.peer, dst=rank,
                                        tag=tag(o.tag))
        elif isinstance(o, Combine):
            env[o.out] = op(env[o.a], env[o.b])
        elif isinstance(o, Copy):
            env[o.out] = env[o.src]
        elif isinstance(o, Pack):
            env[o.out] = tuple(env[p] for p in o.parts)
        elif isinstance(o, Unpack):
            for b, v in zip(o.outs, env[o.src]):
                env[b] = v
        elif isinstance(o, Slice):
            env[o.out] = split_flat(env[o.src], o.parts)[o.index]
        elif isinstance(o, Concat):
            flat = concat_flat([env[p] for p in o.parts])
            env[o.out] = flat if o.like is None else flat.reshape(
                shape_of(env[o.like]))
        elif isinstance(o, Const):
            env[o.out] = o.value
        else:                       # pragma: no cover - new op kinds
            raise TypeError(f"cannot interpret op {o!r}")
    if pending:
        # Completion requires every posted receive (a collective may not
        # finish before its incoming rounds do — barrier semantics).
        bufs = list(pending)
        if len(bufs) == 1:
            env[bufs[0]] = yield pending.pop(bufs[0])
        else:
            vals = yield [pending.pop(b) for b in bufs]
            for b, v in zip(bufs, vals):
                env[b] = v

    kind = sched.output_kind
    if kind == "none":
        return None
    if kind == "buf":
        out = sched.out_bufs[rank]
        return None if out is None else env[out]
    if kind == "concat":
        return concat_flat([env[c] for c in sched.chunk_bufs]).reshape(shape)
    if kind == "list":
        return [env[("g", i)] for i in range(sched.n)]
    if kind == "dirs":
        rv_dirs = sched.in_dirs or sched.out_dirs
        return {d: env[("rv", d)] for d in rv_dirs[rank]}
    raise ValueError(f"unknown output kind {kind!r}")  # pragma: no cover


def _payload_nbytes(value) -> int:
    """Per-rank payload size for ``algorithm="auto"`` (reductions only —
    their element-wise semantics make the size identical on all ranks,
    so every rank resolves the same schedule)."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    try:
        return 0 if value is None else np.asarray(value).nbytes
    except Exception:               # noqa: BLE001 - opaque payloads
        return 0


# Per-op default algorithm, shared by the per-rank methods and run_group:
# latency-optimal doubling for the rooted/small ops, bandwidth-optimal ring
# for the bulk ones.
_DEFAULT_ALGORITHM = {
    "barrier": "doubling", "bcast": "doubling", "reduce": "doubling",
    "allreduce": "ring", "allgather": "ring", "reduce_scatter": "ring",
    "alltoall": "ring",
}


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------
class Collectives:
    """Collective operations over a communicator.

    The communicator may be a :class:`tac.CommWorld` or any
    :class:`tac.CommGroup` (``world.group(...)``, ``world.split(...)``,
    ``world.cart_create(...)``): ranks are communicator-local and a
    group's tag namespace keeps concurrent collectives on disjoint
    sub-groups — or on a group and its parent world — fully isolated.

    Every rank participating in a collective calls the same method (from
    its own task or thread).  Tag isolation follows MPI's rule — each rank
    must issue its collectives in the same order — via per-rank sequence
    counters; programs whose schedulers may reorder *independent*
    collectives pass an explicit ``key`` instead (any hashable, identical
    on all ranks of one collective).

    ``mode="blocking"`` returns the rank's result (pausing the task per
    round); ``mode="event"`` returns a :class:`CollectiveHandle` bound to
    the calling task's event counter — consume ``handle.result`` from a
    successor task.

    ``alpha``/``beta``/``gamma`` parameterise the α-β cost model used by
    ``algorithm="auto"`` (and by :meth:`predict`): per-message latency,
    wire seconds per byte, combine seconds per byte.
    """

    def __init__(self, comm, *, alpha: float = 1e-6, beta: float = 1e-9,
                 gamma: float = 0.0, calibration: Any = None,
                 executor: str = "compiled",
                 hierarchical: Optional[int] = None,
                 hierarchy: Optional[int] = None,
                 inter_alpha: Optional[float] = None,
                 inter_beta: Optional[float] = None,
                 options: Optional[CollectiveOptions] = None) -> None:
        # `hierarchy=` is the pre-CollectiveOptions spelling of the pod
        # size; the per-call kwarg was always `hierarchical=`, so the
        # constructor now matches it (one spelling everywhere).
        hierarchical = renamed_kwarg("hierarchy", hierarchy,
                                     "hierarchical", hierarchical)
        if options is not None:
            [hierarchical] = options.take(hierarchical=hierarchical)
        self.executor = _norm_executor(executor)
        self.comm = comm
        self.world = comm   # historical alias (pre-sub-communicator name)
        self.alpha = alpha
        self.beta = beta
        self.gamma = gamma
        self.inter_alpha = inter_alpha
        self.inter_beta = inter_beta
        if calibration is not None:
            # a CALIBRATION.json path (tools/calibrate.py output) or a
            # pre-loaded {"alpha", "beta", "gamma"} mapping: measured
            # constants replace the nominal ones, so algorithm="auto"
            # selects under the machine actually running.
            consts = (dict(calibration) if isinstance(calibration, dict)
                      else schedule_ir.load_calibration(calibration))
            self.alpha = float(consts["alpha"])
            self.beta = float(consts["beta"])
            self.gamma = float(consts["gamma"])
            if inter_alpha is None and not isinstance(calibration, dict):
                # pick up the calibrated inter-pod transport when the
                # benchmark legs have fitted one ("inter" family) — the
                # constants the two-tier auto candidates pay cross-pod.
                try:
                    inter = schedule_ir.load_calibration(calibration,
                                                         family="inter")
                except KeyError:
                    pass
                else:
                    self.inter_alpha = inter["alpha"]
                    self.inter_beta = inter["beta"]
        # Pod structure for algorithm="auto": `hierarchical` consecutive
        # ranks form a pod; auto then also considers the composed
        # hierarchical allreduce and costs EVERY candidate under the
        # two-tier link (see schedule.best_schedule).
        self.hierarchy = int(hierarchical) if hierarchical else None
        if self.hierarchy is not None and (
                self.hierarchy < 1 or comm.size % self.hierarchy):
            raise ValueError(f"hierarchical pod size {hierarchical} must "
                             f"divide the communicator size {comm.size}")
        self._seq = [itertools.count() for _ in range(comm.size)]

    # -- plumbing ----------------------------------------------------------
    def _key(self, rank: int, key: Any) -> Any:
        """The call's tag epoch: explicit, or the next per-rank sequence
        number (MPI's same-order-on-every-rank rule).  Consumed only
        AFTER validation/resolution succeeded — both executors draw from
        the same counters, so a rejected call can never desynchronize a
        rank's subsequent keyless collectives from its peers."""
        return next(self._seq[rank]) if key is None else key

    def _tagger(self, name: str, rank: int, key: Any):
        key = self._key(rank, key)

        def tag(sub: Any):
            return ("coll", name, key, sub)
        return tag

    # Ops whose payload size is identical on every rank by the collective's
    # semantics (element-wise reductions; barrier is size-free).  Only
    # these may pick the schedule from the local payload: for
    # bcast/allgather/alltoall the local sizes can legitimately differ
    # across ranks (non-root bcast callers pass None, gathers may be
    # ragged), and a size-dependent choice would hand different ranks
    # different schedules — a mismatch stall.
    _UNIFORM_PAYLOAD = ("barrier", "reduce", "allreduce", "reduce_scatter")

    def _resolve(self, name: str, algorithm: Optional[str],
                 segments: int = 1, root: int = 0, value=None,
                 nbytes: Optional[int] = None,
                 hierarchical: Optional[int] = None) -> Schedule:
        """Algorithm/segment resolution -> the (cached) schedule object."""
        if hierarchical is not None:
            if name != "allreduce":
                raise ValueError("hierarchical schedules exist for "
                                 "allreduce only")
            if algorithm is not None or segments != 1:
                raise ValueError("hierarchical= fixes the composed "
                                 "schedule; drop algorithm/segments")
            intra = int(hierarchical)
            if intra < 1 or self.comm.size % intra:
                raise ValueError(
                    f"hierarchical intra size {hierarchical} must divide "
                    f"the communicator size {self.comm.size}")
            return schedule_ir.build_hierarchical(
                intra, self.comm.size // intra)
        algorithm = _norm_alg(algorithm or _DEFAULT_ALGORITHM[name])
        if algorithm == "auto":
            if name not in self._UNIFORM_PAYLOAD:
                # size can differ per rank: fall back to the deterministic
                # per-op default so all ranks agree on the schedule.
                algorithm = _DEFAULT_ALGORITHM[name]
            else:
                if nbytes is None:
                    nbytes = _payload_nbytes(value)
                return schedule_ir.best_schedule(
                    name, self.comm.size, nbytes, alpha=self.alpha,
                    beta=self.beta, gamma=self.gamma, root=root,
                    intra=self.hierarchy if name == "allreduce" else None,
                    inter_alpha=self.inter_alpha,
                    inter_beta=self.inter_beta)
        return schedule_ir.build(name, algorithm, self.comm.size,
                                 root=root, segments=segments)

    def _schedule(self, name: str, algorithm: str, rank: int, key: Any,
                  *, segments: int = 1, root: int = 0, value=None,
                  op=None, blocks=None, hierarchical: Optional[int] = None):
        n = self.comm.size
        if not 0 <= rank < n:
            raise ValueError(f"rank {rank} out of range for size {n}")
        sched = self._resolve(name, algorithm, segments, root, value,
                              hierarchical=hierarchical)
        key = self._key(rank, key)
        if self.executor == "compiled":
            prog = program_ir.compile_schedule(sched, self.comm, op=op,
                                               head=("coll", name))
            return prog.gen(rank, key, value=value, blocks=blocks)

        def tag(sub: Any):
            return ("coll", name, key, sub)
        return _interpret(sched, self.comm, rank, tag,
                          value=value, op=op, blocks=blocks)

    def _run(self, name: str, algorithm: Optional[str], rank: int,
             key: Any, mode: str, **kw):
        # Normalize/validate EVERYTHING before _schedule consumes the
        # per-rank tag sequence — a rejected call must not desynchronize
        # this rank's subsequent keyless collectives from its peers.
        mode = _norm_mode(mode)
        if algorithm is not None:
            _norm_alg(algorithm)
        return _execute_schedule(
            self._schedule(name, algorithm, rank, key, **kw), mode,
            comm=self.comm)

    def predict(self, name: str, nbytes: int, *,
                algorithm: Optional[str] = None,
                segments: int = 1) -> float:
        """Predicted seconds for one collective under the α-β model
        (``algorithm="auto"`` resolves for the given ``nbytes``)."""
        sched = self._resolve(name, algorithm, segments, nbytes=nbytes)
        return sched.cost(self.alpha, self.beta, nbytes, gamma=self.gamma)

    # -- the seven collectives ---------------------------------------------
    # algorithm=None picks the per-op default from _DEFAULT_ALGORITHM
    # (latency-optimal doubling for the rooted/small ops, bandwidth-optimal
    # ring for the bulk ones) — shared with run_group so the two entry
    # points can never drift apart.  algorithm="auto" picks by α-β cost.
    # Every method additionally accepts options=CollectiveOptions(...) —
    # the consolidated tuning spec (repro_torch.core.options); explicit kwargs
    # override its fields, and fields an op cannot honour raise.
    def barrier(self, *, rank: int, algorithm: Optional[str] = None,
                mode: str = "blocking", key: Any = None,
                options: Optional[CollectiveOptions] = None):
        [algorithm] = CollectiveOptions.merge(options, algorithm=algorithm)
        return self._run("barrier", algorithm, rank, key, mode)

    def bcast(self, value: Any = None, *, rank: int, root: int = 0,
              algorithm: Optional[str] = None, mode: str = "blocking",
              key: Any = None,
              options: Optional[CollectiveOptions] = None):
        [algorithm] = CollectiveOptions.merge(options, algorithm=algorithm)
        return self._run("bcast", algorithm, rank, key, mode,
                         value=value, root=root)

    def reduce(self, value: Any, *, rank: int, op="sum", root: int = 0,
               algorithm: Optional[str] = None, mode: str = "blocking",
               key: Any = None,
               options: Optional[CollectiveOptions] = None):
        [algorithm] = CollectiveOptions.merge(options, algorithm=algorithm)
        return self._run("reduce", algorithm, rank, key, mode,
                         value=as_payload(value), op=_op_fn(op), root=root)

    def allreduce(self, value: Any, *, rank: int, op="sum",
                  algorithm: Optional[str] = None, mode: str = "blocking",
                  key: Any = None, segments: int = 1,
                  hierarchical: Optional[int] = None,
                  options: Optional[CollectiveOptions] = None):
        """``segments > 1`` runs the pipelined ring allreduce (combine of
        segment *k* overlaps transport of segment *k+1*).
        ``hierarchical=intra`` runs the composed two-axis schedule
        (:func:`repro_torch.core.schedule.build_hierarchical` — intra ring
        reduce-scatter, inter doubling, intra ring allgather) with
        ``intra`` consecutive ranks per pod; ``intra`` must divide the
        communicator size."""
        algorithm, segments, hierarchical = CollectiveOptions.merge(
            options, algorithm=algorithm, segments=segments,
            hierarchical=hierarchical)
        if segments > 1:
            algorithm = algorithm or "ring"
            if _norm_alg(algorithm) != "ring":
                raise ValueError("segmented allreduce requires the ring "
                                 "algorithm")
        return self._run("allreduce", algorithm, rank, key, mode,
                         value=as_payload(value), op=_op_fn(op),
                         segments=segments, hierarchical=hierarchical)

    def allgather(self, value: Any, *, rank: int,
                  algorithm: Optional[str] = None, mode: str = "blocking",
                  key: Any = None, segments: int = 1,
                  options: Optional[CollectiveOptions] = None):
        """Returns the list of every rank's contribution, rank order.

        ``segments > 1`` runs the segmented ring (contributions sliced
        into pipelined sub-rings); it requires array payloads of one
        common shape (the MPI uniform-count contract) and returns each
        contribution as an array of that shape."""
        algorithm, segments = CollectiveOptions.merge(
            options, algorithm=algorithm, segments=segments)
        if segments > 1:
            algorithm = algorithm or "ring"
            if _norm_alg(algorithm) != "ring":
                raise ValueError("segmented allgather requires the ring "
                                 "algorithm")
            value = as_payload(value)
        return self._run("allgather", algorithm, rank, key, mode,
                         value=value, segments=segments)

    def reduce_scatter(self, value: Any, *, rank: int, op="sum",
                       algorithm: Optional[str] = None,
                       mode: str = "blocking", key: Any = None,
                       segments: int = 1,
                       options: Optional[CollectiveOptions] = None):
        """Returns this rank's ``np.array_split`` chunk of the flattened
        element-wise reduction.  ``segments > 1`` pipelines the ring
        (combine of segment *k* overlaps transport of segment *k+1*);
        the returned chunk is bit-identical to the unsegmented one."""
        algorithm, segments = CollectiveOptions.merge(
            options, algorithm=algorithm, segments=segments)
        if segments > 1:
            algorithm = algorithm or "ring"
            if _norm_alg(algorithm) != "ring":
                raise ValueError("segmented reduce_scatter requires the "
                                 "ring algorithm")
        return self._run("reduce_scatter", algorithm, rank, key, mode,
                         value=as_payload(value), op=_op_fn(op),
                         segments=segments)

    def alltoall(self, blocks: Sequence[Any], *, rank: int,
                 algorithm: Optional[str] = None, mode: str = "blocking",
                 key: Any = None,
                 options: Optional[CollectiveOptions] = None):
        """``blocks[d]`` goes to rank ``d``; returns blocks received,
        indexed by source rank."""
        [algorithm] = CollectiveOptions.merge(options, algorithm=algorithm)
        blocks = list(blocks)
        if len(blocks) != self.world.size:
            raise ValueError(f"alltoall needs exactly {self.world.size} "
                             f"blocks, got {len(blocks)}")
        return self._run("alltoall", algorithm, rank, key, mode,
                         blocks=blocks)

    # -- neighbourhood collectives (Cartesian communicators) ---------------
    def neighbor_alltoall(self, sends: Dict[Any, Any], *, rank: int,
                          mode: str = "blocking", key: Any = None):
        """Neighbourhood all-to-all (MPI_Neighbor_alltoall).

        Requires a communicator with a Cartesian topology
        (``CommWorld.cart_create``).  ``sends`` maps each of this rank's
        neighbour directions ``(dim, ±1)`` to the payload for the
        neighbour in that direction; the result maps each direction to
        the payload received *from* that neighbour.  Boundary ranks of a
        non-periodic grid simply have fewer directions.
        """
        mode = _norm_mode(mode)
        sched = _neighbor_schedule(self.comm)
        sends = _check_dir_payloads(sends, sched.out_dirs[rank])
        if self.executor == "compiled":
            prog = program_ir.compile_schedule(
                sched, self.comm, head=("coll", "neighbor_alltoall"))
            gen = prog.gen(rank, self._key(rank, key), sends=sends)
        else:
            gen = _interpret(sched, self.comm, rank,
                             self._tagger("neighbor_alltoall", rank, key),
                             sends=sends)
        return _execute_schedule(gen, mode, comm=self.comm)

    # -- persistent collectives (MPI_*_init analogue) ----------------------
    def persistent(self, name: str, *, algorithm: Optional[str] = None,
                   op="sum", root: int = 0, segments: int = 1,
                   options: Optional[CollectiveOptions] = None
                   ) -> "PersistentCollective":
        """Pre-build a collective schedule for repeated posting.

        The ``MPI_Allreduce_init`` analogue made trivial by schedules
        being data: the returned :class:`PersistentCollective` holds the
        resolved schedule/operator and its own tag namespace; each
        :meth:`PersistentCollective.start` re-posts it (per-rank sequence
        numbers keep iterations apart, or pass ``key=iteration``).
        """
        algorithm, segments = CollectiveOptions.merge(
            options, algorithm=algorithm, segments=segments)
        return PersistentCollective(self, name, algorithm=algorithm,
                                    op=op, root=root, segments=segments)

    # -- single-threaded group driver --------------------------------------
    def run_group(self, name: str, per_rank: Sequence[Dict[str, Any]],
                  **common: Any) -> List[Any]:
        """Run one collective for ALL ranks round-robin on this thread.

        The sequential ('pure'/fork-join) execution path and the
        deterministic test driver: no runtime, no threads, no pausing.
        ``per_rank[r]`` holds rank-specific kwargs (e.g. ``value``);
        ``common`` the shared ones (``op``, ``algorithm``, ``key``...).
        Returns the per-rank results in rank order.
        """
        if len(per_rank) != self.world.size:
            raise ValueError(f"need kwargs for all {self.world.size} ranks")
        machines = []
        for r, kw in enumerate(per_rank):
            gen = self._make_gen(name, rank=r, **dict(common, **kw))
            machines.append(_Machine(gen, CollectiveHandle()))
        _drive_group(machines)
        return [m.handle.result for m in machines]

    _GROUP_SPEC = {
        # name -> (accepted kwargs, required kwargs)
        "barrier": (set(), set()),
        "bcast": ({"value", "root"}, set()),
        "reduce": ({"value", "op", "root"}, {"value"}),
        "allreduce": ({"value", "op", "segments", "hierarchical"},
                      {"value"}),
        "allgather": ({"value", "segments"}, {"value"}),
        "reduce_scatter": ({"value", "op", "segments"}, {"value"}),
        "alltoall": ({"blocks"}, {"blocks"}),
    }

    def _make_gen(self, name: str, *, rank: int,
                  algorithm: Optional[str] = None, key: Any = None, **kw):
        if name not in self._GROUP_SPEC:
            raise ValueError(f"unknown collective {name!r}; "
                             f"one of {sorted(self._GROUP_SPEC)}")
        accepted, required = self._GROUP_SPEC[name]
        unknown = set(kw) - accepted
        if unknown:
            # `mode` lands here too: run_group drives all ranks inline.
            raise ValueError(
                f"{name}: unexpected argument(s) {sorted(unknown)}; "
                f"accepted: {sorted(accepted | {'algorithm', 'key'})}")
        missing = required - set(kw)
        if missing:
            raise ValueError(f"{name}: missing argument(s) "
                             f"{sorted(missing)}")
        if name == "barrier":
            return self._schedule(name, algorithm, rank, key)
        if name == "bcast":
            return self._schedule(name, algorithm, rank, key,
                                  value=kw.get("value"),
                                  root=kw.get("root", 0))
        if name == "reduce":
            return self._schedule(name, algorithm, rank, key,
                                  value=as_payload(kw["value"]),
                                  op=_op_fn(kw.get("op", "sum")),
                                  root=kw.get("root", 0))
        if name in ("allreduce", "reduce_scatter"):
            return self._schedule(name, algorithm, rank, key,
                                  value=as_payload(kw["value"]),
                                  op=_op_fn(kw.get("op", "sum")),
                                  segments=kw.get("segments", 1),
                                  hierarchical=kw.get("hierarchical"))
        if name == "allgather":
            value = kw["value"]
            segments = kw.get("segments", 1)
            if segments > 1:
                value = as_payload(value)
            return self._schedule(name, algorithm, rank, key,
                                  value=value, segments=segments)
        blocks = list(kw["blocks"])
        if len(blocks) != self.world.size:
            raise ValueError("alltoall block count != world size")
        return self._schedule(name, algorithm, rank, key, blocks=blocks)


# ---------------------------------------------------------------------------
# Persistent collectives
# ---------------------------------------------------------------------------
_PERSISTENT_IDS = itertools.count()

_REDUCING = {"reduce", "allreduce", "reduce_scatter"}


class PersistentCollective:
    """A pre-built schedule handle, re-postable every iteration.

    The ``MPI_Allreduce_init`` analogue (ROADMAP item 5): the schedule —
    algorithm, segment count, rank programs — is resolved once at
    construction; every :meth:`start` binds fresh payloads and a fresh
    tag context to the same immutable :class:`repro_torch.core.schedule.Schedule`
    and runs it in either interoperability mode.  Iteration isolation
    comes from the per-rank sequence numbers (or an explicit
    ``key=iteration``), exactly like the one-shot collectives.
    """

    def __init__(self, coll: Collectives, name: str, *,
                 algorithm: Optional[str] = None, op="sum", root: int = 0,
                 segments: int = 1) -> None:
        algorithm = _norm_alg(algorithm or _DEFAULT_ALGORITHM[name])
        if algorithm == "auto":
            raise ValueError('algorithm="auto" is not valid for persistent '
                             'collectives (the schedule is fixed at init); '
                             'pick via Collectives.predict or pass '
                             '"ring"/"doubling"')
        self.coll = coll
        self.name = name
        self.sched = schedule_ir.build(name, algorithm, coll.comm.size,
                                       root=root, segments=segments)
        self.op = _op_fn(op) if name in _REDUCING else None
        self._id = next(_PERSISTENT_IDS)
        self._seq = [itertools.count() for _ in range(coll.comm.size)]
        # Per-rank combine-buffer arenas: compiled runs write reduction
        # results into these pre-allocated buffers (ufunc ``out=``)
        # instead of allocating per round, reused across every posting
        # of this plan — the MPI persistent-request buffer registration.
        # Sound because persistent postings are serialised per rank
        # (wait before re-start), which the drivers enforce.
        self._arenas = [dict() for _ in range(coll.comm.size)]
        # The persistent plan (MPI_*_init analogue): under the owner's
        # compiled executor the pre-bound program is resolved once here
        # and re-posted by every start()/run_group() with a fresh tag
        # epoch; the cache makes same-schedule instances share it.
        self._prog = (program_ir.compile_schedule(
            self.sched, coll.comm, op=self.op, head=("pers", self._id))
            if coll.executor == "compiled" else None)

    def _tagger(self, rank: int, key: Any):
        if key is None:
            key = next(self._seq[rank])

        def tag(sub: Any):
            return ("pers", self._id, key, sub)
        return tag

    def _plan(self):
        """The compiled plan, recompiled when the communicator epoch
        moved — a rank failure or revoke invalidated the cached program
        and the first post after recovery rebuilds it automatically
        (:func:`repro_torch.core.program.epoch_of`)."""
        prog = self._prog
        if (prog is not None
                and prog.epoch != program_ir.epoch_of(self.coll.comm)):
            prog = self._prog = program_ir.compile_schedule(
                self.sched, self.coll.comm, op=self.op,
                head=("pers", self._id))
        return prog

    def _gen(self, rank: int, key: Any, value, blocks):
        if not 0 <= rank < self.sched.n:
            raise ValueError(f"rank {rank} out of range for n="
                             f"{self.sched.n}")
        if self.sched.input_kind == "blocks" and blocks is None:
            blocks = list(value) if value is not None else None
        prog = self._plan()
        if prog is not None:
            if key is None:
                key = next(self._seq[rank])
            return prog.gen(rank, key, value=value, blocks=blocks,
                            arena=self._arenas[rank])
        return _interpret(self.sched, self.coll.comm, rank,
                          self._tagger(rank, key), value=value,
                          op=self.op, blocks=blocks)

    def start(self, value: Any = None, *, rank: int,
              mode: str = "blocking", key: Any = None,
              blocks: Optional[Sequence[Any]] = None):
        """Post this rank's pre-built schedule; same mode contract as the
        one-shot collectives."""
        return _execute_schedule(self._gen(rank, key, value, blocks),
                                 _norm_mode(mode), comm=self.coll.comm)

    def run_group(self, per_rank_values: Sequence[Any],
                  key: Any = None) -> List[Any]:
        """All ranks round-robin on the calling thread (test/'pure' path)."""
        if len(per_rank_values) != self.sched.n:
            raise ValueError(f"need values for all {self.sched.n} ranks")
        machines = [_Machine(self._gen(r, key, v, None), CollectiveHandle())
                    for r, v in enumerate(per_rank_values)]
        _drive_group(machines)
        return [m.handle.result for m in machines]

    def cost(self, nbytes: int) -> float:
        """Predicted seconds per posting under the owner's α-β model."""
        return self.sched.cost(self.coll.alpha, self.coll.beta, nbytes,
                               gamma=self.coll.gamma)


# ---------------------------------------------------------------------------
# Neighbourhood collectives: persistent halo exchange
# ---------------------------------------------------------------------------
def _topology_dirs(comm, rank: int):
    neighbor_dirs = getattr(comm, "neighbor_dirs", None)
    if neighbor_dirs is None:
        raise TypeError(
            "neighbourhood collectives need a communicator with a "
            "topology — build a Cartesian one with CommWorld.cart_create "
            "or a graph one with CommWorld.dist_graph_create")
    return tuple(neighbor_dirs(rank))


def _neighbor_schedule(comm) -> Schedule:
    """The neighbourhood schedule of a Cartesian communicator.

    Memoised on the communicator itself (topologies are immutable), so
    per-rank postings don't rebuild/re-hash the O(size) topology tuple;
    ``build_neighbor``'s cache additionally shares one schedule object
    across same-shape grids.
    """
    sched = getattr(comm, "_neighbor_sched", None)
    if sched is None:
        topology = getattr(comm, "topology", None)
        if topology is None:
            raise TypeError(
                "neighbourhood collectives need a communicator with a "
                "topology — build a Cartesian one with CommWorld.cart_create "
                "or a graph one with CommWorld.dist_graph_create")
        # Directed topologies (one-way dist-graph edges) declare their
        # receive directions separately; symmetric ones return None here.
        in_topology = getattr(comm, "in_topology", None)
        in_topo = in_topology() if in_topology is not None else None
        # Call with one arg when symmetric so the lru_cache key matches
        # direct ``build_neighbor(topology())`` calls (shared identity).
        sched = (schedule_ir.build_neighbor(topology(), in_topo)
                 if in_topo is not None
                 else schedule_ir.build_neighbor(topology()))
        comm._neighbor_sched = sched
    return sched


def _check_dir_payloads(sends, dirs):
    """``dirs`` is the rank's direction tuple (``Schedule.out_dirs[r]``)."""
    sends = dict(sends)
    expected = set(dirs)
    if set(sends) != expected:
        raise ValueError(
            f"send payloads must cover exactly this rank's neighbour "
            f"directions {sorted(expected)}, got {sorted(sends)}")
    return sends


_HALO_IDS = itertools.count()


class HaloExchange:
    """Persistent halo exchange over a Cartesian group (paper §7.1 pattern).

    The neighbourhood analogue of MPI's persistent collectives: the
    schedule — one ``Send``/``Recv`` pair per grid edge, from
    :meth:`tac.CartGroup.topology` — is built once at construction
    (:func:`repro_torch.core.schedule.build_neighbor`; grids of equal shape
    share the cached object).  Each :meth:`start` re-posts one rank's
    program through the communicator and runs it in either
    interoperability mode:

    * ``mode="blocking"`` (§6.1) returns ``{direction: halo received from
      that neighbour}``; inside a task the wait pauses (one pause, rounds
      driven by the progress engine).
    * ``mode="event"`` (§6.2, the default — halo exchange exists to be
      overlapped) returns a :class:`CollectiveHandle` immediately and
      binds one event to the calling task; interior compute proceeds
      while the halos fly, boundary compute declares a dependency and
      reads ``handle.result``.

    Stencil codes call one ``start`` per rank per iteration; the implicit
    per-rank sequence numbers keep iterations' tag spaces apart (or pass
    ``key=iteration``).
    """

    def __init__(self, cart, *, executor: str = "compiled") -> None:
        self.executor = _norm_executor(executor)
        self.cart = cart
        self.sched = _neighbor_schedule(cart)
        self.dirs = {r: _topology_dirs(cart, r) for r in range(cart.size)}
        self._seq = [itertools.count() for _ in range(cart.size)]
        self._id = next(_HALO_IDS)
        # The persistent neighbourhood plan: edge peers pre-translated,
        # per-direction tags pre-built; every iteration re-posts it.
        self._prog = (program_ir.compile_schedule(
            self.sched, cart, head=("halo", self._id))
            if self.executor == "compiled" else None)

    def neighbors(self, rank: int):
        """The persistent neighbour list ``[((dim, ±1), neighbour)]``."""
        return self.dirs[rank]

    def _tagger(self, rank: int, key: Any):
        if key is None:
            key = next(self._seq[rank])

        def tag(sub: Any):
            return ("halo", self._id, key, sub)
        return tag

    def _plan(self):
        """The compiled plan, recompiled when the communicator epoch
        moved (automatic rebuild after failure recovery — see
        :meth:`PersistentCollective._plan`)."""
        prog = self._prog
        if (prog is not None
                and prog.epoch != program_ir.epoch_of(self.cart)):
            prog = self._prog = program_ir.compile_schedule(
                self.sched, self.cart, head=("halo", self._id))
        return prog

    def _gen(self, rank: int, key: Any, sends):
        sends = _check_dir_payloads(sends, self.sched.out_dirs[rank])
        prog = self._plan()
        if prog is not None:
            if key is None:
                key = next(self._seq[rank])
            return prog.gen(rank, key, sends=sends)
        return _interpret(self.sched, self.cart, rank,
                          self._tagger(rank, key), sends=sends)

    def start(self, sends: Dict[Any, Any], *, rank: int,
              mode: str = "event", key: Any = None):
        """Post this rank's halo round; see the class docstring for modes."""
        mode = _norm_mode(mode)
        return _execute_schedule(self._gen(rank, key, sends), mode,
                                 comm=self.cart)

    def exchange(self, sends: Dict[Any, Any], *, rank: int,
                 key: Any = None):
        """Blocking convenience: ``start(..., mode="blocking")``."""
        return self.start(sends, rank=rank, mode="blocking", key=key)

    def run_group(self, per_rank_sends: Sequence[Dict[Any, Any]],
                  key: Any = None) -> List[Dict[Any, Any]]:
        """All ranks' rounds round-robin on the calling thread — the
        sequential ('pure'/fork-join) path and the deterministic test
        driver.  Returns the per-rank received-halo dicts."""
        if len(per_rank_sends) != self.cart.size:
            raise ValueError(f"need send dicts for all {self.cart.size} "
                             f"ranks")
        machines = [_Machine(self._gen(r, key, s), CollectiveHandle())
                    for r, s in enumerate(per_rank_sends)]
        _drive_group(machines)
        return [m.handle.result for m in machines]


# ---------------------------------------------------------------------------
# Hierarchical allreduce over nested sub-communicators
# ---------------------------------------------------------------------------
class HierarchicalCollectives:
    """Hierarchical allreduce via two nested groups (ROADMAP item).

    The first consumer of :meth:`tac.CommWorld.split`: construction runs
    the split collective — consecutive ranks share ``color = rank //
    group_size`` — and gathers the per-color *intra* groups plus a
    *leaders* group of each color's rank 0.  An allreduce composes THREE
    schedules from the IR (rank translation via the
    :meth:`tac.CommGroup.group_rank` hooks):

    1. chain-reduce to the local leader inside each intra group (the ring
       family — bandwidth-optimal within a "node"),
    2. recursive-doubling allreduce across the leaders (latency-optimal
       across "nodes", any leader count),
    3. chain-broadcast back down each intra group.

    Works for any world size and ``group_size`` (the last group may be
    smaller).  Both interoperability modes are supported per rank, same
    contract as :class:`Collectives`.
    """

    def __init__(self, world: tac.CommWorld, group_size: int, *,
                 executor: str = "compiled") -> None:
        self.executor = _norm_executor(executor)
        if group_size <= 0:
            raise ValueError(f"group_size must be positive, got "
                             f"{group_size}")
        handles = [world.split(r // group_size, key=r, rank=r)
                   for r in range(world.size)]
        self.world = world
        self.group_size = group_size
        self.intra: List[tac.CommGroup] = [h.result for h in handles]
        # MPI_Group_translate_ranks: each intra group's local rank 0 in
        # the world's numbering (the world's identity group_rank hook
        # makes it a valid translation target like any CommGroup).
        leader_ranks = sorted({r for g in self.intra
                               for r in g.translate_many([0], world)})
        self.leaders = world.group(leader_ranks)
        self._seq = [itertools.count() for _ in range(world.size)]
        # The composed single-schedule form: ONE flat IR object
        # (reduce-scatter / inter-allreduce / allgather over the
        # (inter × intra) rank grid) that the Level-B lowering emits over
        # two mesh axes — available when every intra group is full.
        self.sched: Optional[Schedule] = (
            schedule_ir.build_hierarchical(group_size,
                                           world.size // group_size)
            if world.size % group_size == 0 else None)

    def _schedule(self, rank: int, key: Any, value, op):
        intra = self.intra[rank]
        lr = intra.group_rank(rank)
        if key is None:
            key = next(self._seq[rank])

        # Stage tags are ("hier", stage, key, sub) — the uniform
        # family-head + (epoch, transfer) shape every collective uses, so
        # the compiled executor's pre-built templates (head=("hier",
        # stage)) and the interpreter produce identical wire tags.
        reduce_s = schedule_ir.build("reduce", "ring", intra.size)
        leaders_s = schedule_ir.build("allreduce", "doubling",
                                      self.leaders.size)
        bcast_s = schedule_ir.build("bcast", "ring", intra.size)

        if self.executor == "compiled":
            # Per-color intra groups are shared objects, so every member
            # of a pod (and every iteration) hits the same cached plans.
            stage = [
                program_ir.compile_schedule(reduce_s, intra, op=op,
                                            head=("hier", "reduce")),
                program_ir.compile_schedule(leaders_s, self.leaders, op=op,
                                            head=("hier", "leaders")),
                program_ir.compile_schedule(bcast_s, intra,
                                            head=("hier", "bcast")),
            ]

            def gen():
                acc = yield from stage[0].gen(lr, key,
                                              value=as_payload(value))
                if lr == 0:
                    li = intra.translate(0, self.leaders)
                    acc = yield from stage[1].gen(li, key, value=acc)
                result = yield from stage[2].gen(lr, key, value=acc)
                return result
            return gen()

        def tag(stage):
            return lambda sub: ("hier", stage, key, sub)

        def gen():
            acc = yield from _interpret(reduce_s, intra, lr,
                                        tag("reduce"),
                                        value=as_payload(value), op=op)
            if lr == 0:
                # rank translation across the nested groups: this rank is
                # intra-local 0; its leaders-local number comes from
                # MPI_Group_translate_ranks, not arithmetic.
                li = intra.translate(0, self.leaders)
                acc = yield from _interpret(leaders_s, self.leaders, li,
                                            tag("leaders"), value=acc,
                                            op=op)
            result = yield from _interpret(bcast_s, intra, lr,
                                           tag("bcast"), value=acc)
            return result
        return gen()

    def _composed_gen(self, rank: int, key: Any, value, op):
        if self.sched is None:
            raise ValueError(
                f"composed hierarchical schedule needs equal intra groups "
                f"(world size {self.world.size} % group_size "
                f"{self.group_size} != 0)")
        if key is None:
            key = next(self._seq[rank])
        if self.executor == "compiled":
            prog = program_ir.compile_schedule(self.sched, self.world,
                                               op=op,
                                               head=("hier-composed",))
            return prog.gen(rank, key, value=as_payload(value))

        def tag(sub):
            return ("hier-composed", key, sub)
        return _interpret(self.sched, self.world, rank, tag,
                          value=as_payload(value), op=op)

    def allreduce(self, value, *, rank: int, op="sum",
                  mode: str = "blocking", key: Any = None,
                  composed: bool = False):
        """``composed=True`` interprets the single flat
        :func:`repro_torch.core.schedule.build_hierarchical` schedule over the
        world communicator — the same IR object the Level-B lowering
        emits over two mesh axes — instead of the three per-group
        schedules with rank translation.  Results agree; the composed
        form exists so one schedule instance spans both executors."""
        mode = _norm_mode(mode)
        op = _op_fn(op)
        self.world.world_rank(rank)   # identity hook: validates the rank
        gen = (self._composed_gen(rank, key, value, op) if composed
               else self._schedule(rank, key, value, op))
        return _execute_schedule(gen, mode, comm=self.world)

    def persistent(self, *, op="sum") -> "PersistentHierarchical":
        """Pre-resolve the three-stage composition for per-iteration
        re-posting (the Gauss–Seidel residual's shape)."""
        return PersistentHierarchical(self, _op_fn(op))

    def run_group(self, values: Sequence[Any], *, op="sum",
                  key: Any = None, composed: bool = False) -> List[Any]:
        """Sequential driver: all ranks round-robin on this thread."""
        if len(values) != self.world.size:
            raise ValueError(f"need values for all {self.world.size} ranks")
        op = _op_fn(op)
        make = self._composed_gen if composed else self._schedule
        machines = [_Machine(make(r, key, v, op), CollectiveHandle())
                    for r, v in enumerate(values)]
        _drive_group(machines)
        return [m.handle.result for m in machines]

    def n_rounds(self) -> int:
        """Critical-path rounds: intra chain-reduce + leader doubling +
        intra chain-broadcast (the simulator's latency model)."""
        deepest = max(g.size for g in self.intra)
        return (2 * (deepest - 1)
                + n_rounds("allreduce", "doubling", self.leaders.size))

    def cost(self, alpha: float, beta: float, nbytes: int, *,
             gamma: float = 0.0) -> float:
        """α-β predicted seconds: the three stage costs on the critical
        path (deepest intra group; payload does not shrink)."""
        deepest = max(g.size for g in self.intra)
        stages = (schedule_ir.build("reduce", "ring", deepest),
                  schedule_ir.build("allreduce", "doubling",
                                    self.leaders.size),
                  schedule_ir.build("bcast", "ring", deepest))
        return sum(s.cost(alpha, beta, nbytes, gamma=gamma)
                   for s in stages)


class PersistentHierarchical:
    """Persistent handle over :class:`HierarchicalCollectives` — the
    residual-allreduce shape posted once per solver iteration."""

    def __init__(self, hier: HierarchicalCollectives, op: Callable) -> None:
        self.hier = hier
        self.op = op
        self._id = next(_PERSISTENT_IDS)
        self._seq = [itertools.count() for _ in range(hier.world.size)]
        self._group_seq = itertools.count()

    def start(self, value: Any, *, rank: int, mode: str = "blocking",
              key: Any = None):
        """Post one rank's residual round.  Implicit keys come from
        per-rank counters (aligned as long as every rank posts the same
        sequence — MPI's rule); group-driver postings use a disjoint
        ``("g", n)`` namespace, so the two entry points never collide."""
        if key is None:
            key = ("r", next(self._seq[rank]))
        return self.hier.allreduce(value, rank=rank, op=self.op,
                                   mode=mode,
                                   key=("pers-hier", self._id, key))

    def run_group(self, values: Sequence[Any],
                  key: Any = None) -> List[Any]:
        if key is None:
            key = ("g", next(self._group_seq))
        return self.hier.run_group(values, op=self.op,
                                   key=("pers-hier", self._id, key))

    def cost(self, alpha: float, beta: float, nbytes: int, *,
             gamma: float = 0.0) -> float:
        return self.hier.cost(alpha, beta, nbytes, gamma=gamma)
