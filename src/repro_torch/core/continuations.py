"""Continuation-based completion notification (poll-free progress).

The polling registry (paper §4.2/§4.5) drives completion by *re-testing*
every in-flight operation each tick — O(in-flight ops) work per poll even
when nothing completed.  Two follow-on papers eliminate that overhead:

* *Callback-based Completion Notification using MPI Continuations*
  (Schuchart et al., EuroMPI'20): attach a callback to one request or a
  set of requests; the library invokes it **once**, at completion time,
  and the continuation request is itself testable/waitable so
  continuations chain.
* *MPI Progress For All* (Zhou et al.): completion work is executed by
  whichever thread is making progress — a dedicated progress thread or
  an otherwise-idle worker — from bounded completion queues, not by the
  operation's poster.

This module is that notification engine for the host runtime:

* :meth:`ContinuationEngine.attach(handles, callback)` registers a
  callback on one handle or a set of handles.  Handles that support
  **push** notification (anything with an ``on_complete`` method —
  :class:`repro_torch.core.tac.EventHandle` and all its subclasses, including
  every CommWorld send/recv handle and :class:`CollectiveHandle`;
  :class:`repro_torch.core.tac.FutureHandle` via
  ``Future.add_done_callback``) notify the engine *at match time*: zero
  tests ever run for them.  Handles without a hook (e.g. the CUDA-event
  :class:`~repro_torch.core.tac.ArrayHandle`) fall back to the engine's
  poll list — the only place the engine still tests anything.

* Completion does **not** run the callback inline on the completing
  thread (which may hold communicator locks); the ready record is pushed
  onto a **bounded completion queue** and dispatched either by the
  dedicated poller (the engine registers ONE polling service total — not
  one per operation) or opportunistically by idle workers and at the
  runtime's scheduling points (:class:`repro_torch.core.executor.TaskRuntime`
  drains the queue in ``submit``/``taskwait``).  When the queue is full
  the completing thread dispatches the overflowing record inline — the
  back-pressure discipline of the Continuations paper's bounded queues.

* :meth:`attach` returns a :class:`Continuation` — itself a
  testable/waitable ``AsyncHandle`` that completes once the callback has
  run, so continuations chain (``attach(prev_continuation, next_cb)``)
  and task-aware waits (:func:`repro_torch.core.tac.wait` /
  :func:`~repro_torch.core.tac.iwait`) accept one anywhere they accept an
  operation handle.

The engine keeps honest counters (``stats``): with N in-flight
event-bound operations the continuation path performs **O(completions)**
callback dispatches, where the polling path performs **O(in-flight ×
ticks)** tests — the scaling claim `benchmarks/overlap_bench.py`
measures and `tests/test_continuations.py` asserts.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..obs import trace as _tr
from ..obs.registry import REGISTRY as _REGISTRY
from ..obs.registry import Counter as _Counter

__all__ = ["PushCompletion", "Continuation", "ContinuationEngine"]


class PushCompletion:
    """Fire-once completion event with **push** callbacks.

    The shared machinery behind every push-capable handle
    (:class:`repro_torch.core.tac.EventHandle` and :class:`Continuation`):
    :meth:`on_complete` registers a callback that fires exactly once, at
    completion time — immediately when already complete.  Subclasses
    complete through :meth:`_complete_once`, whose ``assign`` hook sets
    their result fields *under the same lock* that publishes the event,
    so a racing ``on_complete`` can never observe a set event with
    unassigned results.  Completion is idempotent: the first completion
    wins and fires the callbacks exactly once.
    """

    def __init__(self) -> None:
        self._done = False
        self._cbs: List[Callable] = []
        self._cb_lock = threading.Lock()
        # The OS-level waiter event is built lazily (_wait_event): handle
        # creation is on the critical path of every transfer, and under
        # eager matching / push notification most handles complete
        # without anybody ever blocking on them — a ~µs Event+Condition
        # allocation per handle for nothing, measurable at collective
        # scale (O(n²) handles per allreduce).
        self._waiter: Optional[threading.Event] = None

    def test(self) -> bool:
        return self._done

    def _wait_event(self) -> threading.Event:
        """The blocking-wait event, created on first demand."""
        with self._cb_lock:
            ev = self._waiter
            if ev is None:
                ev = self._waiter = threading.Event()
                if self._done:
                    ev.set()
        return ev

    def on_complete(self, cb: Callable[[Any], None]) -> None:
        """Invoke ``cb(self)`` at completion (immediately if complete)."""
        with self._cb_lock:
            if not self._done:
                self._cbs.append(cb)
                return
        cb(self)

    def _complete_once(self, assign: Callable[[], None]) -> None:
        with self._cb_lock:
            if self._done:
                return
            assign()
            self._done = True
            if self._waiter is not None:
                self._waiter.set()
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            cb(self)


class Continuation(PushCompletion):
    """Completion handle of one attached callback (testable/waitable).

    Mirrors the :class:`repro_torch.core.tac.AsyncHandle` protocol — ``test``,
    ``wait``, ``result`` — plus the ``on_complete`` push hook, so a
    continuation can be waited on task-aware, bound to an event counter,
    or itself continued (chaining).  ``result`` is the attached handle's
    result (a list, in attachment order, when several handles were
    attached); a raising callback stores its exception in ``error`` and
    ``result`` re-raises it on the consumer.
    """

    def __init__(self) -> None:
        super().__init__()
        self._result: Any = None
        self.error: Optional[BaseException] = None

    def wait(self) -> Any:
        self._wait_event().wait()
        return self.result

    @property
    def result(self) -> Any:
        if self.error is not None:
            raise self.error
        return self._result

    def _fire(self, result: Any, error: Optional[BaseException]) -> None:
        def assign() -> None:
            self._result = result
            self.error = error
        self._complete_once(assign)


class _Pending:
    """One attach(): handles still in flight + the callback to dispatch."""

    __slots__ = ("handles", "callback", "continuation", "_remaining",
                 "_lock", "_ready_at")

    def __init__(self, handles: List[Any], callback: Callable[[], Any],
                 continuation: Continuation) -> None:
        self.handles = handles
        self.callback = callback
        self.continuation = continuation
        self._remaining = len(handles)
        self._lock = threading.Lock()
        self._ready_at: Optional[float] = None  # queue time (tracing only)

    def _arrived(self) -> bool:
        """Count one handle completion; True when the set is complete."""
        with self._lock:
            self._remaining -= 1
            return self._remaining == 0


class ContinuationEngine:
    """Completion queues + dispatch for attached callbacks.

    One engine serves a whole runtime through a single registered polling
    service (:meth:`service`); operations never register services of
    their own.  Push-capable handles cost zero tests; push-less handles
    are polled from the engine's fallback list.  ``stats`` counts:

    * ``attached``     — :meth:`attach` calls,
    * ``completions``  — attachment sets that became ready,
    * ``dispatches``   — callbacks run (== completions, eventually),
    * ``inline_dispatches`` — dispatches run by the completing thread
      because the bounded queue was full (subset of ``dispatches``),
    * ``tests``        — poll-fallback handle tests (0 when every handle
      pushes),
    * ``callback_errors`` — callbacks that raised (error captured on the
      continuation, never on the dispatching thread).

    ``stats`` is a property assembling a fresh dict from **striped
    per-thread counters** (:class:`repro_torch.obs.registry.Counter`): the
    engine lock used to be taken for every single increment — one lock
    round-trip per attach, per completion, and per dispatch on the
    hottest path in the runtime — whereas a striped cell increment is
    lock-free after a thread's first touch.  Totals stay exact
    (``tests/test_continuations.py`` reconciles them against ground
    truth after multi-threaded runs); only inter-counter ordering is
    relaxed, so a mid-flight snapshot may transiently show
    ``dispatches < completions``.

    ``push=False`` is the **legacy polling compatibility mode**: every
    attached handle — push-capable or not — rides the fallback poll list
    and is re-``test``-ed per service tick, reproducing the retired TAC
    ticket pool's O(in-flight × ticks) behaviour on the engine's own
    queue/dispatch path.  ``TaskRuntime(notify="polling")`` builds its
    engine this way, so the continuation engine is the ONE completion
    dispatcher under either backend and only the notification *discipline*
    (push at match time vs re-test per tick) differs.
    """

    def __init__(self, *, queue_capacity: int = 1024,
                 push: bool = True) -> None:
        if queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1, got "
                             f"{queue_capacity}")
        self.queue_capacity = queue_capacity
        self.push = push
        self._lock = threading.Lock()
        self._queue: collections.deque = collections.deque()
        self._polled: List[tuple] = []      # (handle, _Pending) fallbacks
        # Pre-bound striped counters: the emit site is one bound-method
        # call on a lock-free cell, not a dict update under self._lock.
        self._n_attached = _Counter("attached")
        self._n_completions = _Counter("completions")
        self._n_dispatches = _Counter("dispatches")
        self._n_inline = _Counter("inline_dispatches")
        self._n_tests = _Counter("tests")
        self._n_cb_errors = _Counter("callback_errors")

    @property
    def stats(self) -> Dict[str, int]:
        """Exact counter totals, assembled fresh per read."""
        return {"attached": self._n_attached.value,
                "completions": self._n_completions.value,
                "dispatches": self._n_dispatches.value,
                "inline_dispatches": self._n_inline.value,
                "tests": self._n_tests.value,
                "callback_errors": self._n_cb_errors.value}

    # -- the user-facing API ------------------------------------------------
    def attach(self, handles: Any,
               callback: Callable[[], Any]) -> Continuation:
        """Attach ``callback`` to one handle or a set of handles.

        The callback takes no arguments (close over what you need) and
        runs exactly once, after **all** attached handles completed — on
        a dispatching thread (poller, idle worker, or a scheduling
        point), not on the completing one.  Returns the
        :class:`Continuation`, complete once the callback ran.
        """
        if isinstance(handles, (list, tuple)):
            hs = list(handles)
        else:
            hs = [handles]
        if not hs:
            raise ValueError("attach() needs at least one handle")
        rec = _Pending(hs, callback, Continuation())
        self._n_attached.inc()
        if _tr.TRACING:
            _tr.TRACER.instant("continuation", "attach", n_handles=len(hs))
        for h in hs:
            push = getattr(h, "on_complete", None) if self.push else None
            if callable(push):
                # Push path: the handle calls back at match time — this
                # operation is never tested again.
                push(lambda _h, rec=rec: self._arrived(rec))
            else:
                with self._lock:
                    self._polled.append((h, rec))
        return rec.continuation

    # -- completion ---------------------------------------------------------
    def _arrived(self, rec: _Pending) -> None:
        if not rec._arrived():
            return
        self._n_completions.inc()
        inline = False
        if _tr.TRACING:
            rec._ready_at = time.monotonic()
        with self._lock:
            if len(self._queue) >= self.queue_capacity:
                inline = True           # bounded queue full: run it here
            else:
                self._queue.append(rec)
                if _tr.TRACING:
                    _REGISTRY.gauge("continuation.queued").set(
                        len(self._queue))
        if inline:
            self._n_inline.inc()
            self._run(rec)

    def _run(self, rec: _Pending) -> None:
        self._n_dispatches.inc()
        if _tr.TRACING:
            _tr.TRACER.instant("continuation", "dispatch")
            if rec._ready_at is not None:
                # Queue->callback latency: the per-completion dispatch
                # term of simulate.progress_cost, measured.
                _REGISTRY.histogram(
                    "continuation.dispatch_latency_s").observe(
                        time.monotonic() - rec._ready_at)
        try:
            rec.callback()
        except Exception as exc:
            # A raising callback must not kill the dispatching thread —
            # but its continuation may be unreferenced (the wait/iwait
            # wiring discards it), so ALSO report loudly: a swallowed
            # unblock/decrease failure would otherwise hang taskwait
            # with no trace.  KeyboardInterrupt/SystemExit propagate.
            self._n_cb_errors.inc()
            traceback.print_exc()
            print("continuation callback failed (error stored on the "
                  "continuation; see traceback above)", file=sys.stderr)
            rec.continuation._fire(None, exc)
            return
        try:
            # A handle's `result` may itself re-raise (a failed
            # CollectiveHandle, a FutureHandle whose future errored);
            # that is consumer-visible by design — store it quietly, the
            # continuation's reader re-raises it.
            results = [getattr(h, "result", None) for h in rec.handles]
        except Exception as exc:
            self._n_cb_errors.inc()
            rec.continuation._fire(None, exc)
            return
        rec.continuation._fire(
            results[0] if len(results) == 1 else results, None)

    # -- dispatch -----------------------------------------------------------
    def dispatch(self, max_items: Optional[int] = None) -> int:
        """Drain the completion queue; returns #callbacks run.

        Callbacks may themselves complete further handles (a progress
        cascade); those land back on the queue and are drained in the
        same call — total work stays O(completions).
        """
        n = 0
        while max_items is None or n < max_items:
            with self._lock:
                if not self._queue:
                    break
                rec = self._queue.popleft()
            self._run(rec)
            n += 1
        return n

    def service(self, _data: Any = None) -> bool:
        """The ONE polling service: test fallbacks, drain the queue."""
        with self._lock:
            snapshot = list(self._polled)
        if snapshot:
            self._n_tests.inc(len(snapshot))
            done = [item for item in snapshot if item[0].test()]
            if done:
                done_ids = {id(item) for item in done}
                with self._lock:
                    self._polled = [p for p in self._polled
                                    if id(p) not in done_ids]
                for _, rec in done:
                    self._arrived(rec)
        self.dispatch()
        return False                    # stay registered

    # -- introspection ------------------------------------------------------
    @property
    def queued(self) -> int:
        """Ready records awaiting dispatch."""
        with self._lock:
            return len(self._queue)

    @property
    def polled(self) -> int:
        """Push-less handles on the fallback poll list."""
        with self._lock:
            return len(self._polled)
