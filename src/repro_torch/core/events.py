"""Blocking contexts and event counters (paper §4.1 and §4.3).

This module implements the two generic runtime APIs that the paper proposes
for integrating blocking and non-blocking operations with a task-based
runtime:

* the *pause/resume* API — ``get_current_blocking_context`` /
  ``block_current_task`` / ``unblock_task`` (paper §4.1, Fig. 1); and
* the *external events* API — ``get_current_event_counter`` /
  ``increase_current_task_event_counter`` / ``decrease_task_event_counter``
  (paper §4.3, Fig. 2).

The semantics follow the paper exactly:

* A :class:`BlockingContext` is valid for **one** pause/resume round trip and
  requesting a new context invalidates the currently active one (§4.1).
* A task's event counter is initialised to **1** to prevent the release of
  dependencies while the task is running (§4.6).  The task itself is the only
  party allowed to *increase* its counter; anybody may *decrease* it.  The
  runtime releases the task's dependencies when the counter reaches zero,
  which happens either when the task finishes execution (the implicit
  decrease of the initial 1) or later, when the last bound external event is
  fulfilled.
"""

from __future__ import annotations

import threading
from typing import Optional, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from .taskgraph import Task
    from .executor import TaskRuntime


class _CurrentTask(threading.local):
    """Thread-local binding of the task currently executing on this thread."""

    def __init__(self) -> None:
        self.task: Optional["Task"] = None


_current = _CurrentTask()


def set_current_task(task: Optional["Task"]) -> None:
    _current.task = task


def current_task() -> Optional["Task"]:
    """The task bound to the calling thread, or ``None`` outside task code."""
    return _current.task


class BlockingContext:
    """Opaque handle for one pause/resume cycle of a task (paper §4.1).

    Created through :func:`get_current_blocking_context`.  The context wraps a
    ``threading.Event``: :func:`block_current_task` parks the executing thread
    on it after notifying the runtime (so the runtime can hand the core to
    another task), and :func:`unblock_task` — callable from *any* thread —
    sets it.
    """

    __slots__ = ("_task", "_runtime", "_event", "_used", "_valid")

    def __init__(self, task: "Task", runtime: "TaskRuntime") -> None:
        self._task = task
        self._runtime = runtime
        self._event = threading.Event()
        self._used = False
        self._valid = True

    @property
    def task(self) -> "Task":
        return self._task

    def _invalidate(self) -> None:
        self._valid = False


def get_current_blocking_context() -> BlockingContext:
    """Return a fresh blocking context for the invoking task (paper §4.1).

    Requesting a new context invalidates the previously active one.  Must be
    called from inside a task.
    """
    task = current_task()
    if task is None:
        raise RuntimeError(
            "get_current_blocking_context() called from outside a task")
    prev = task._blocking_context
    if prev is not None:
        prev._invalidate()
    ctx = BlockingContext(task, task._runtime)
    task._blocking_context = ctx
    return ctx


def block_current_task(blocking_ctx: BlockingContext) -> None:
    """Suspend the invoking task (paper §4.1).

    The runtime is notified *before* parking, so it can schedule another
    ready task on the core that would otherwise idle (§4.4: the blocking call
    forces a scheduling point).  The call returns once some other thread has
    invoked :func:`unblock_task` on the same context.
    """
    task = current_task()
    if task is None or blocking_ctx._task is not task:
        raise RuntimeError("block_current_task: the argument must be the "
                           "current blocking context of the invoking task")
    if not blocking_ctx._valid or blocking_ctx._used:
        raise RuntimeError("block_current_task: stale blocking context "
                           "(contexts are valid for one pause/resume cycle)")
    blocking_ctx._used = True
    blocking_ctx._runtime._block_task(blocking_ctx)


def unblock_task(blocking_ctx: BlockingContext) -> None:
    """Mark the task bound to ``blocking_ctx`` as resumable (paper §4.1).

    Callable from any thread (e.g. a polling service).  Following §4.4 the
    task is "sent back to the scheduler": here the parked thread wakes and
    contends for a core slot with the regular workers.
    """
    blocking_ctx._runtime._on_task_unblock(blocking_ctx._task)
    blocking_ctx._event.set()


class EventCounter:
    """Per-task atomic counter gating dependency release (paper §4.3, §4.6).

    Initialised to 1.  ``decrease`` to zero triggers
    ``runtime._release_task``: the dependencies of the owning task are
    released, making successor tasks ready.
    """

    __slots__ = ("_task", "_runtime", "_lock", "_count", "_released")

    def __init__(self, task: "Task", runtime: "TaskRuntime") -> None:
        self._task = task
        self._runtime = runtime
        self._lock = threading.Lock()
        self._count = 1  # §4.6: starts at 1 while the task is running.
        self._released = False

    @property
    def task(self) -> "Task":
        return self._task

    @property
    def value(self) -> int:
        with self._lock:
            return self._count

    def _increase(self, increment: int) -> None:
        if increment < 0:
            raise ValueError("increment must be non-negative")
        with self._lock:
            if self._count <= 0:
                raise RuntimeError("event counter already released")
            self._count += increment

    def _decrease(self, decrement: int) -> None:
        if decrement < 0:
            raise ValueError("decrement must be non-negative")
        release = False
        with self._lock:
            if decrement > self._count:
                raise RuntimeError(
                    f"event counter underflow ({self._count} - {decrement})")
            self._count -= decrement
            if self._count == 0 and not self._released:
                self._released = True
                release = True
        if release:
            self._runtime._release_task(self._task)


def get_current_event_counter() -> EventCounter:
    """Return the event counter of the invoking task (paper §4.3)."""
    task = current_task()
    if task is None:
        raise RuntimeError(
            "get_current_event_counter() called from outside a task")
    return task._event_counter


def increase_current_task_event_counter(event_counter: EventCounter,
                                        increment: int = 1) -> None:
    """Bind ``increment`` new external events to the *invoking* task (§4.3).

    Only the task itself may increase its own counter — enforced.
    """
    task = current_task()
    if task is None or event_counter._task is not task:
        raise RuntimeError(
            "increase_current_task_event_counter: only the owning task may "
            "bind new external events (paper §4.3)")
    event_counter._increase(increment)


def decrease_task_event_counter(event_counter: EventCounter,
                                decrement: int = 1) -> None:
    """Fulfil ``decrement`` external events of a (possibly finished) task.

    May be invoked from any thread (paper §4.3, Fig. 2b).  If this drops the
    counter to zero the runtime releases the task's dependencies.
    """
    event_counter._decrease(decrement)
