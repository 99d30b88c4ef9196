"""The task runtime: scheduling, pause/resume, dependency release.

Implements the runtime side of the paper's two APIs on a pool of worker
threads:

* **Pause/resume** (§4.1, §4.4): when a task blocks, the scheduling point is
  honoured by handing the core to another ready task.  Two strategies are
  provided:

  - ``block_mode="spare-thread"`` (default, what Nanos6 does): the blocked
    task's thread parks and, if that would leave fewer than ``num_workers``
    runnable threads, a *spare* worker thread is spawned.  This matches the
    paper's observation that the blocking mode creates "a number of threads
    (and stacks) proportional to the number of in-flight MPI operations"
    (§9) — an overhead the non-blocking mode avoids.

  - ``block_mode="nested"``: the blocked task's thread executes other ready
    tasks *nested on its own stack* until its context is unblocked.  No
    extra threads; used to demonstrate that §5's deadlock is resolved even
    with a single worker.

* **External events** (§4.3, §4.6): every task owns an
  :class:`~repro_torch.core.events.EventCounter` initialised to 1; the implicit
  unit is decremented when the body finishes; dependency release happens at
  zero.  Tasks that bound external events therefore release their
  dependencies from the *polling service* thread that fulfils the last
  event — the runtime is fully re-entrant for that path.

* **Polling services** (§4.2, §4.5): a dedicated management thread serves
  callbacks every ``poll_interval`` seconds and idle workers serve them
  before going to sleep.

Additional production features beyond the paper:

* **Straggler mitigation**: tasks flagged ``idempotent=True`` are eligible
  for speculative re-execution when they exceed ``speculative_timeout``;
  the first completion wins.
* **Statistics** used by the benchmarks: threads spawned, block/unblock
  round-trips, tasks executed — the cost drivers behind the paper's
  blocking vs non-blocking comparison (Figs. 12–13).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import registry as _reg
from ..obs import trace as _tr
from . import events as _ev
from .continuations import ContinuationEngine
from .events import BlockingContext, set_current_task, current_task
from .polling import PollingRegistry
from .taskgraph import (Task, TaskGraph, CREATED, READY, RUNNING, BLOCKED,
                        FINISHED, RELEASED)

NOTIFY_BACKENDS = ("polling", "continuation")


class TaskError(RuntimeError):
    """Raised by :meth:`TaskRuntime.taskwait` when a task body failed."""

    def __init__(self, task: Task, error: BaseException) -> None:
        super().__init__(f"task {task.name!r} (#{task.id}) failed: {error!r}")
        self.task = task
        self.error = error


class TaskRuntime:
    """A task-based runtime with data-flow dependencies (OmpSs-2 style)."""

    def __init__(self, num_workers: int = 4, *,
                 poll_interval: float = 0.001,
                 block_mode: str = "spare-thread",
                 max_threads: Optional[int] = None,
                 speculative_timeout: Optional[float] = None,
                 notify: Optional[str] = None) -> None:
        if block_mode not in ("spare-thread", "nested"):
            raise ValueError(f"unknown block_mode {block_mode!r}")
        if notify is None:
            # Continuation notification is the default (O(completions)
            # dispatches; ROADMAP carry-over after the CI soak); the env
            # override lets the whole tier-1 suite run under either
            # backend unchanged (CI exercises REPRO_NOTIFY=polling to
            # keep the legacy backend covered).
            notify = os.environ.get("REPRO_NOTIFY") or "continuation"
        if notify not in NOTIFY_BACKENDS:
            raise ValueError(f"unknown notify backend {notify!r}; "
                             f"one of {NOTIFY_BACKENDS}")
        self.num_workers = num_workers
        self.block_mode = block_mode
        self.notify = notify
        self.poll_interval = poll_interval
        self.max_threads = max_threads or num_workers + 512
        self.speculative_timeout = speculative_timeout

        self.graph = TaskGraph()
        self.polling = PollingRegistry(interval=poll_interval)
        self.stats: Dict[str, int] = collections.defaultdict(int)

        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._ready: collections.deque[Task] = collections.deque()
        self._threads: List[threading.Thread] = []
        self._live_threads = 0
        self._blocked_threads = 0
        self._unreleased = 0
        self._errors: List[TaskError] = []
        self._shutdown = False
        self._started = False
        self._continuations: Optional[ContinuationEngine] = None
        self._registered_services: List[Tuple[str, Callable, Any]] = []

    # -- polling-service bookkeeping ---------------------------------------
    def _register_service(self, name: str, fn: Callable,
                          data: Any = None) -> None:
        """Register a polling service AND remember it, so :meth:`close`
        can unregister deterministically — a failed collective or a
        restarted runtime must not leave services behind (asserted by
        the tier-1 stress tests)."""
        with self._lock:
            self._registered_services.append((name, fn, data))
        self.polling.register_polling_service(name, fn, data)

    @property
    def continuations(self) -> ContinuationEngine:
        """The runtime's completion-notification engine (lazy).

        One engine — and ONE registered polling service — per runtime:
        the ONLY completion dispatcher behind
        :func:`repro_torch.core.tac.wait`/``iwait``/``iwaitall`` and the
        collectives :class:`~repro_torch.core.collectives.ProgressEngine`
        (the legacy TAC ticket pool was folded into it).  Under
        ``notify="continuation"`` push-capable handles notify at match
        time; under ``notify="polling"`` the SAME engine runs in its
        compatibility mode (``push=False``): every handle rides the
        fallback poll list and is re-tested per tick, preserving the
        paper's §4.2 polling discipline.  Ready callbacks are dispatched
        by the dedicated poller, by idle workers (§4.5), and at the
        scheduling points (``submit``/``taskwait``) which drain the
        bounded completion queue.
        """
        eng = self._continuations
        if eng is None:
            with self._lock:
                eng = self._continuations
                if eng is None:
                    eng = ContinuationEngine(
                        push=(self.notify == "continuation"))
                    self._register_service("continuation engine",
                                           eng.service)
                    self._continuations = eng
        return eng

    def _drain_continuations(self) -> None:
        eng = self._continuations
        if eng is not None:
            eng.dispatch()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._cv:
            if self._started:
                return
            self._started = True
            for _ in range(self.num_workers):
                self._spawn_worker_locked()
        self.polling.start()
        if self.speculative_timeout is not None:
            self._register_service("straggler-watch",
                                   self._straggler_service)

    def close(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        for t in list(self._threads):
            t.join(timeout=5.0)
        # Deterministic teardown: every service this runtime registered
        # (collective progress engine, continuation engine, straggler
        # watch) is unregistered — including after failed machines — so
        # nothing stays registered forever.
        with self._lock:
            services, self._registered_services = \
                self._registered_services, []
        for name, fn, data in services:
            self.polling.unregister_polling_service(name, fn, data)
        self._drain_continuations()   # callbacks queued after last poll
        self.polling.stop()

    def __enter__(self) -> "TaskRuntime":
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            if exc_type is None:
                self.taskwait()
        finally:
            self.close()

    # -- submission --------------------------------------------------------
    def submit(self, fn: Callable[..., Any], *args: Any,
               in_: Sequence[Any] = (), out: Sequence[Any] = (),
               inout: Sequence[Any] = (), name: Optional[str] = None,
               cost: float = 1.0, idempotent: bool = False,
               label: Optional[str] = None, rank: Optional[int] = None,
               **kwargs: Any) -> Task:
        """Create and submit a task.  Dependencies follow submission order.

        ``rank`` optionally attributes the task to a logical rank for
        trace/straggler accounting (:mod:`repro_torch.obs`); it does not affect
        scheduling.
        """
        if not self._started:
            self.start()
        task = Task(fn, args, kwargs, name=name, runtime=self, cost=cost,
                    idempotent=idempotent, label=label, rank=rank)
        with self._cv:
            self._unreleased += 1
        if _tr.TRACING:
            _tr.TRACER.instant("task", "submit", rank=task.rank,
                               task=task.name)
        ready = self.graph.register(task, in_, out, inout)
        if ready:
            self._enqueue(task)
        # Task creation is a scheduling point (§4.4): serve any ready
        # continuation callbacks opportunistically on this thread.
        self._drain_continuations()
        return task

    # alias mirroring `#pragma oss task`
    task = submit

    def taskwait(self, handles: Sequence[Any] = ()) -> None:
        """Block until every submitted task has *released* its dependencies.

        Like ``#pragma oss taskwait`` this also waits for external events —
        a communication task only counts once its bound operations finished.
        ``handles`` optionally names extra in-flight operations to wait
        for as well: anything :func:`repro_torch.core.tac.as_handle` accepts
        (the same :class:`~repro_torch.core.tac.AsyncHandle` protocol the
        ``tac.wait`` family consumes), each waited with its OS-level
        ``wait()`` after the task graph drained.
        """
        if current_task() is not None:
            raise RuntimeError("taskwait() from inside a task is not "
                               "supported; use dependencies instead")
        while True:
            with self._cv:
                if self._unreleased <= 0:
                    break
                self._cv.wait(timeout=0.05)
            # taskwait is a scheduling point: drain ready continuations
            # so completion never waits on the dedicated poller alone.
            self._drain_continuations()
        for h in handles:
            # local import: tac imports this module at load time.
            from . import tac as _tac
            _tac.as_handle(h).wait()
        self._raise_errors()

    def _raise_errors(self) -> None:
        with self._cv:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    # -- scheduling internals ------------------------------------------------
    def _enqueue(self, task: Task, *, front: bool = False) -> None:
        with self._cv:
            if task._state == CREATED:
                task._state = READY
            if front:
                self._ready.appendleft(task)
            else:
                self._ready.append(task)
            if _tr.TRACING:
                _reg.REGISTRY.gauge("runtime.ready_queue").set(
                    len(self._ready))
            self._cv.notify()

    def _spawn_worker_locked(self) -> None:
        t = threading.Thread(target=self._worker_loop,
                             name=f"repro-worker-{len(self._threads)}",
                             daemon=True)
        self._threads.append(t)
        self._live_threads += 1
        self.stats["threads_spawned"] += 1
        t.start()

    def _worker_loop(self) -> None:
        while True:
            task = self._next_task()
            if task is None:
                return
            self._run_task(task)

    def _next_task(self) -> Optional[Task]:
        """Pop a ready task; poll opportunistically while idle (§4.5)."""
        while True:
            with self._cv:
                if self._ready:
                    return self._ready.popleft()
                if self._shutdown:
                    self._live_threads -= 1
                    return None
                # Retire surplus spare threads once they go idle.
                if (self._live_threads - self._blocked_threads
                        > self.num_workers):
                    self._live_threads -= 1
                    self.stats["threads_retired"] += 1
                    return None
                self._cv.wait(timeout=self.poll_interval)
                if self._ready or self._shutdown:
                    continue
            # Nothing to run: serve the polling services before idling.
            self.polling.poll_once()

    def _run_task(self, task: Task) -> None:
        with task._state_lock:
            if task._completed_once:   # speculative duplicate lost the race
                return
            if task._state in (READY, CREATED):
                task._state = RUNNING
        task._started_at = time.monotonic()
        prev = current_task()
        set_current_task(task)
        try:
            result = task.fn(*task.args, **task.kwargs)
            error: Optional[BaseException] = None
        except BaseException as e:  # noqa: BLE001 - reported via taskwait
            result, error = None, e
        finally:
            set_current_task(prev)
        task._finished_at = time.monotonic()
        if _tr.TRACING:
            # One span per body execution: pause spans (the §4.1 wait)
            # nest inside it on the timeline.
            _tr.TRACER.span("task", "run", task._started_at,
                            task._finished_at, rank=task.rank,
                            task=task.name, label=task.label)

        with task._state_lock:
            if task._completed_once:
                return  # another speculative copy already completed
            task._completed_once = True
            task._state = FINISHED
        with self._cv:
            self.stats["tasks_executed"] += 1
        if error is not None:
            task.error = error
            with self._cv:
                self._errors.append(TaskError(task, error))
            # Fail-safe: force the release so dependents/taskwait do not hang
            # on events that will never be fulfilled.
            task._event_counter._force_release_on_error()
        else:
            task.result = result
            # Decrease the implicit unit bound at creation (§4.6).  If the
            # task bound external events this will NOT release yet.
            task._event_counter._decrease(1)

    # -- dependency release (called by EventCounter at zero) ---------------
    def _release_task(self, task: Task) -> None:
        task._state = RELEASED
        if _tr.TRACING:
            _tr.TRACER.instant("task", "release", rank=task.rank,
                               task=task.name)
        for succ in self.graph.on_release(task):
            self._enqueue(succ)
        with self._cv:
            self._unreleased -= 1
            self._cv.notify_all()

    # -- pause/resume hooks (called by events.block_current_task) ----------
    def _block_task(self, ctx: BlockingContext) -> None:
        task = ctx._task
        if self.block_mode == "nested":
            self._block_nested(ctx)
            return
        t_pause = time.monotonic() if _tr.TRACING else 0.0
        with self._cv:
            task._state = BLOCKED
            self._blocked_threads += 1
            self.stats["task_blocks"] += 1
            available = self._live_threads - self._blocked_threads
            if (available < self.num_workers
                    and self._live_threads < self.max_threads):
                # Keep the cores fed: thread-per-blocked-task (Nanos6-style).
                self._spawn_worker_locked()
        ctx._event.wait()
        with self._cv:
            self._blocked_threads -= 1
            task._state = RUNNING
            self.stats["task_resumes"] += 1
        if _tr.TRACING:
            _tr.TRACER.span("task", "pause", t_pause, time.monotonic(),
                            rank=task.rank, task=task.name,
                            mode="spare-thread")

    def _block_nested(self, ctx: BlockingContext) -> None:
        """Help-first blocking: run other ready tasks on this stack (§5)."""
        task = ctx._task
        task._state = BLOCKED
        t_pause = time.monotonic() if _tr.TRACING else 0.0
        with self._cv:
            self.stats["task_blocks"] += 1
        while not ctx._event.is_set():
            nested: Optional[Task] = None
            with self._cv:
                if self._ready:
                    nested = self._ready.popleft()
            if nested is not None:
                self._run_task(nested)
            else:
                self.polling.poll_once()
                ctx._event.wait(timeout=self.poll_interval)
        task._state = RUNNING
        with self._cv:
            self.stats["task_resumes"] += 1
        if _tr.TRACING:
            _tr.TRACER.span("task", "pause", t_pause, time.monotonic(),
                            rank=task.rank, task=task.name, mode="nested")

    def _on_task_unblock(self, task: Task) -> None:
        with self._cv:
            self.stats["task_unblocks"] += 1
            self._cv.notify_all()

    # -- straggler mitigation ----------------------------------------------
    def _straggler_service(self, _data: Any) -> bool:
        now = time.monotonic()
        for t in self.graph.tasks:
            if (t._state == RUNNING and t.idempotent
                    and not getattr(t, "_speculated", False)
                    and t._started_at is not None
                    and now - t._started_at > self.speculative_timeout):
                t._speculated = True
                with self._cv:
                    self.stats["speculative_reruns"] += 1
                if _tr.TRACING:
                    # The speculation decision, trace-visible: this task
                    # exceeded the timeout and gets re-enqueued; compare
                    # against analysis.straggler_scores on the same trace.
                    _tr.TRACER.instant(
                        "task", "speculate", rank=t.rank, task=t.name,
                        elapsed_s=now - t._started_at,
                        timeout_s=self.speculative_timeout)
                self._enqueue(t, front=True)
        return False  # keep the watchdog registered


# ---------------------------------------------------------------------------
# EventCounter needs a forced-release path for failed tasks; attach it here to
# keep events.py free of executor knowledge.
# ---------------------------------------------------------------------------
def _force_release_on_error(self) -> None:
    with self._lock:
        if self._released:
            return
        self._released = True
        self._count = 0
    self._runtime._release_task(self._task)


_ev.EventCounter._force_release_on_error = _force_release_on_error  # type: ignore[attr-defined]
