"""Tasks and data-flow dependency tracking (OmpSs-2 style, paper §2.1).

Tasks declare *data regions* they read (``in_``), write (``out``) or update
(``inout``).  Submission order plus the declared accesses induce the
dependency graph, with the usual serialisation semantics:

* a reader depends on the last writer of each region it reads;
* a writer depends on the last writer **and** on every reader registered
  since that writer (anti-dependency);
* ``inout`` behaves as read+write.

A task *releases* its dependencies when its event counter reaches zero
(paper §4.6): that is, when the task body has finished **and** every bound
external event has been fulfilled.  Successors whose predecessor count drops
to zero become ready.  This is precisely the mechanism TAMPI's non-blocking
mode builds on: a communication task can finish executing while its
dependency release is deferred to the completion of the MPI requests it
initiated (§6.2).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional
from typing import Sequence, Set, Tuple, TYPE_CHECKING

from .events import EventCounter

if TYPE_CHECKING:  # pragma: no cover
    from .events import BlockingContext
    from .executor import TaskRuntime

_task_ids = itertools.count()

# -- Task states --------------------------------------------------------------
CREATED = "created"      # submitted, waiting on predecessors
READY = "ready"          # in the ready queue
RUNNING = "running"      # body executing on a worker
BLOCKED = "blocked"      # paused inside block_current_task
FINISHED = "finished"    # body returned; external events may be pending
RELEASED = "released"    # event counter hit zero; dependencies released


class Task:
    """A unit of work with data-flow dependencies.

    Not instantiated directly — use :meth:`TaskRuntime.task` /
    :meth:`TaskRuntime.submit`.
    """

    def __init__(self, fn: Callable[..., Any], args: Tuple[Any, ...],
                 kwargs: Dict[str, Any], *, name: Optional[str],
                 runtime: "TaskRuntime", cost: float = 1.0,
                 idempotent: bool = False, label: Optional[str] = None,
                 rank: Optional[int] = None):
        self.id = next(_task_ids)
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name or getattr(fn, "__name__", f"task{self.id}")
        self.label = label  # free-form grouping tag (used by benchmarks)
        self.rank = rank    # logical rank for trace attribution (repro_torch.obs)
        self.cost = cost    # abstract cost for the makespan simulator
        self.idempotent = idempotent  # eligible for speculative re-execution
        self.result: Any = None
        self.error: Optional[BaseException] = None

        self._runtime = runtime
        self._state = CREATED
        self._state_lock = threading.Lock()
        self._num_pending = 0          # unreleased predecessors
        self._successors: List["Task"] = []
        self._predecessors: List["Task"] = []   # kept for introspection/sim
        self._event_counter = EventCounter(self, runtime)
        self._blocking_context: Optional["BlockingContext"] = None
        self._completed_once = False   # guards duplicate (speculative) runs
        self._started_at: Optional[float] = None
        self._finished_at: Optional[float] = None
        # Filled in by the graph at submission time:
        self.accesses: Dict[str, Tuple[Hashable, ...]] = {}

    # -- introspection ---------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    @property
    def successors(self) -> Tuple["Task", ...]:
        return tuple(self._successors)

    @property
    def predecessors(self) -> Tuple["Task", ...]:
        return tuple(self._predecessors)

    @property
    def pending_events(self) -> int:
        return self._event_counter.value

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Task #{self.id} {self.name!r} {self._state}>"


def _region_key(obj: Any) -> Hashable:
    """Normalise a user-provided data region into a dictionary key.

    Strings/ints/tuples are value-keyed; arbitrary objects are identity-keyed
    (the region table holds a reference so ids cannot be recycled while the
    region is live).
    """
    if isinstance(obj, (str, bytes, int, tuple, frozenset)):
        return ("val", obj)
    return ("obj", id(obj))


class _RegionState:
    __slots__ = ("anchor", "last_writer", "readers")

    def __init__(self, anchor: Any) -> None:
        self.anchor = anchor  # keep the object alive (identity-keyed regions)
        self.last_writer: Optional[Task] = None
        self.readers: List[Task] = []


class TaskGraph:
    """Registers tasks in submission order and wires their dependencies.

    Thread-safe; shared with the executor which drives state transitions.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._regions: Dict[Hashable, _RegionState] = {}
        self._tasks: List[Task] = []

    @property
    def tasks(self) -> List[Task]:
        with self._lock:
            return list(self._tasks)

    def register(self, task: Task, in_: Sequence[Any], out: Sequence[Any],
                 inout: Sequence[Any]) -> bool:
        """Wire ``task`` into the graph. Returns True if immediately ready."""
        reads = tuple(in_) + tuple(inout)
        writes = tuple(out) + tuple(inout)
        task.accesses = {
            "in": tuple(_region_key(r) for r in in_),
            "out": tuple(_region_key(r) for r in out),
            "inout": tuple(_region_key(r) for r in inout),
        }
        preds: Set[Task] = set()
        with self._lock:
            self._tasks.append(task)
            for r in reads:
                st = self._region(r)
                if st.last_writer is not None and not _is_released(st.last_writer):
                    preds.add(st.last_writer)
            for r in writes:
                st = self._region(r)
                if st.last_writer is not None and not _is_released(st.last_writer):
                    preds.add(st.last_writer)
                for reader in st.readers:
                    if reader is not task and not _is_released(reader):
                        preds.add(reader)
            # Second pass: update region tables to reflect this task's
            # accesses (readers accumulate; a write resets the epoch).
            for r in writes:
                st = self._region(r)
                st.last_writer = task
                st.readers = []
            for r in reads:
                # inout regions were reset above; record the read so a later
                # writer anti-depends on us.
                self._region(r).readers.append(task)
            preds.discard(task)
            task._num_pending = len(preds)
            task._predecessors = sorted(preds, key=lambda t: t.id)
            for p in preds:
                p._successors.append(task)
            return task._num_pending == 0

    def on_release(self, task: Task) -> List[Task]:
        """Called by the runtime when ``task`` releases its dependencies.

        Returns the successors that became ready.
        """
        newly_ready: List[Task] = []
        with self._lock:
            for s in task._successors:
                s._num_pending -= 1
                if s._num_pending == 0:
                    newly_ready.append(s)
        return newly_ready

    def _region(self, r: Any) -> _RegionState:
        key = _region_key(r)
        st = self._regions.get(key)
        if st is None:
            st = _RegionState(r)
            self._regions[key] = st
        return st

    # -- analytics (used by the makespan simulator & benchmarks) ---------
    def critical_path(self) -> float:
        """Length (sum of ``cost``) of the longest dependency chain."""
        with self._lock:
            order = list(self._tasks)
        dist: Dict[int, float] = {}
        for t in order:  # submission order is a topological order
            base = max((dist[p.id] for p in t._predecessors), default=0.0)
            dist[t.id] = base + t.cost
        return max(dist.values(), default=0.0)

    def edges(self) -> List[Tuple[int, int]]:
        with self._lock:
            return [(p.id, s.id) for p in self._tasks for s in p._successors]


def _is_released(task: Task) -> bool:
    return task._state == RELEASED
