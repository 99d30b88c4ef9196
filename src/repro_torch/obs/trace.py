"""Structured task-timeline tracing (Chrome trace-event / Perfetto JSON).

The paper's two APIs are *scheduling* claims — a blocking wait pauses the
task instead of the core (§4.1) and an event-bound operation defers the
task's dependency release to completion time (§4.3) — and end-to-end bench
ratios only show their effect.  This module records the mechanism itself:
every layer of the runtime emits **span events** (task run/pause, handle
in-flight windows, continuation dispatches, collective round advances,
serving micro-steps) into bounded per-thread ring buffers, exported as one
Chrome trace-event JSON document that loads directly in
`ui.perfetto.dev <https://ui.perfetto.dev>`_ or ``chrome://tracing``.

Design constraints, in order:

1. **Disabled means free.**  Tracing is off by default.  Every
   instrumentation site in the runtime is guarded by a single module
   attribute read (``if trace.TRACING: ...``) — no tracer method call, no
   argument packing, nothing allocated on the disabled path.  The bound is
   asserted by ``benchmarks/overlap_bench.py`` (``obs.null`` sentinel row:
   guard cost ≤ 2% of the hot-path work it guards).
2. **Enabled means bounded.**  Each emitting thread appends to its own
   ring buffer (``collections.deque(maxlen=capacity)``) — no lock on the
   emit path after the first event per thread, and a runaway run
   overwrites its oldest events instead of growing without bound.
3. **One schema, two producers.**  The host tracer and the discrete-event
   simulator (:func:`repro.core.simulate.trace_events`) emit the *same*
   event dictionaries, so expected-vs-measured timelines diff directly
   and :func:`repro_torch.obs.analysis.overlap_fraction` computes the paper's
   headline number from either source.

Timestamps ride ``time.monotonic()`` and are exported in microseconds
relative to the tracer's epoch (trace-event convention).  ``pid`` carries
the logical rank (0 when unattributed) and ``tid`` a small per-thread
index, so Perfetto renders one process row per rank with one track per
worker thread.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "CATEGORIES", "SPAN_SCHEMA", "DEFAULT_CAPACITY",
    "Tracer", "NullTracer", "TRACER", "TRACING",
    "set_tracer", "get_tracer", "tracing",
    "span_event", "instant_event", "counter_event",
    "export_trace", "validate_trace", "assert_valid_trace",
]

DEFAULT_CAPACITY = 65536

#: Event categories, one per instrumented layer.
CATEGORIES = ("task", "handle", "continuation", "collective", "serving")

#: The span schema both producers (host tracer, simulator replay) follow:
#: per category, which complete-span (``ph="X"``) and instant (``ph="i"``)
#: names may appear.  ``validate_trace`` enforces it.
SPAN_SCHEMA: Dict[str, Dict[str, tuple]] = {
    # Task lifecycle (executor): submit -> run (pause/resume nested within
    # the run span) -> release; speculate marks a straggler re-enqueue.
    "task": {"spans": ("run", "pause"),
             "instants": ("submit", "release", "speculate")},
    # Handle lifecycle (tac): the inflight span opens at post time and
    # closes at complete/fail; match marks eager matching, bind marks
    # iwait/iwaitall event binding, dep-release the deferred dependency
    # release of §4.3 firing from the completion callback.
    "handle": {"spans": ("inflight",),
               "instants": ("post", "match", "complete", "bind",
                            "dep-release")},
    # Continuation engine: attach and queue->callback dispatch.
    "continuation": {"spans": (), "instants": ("attach", "dispatch")},
    # Collective machines / compiled programs: one resolved wait == one
    # round advanced.
    "collective": {"spans": (), "instants": ("round",)},
    # Serving micro-steps.
    "serving": {"spans": ("device_step", "detok"),
                "instants": ("token",)},
}


# ---------------------------------------------------------------------------
# Raw event constructors — shared by the host tracer and the simulator.
# ---------------------------------------------------------------------------
def span_event(cat: str, name: str, ts_us: float, dur_us: float, *,
               rank: Optional[int] = None, tid: int = 0,
               **args: Any) -> Dict[str, Any]:
    """A complete span (``ph="X"``) in exported form (timestamps in µs)."""
    if rank is not None:
        args.setdefault("rank", rank)
    return {"ph": "X", "cat": cat, "name": name,
            "ts": float(ts_us), "dur": max(0.0, float(dur_us)),
            "pid": 0 if rank is None else int(rank), "tid": int(tid),
            "args": args}


def instant_event(cat: str, name: str, ts_us: float, *,
                  rank: Optional[int] = None, tid: int = 0,
                  **args: Any) -> Dict[str, Any]:
    """An instant event (``ph="i"``, thread scope) in exported form."""
    if rank is not None:
        args.setdefault("rank", rank)
    return {"ph": "i", "s": "t", "cat": cat, "name": name,
            "ts": float(ts_us),
            "pid": 0 if rank is None else int(rank), "tid": int(tid),
            "args": args}


def counter_event(name: str, value: float, ts_us: float, *,
                  rank: Optional[int] = None, tid: int = 0) -> Dict[str, Any]:
    """A counter sample (``ph="C"``) in exported form."""
    return {"ph": "C", "name": name, "ts": float(ts_us),
            "pid": 0 if rank is None else int(rank), "tid": int(tid),
            "args": {name: float(value)}}


# ---------------------------------------------------------------------------
# Tracers.
# ---------------------------------------------------------------------------
class NullTracer:
    """The default tracer: every method is a no-op, ``events()`` is empty.

    Instrumentation sites never even reach these methods — they are
    guarded by the module-level :data:`TRACING` flag — so the disabled
    cost is one attribute read per site, not a call.
    """

    capacity = 0

    def span(self, cat: str, name: str, t0: float, t1: float, *,
             rank: Optional[int] = None, **args: Any) -> None:
        pass

    def instant(self, cat: str, name: str, *, t: Optional[float] = None,
                rank: Optional[int] = None, **args: Any) -> None:
        pass

    def counter(self, name: str, value: float, *,
                rank: Optional[int] = None) -> None:
        pass

    def events(self) -> List[Dict[str, Any]]:
        return []

    def clear(self) -> None:
        pass


class Tracer:
    """Bounded per-thread ring-buffer tracer.

    Each emitting thread gets its own ``deque(maxlen=capacity)`` — created
    (and registered under the tracer's lock) on that thread's first event,
    lock-free afterwards.  ``events()`` merges all rings sorted by
    timestamp.  Span inputs are ``time.monotonic()`` seconds; storage and
    export are µs relative to the tracer's construction epoch.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.epoch = time.monotonic()
        self._lock = threading.Lock()
        self._rings: List[collections.deque] = []
        self._tls = threading.local()

    # -- emit path -----------------------------------------------------------
    def _ring(self) -> collections.deque:
        try:
            return self._tls.ring
        except AttributeError:
            ring: collections.deque = collections.deque(maxlen=self.capacity)
            with self._lock:
                self._tls.tid = len(self._rings)
                self._rings.append(ring)
            self._tls.ring = ring
            return ring

    def _us(self, t: float) -> float:
        return (t - self.epoch) * 1e6

    def span(self, cat: str, name: str, t0: float, t1: float, *,
             rank: Optional[int] = None, **args: Any) -> None:
        """Record a complete span covering monotonic seconds [t0, t1]."""
        ring = self._ring()
        ring.append(span_event(cat, name, self._us(t0),
                               (t1 - t0) * 1e6, rank=rank,
                               tid=self._tls.tid, **args))

    def instant(self, cat: str, name: str, *, t: Optional[float] = None,
                rank: Optional[int] = None, **args: Any) -> None:
        """Record an instant event (now, unless ``t`` is given)."""
        ring = self._ring()
        ring.append(instant_event(
            cat, name, self._us(time.monotonic() if t is None else t),
            rank=rank, tid=self._tls.tid, **args))

    def counter(self, name: str, value: float, *,
                rank: Optional[int] = None) -> None:
        """Record a counter sample at the current time."""
        ring = self._ring()
        ring.append(counter_event(name, value,
                                  self._us(time.monotonic()),
                                  rank=rank, tid=self._tls.tid))

    # -- collection ----------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """All recorded events, merged across threads, sorted by ts."""
        with self._lock:
            rings = list(self._rings)
        out: List[Dict[str, Any]] = []
        for ring in rings:
            out.extend(ring)
        out.sort(key=lambda ev: ev["ts"])
        return out

    def clear(self) -> None:
        with self._lock:
            for ring in self._rings:
                ring.clear()


#: The active tracer.  Instrumentation sites read :data:`TRACING` first
#: and only touch :data:`TRACER` when it is True.
TRACER: Any = NullTracer()
TRACING: bool = False


def set_tracer(tracer: Any) -> Any:
    """Install ``tracer`` as the active tracer; returns the previous one.

    Passing a :class:`NullTracer` (or ``None``) disables tracing —
    :data:`TRACING` flips accordingly, so guarded sites go back to their
    single-attribute-read cost.
    """
    global TRACER, TRACING
    prev = TRACER
    TRACER = NullTracer() if tracer is None else tracer
    TRACING = not isinstance(TRACER, NullTracer)
    return prev


def get_tracer() -> Any:
    """The active tracer (a :class:`NullTracer` when tracing is off)."""
    return TRACER


@contextlib.contextmanager
def tracing(capacity: int = DEFAULT_CAPACITY,
            tracer: Optional[Any] = None) -> Iterator[Any]:
    """Context manager: install a (fresh) :class:`Tracer`, restore after.

    >>> with tracing() as tr:            # doctest: +SKIP
    ...     run_workload()
    ...     doc = export_trace("out.json", tracer=tr)
    """
    tr = Tracer(capacity) if tracer is None else tracer
    prev = set_tracer(tr)
    try:
        yield tr
    finally:
        set_tracer(prev)


# ---------------------------------------------------------------------------
# Export + validation.
# ---------------------------------------------------------------------------
def export_trace(path: Optional[str] = None, *, tracer: Optional[Any] = None,
                 events: Optional[List[Dict[str, Any]]] = None,
                 extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build (and optionally write) the Chrome trace-event JSON document.

    ``events`` overrides the tracer's buffer — pass simulator events
    (:func:`repro.core.simulate.trace_events`) to export a replay under
    the identical schema.  ``extra`` lands in ``otherData`` (derived
    metrics like per-rank overlap fractions ride there).  Returns the
    document; writes it to ``path`` when given.  Load the file in
    ``ui.perfetto.dev`` or ``chrome://tracing``.
    """
    if events is None:
        events = (TRACER if tracer is None else tracer).events()
    doc: Dict[str, Any] = {
        "traceEvents": list(events),
        "displayTimeUnit": "ms",
        "otherData": dict(extra or {}),
    }
    if path is not None:
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=None, separators=(",", ":"),
                      default=str)
    return doc


def validate_trace(doc: Any) -> List[str]:
    """Check a trace document against :data:`SPAN_SCHEMA`.

    Returns a list of human-readable problems (empty == valid).  Accepts
    either the full document or a bare event list.
    """
    errors: List[str] = []
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return ["document has no 'traceEvents' list"]
    elif isinstance(doc, list):
        events = doc
    else:
        return [f"expected a dict or list, got {type(doc).__name__}"]
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "C"):
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            errors.append(f"{where}: missing name")
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"{where} ({name}): non-numeric ts")
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                errors.append(f"{where} ({name}): non-integer {field}")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where} ({name}): args is not an object")
        if ph == "C":
            continue
        cat = ev.get("cat")
        if cat not in SPAN_SCHEMA:
            errors.append(f"{where} ({name}): unknown cat {cat!r}")
            continue
        allowed = SPAN_SCHEMA[cat]["spans" if ph == "X" else "instants"]
        if name not in allowed:
            errors.append(f"{where}: {ph!r} name {name!r} not in schema "
                          f"for cat {cat!r} (allowed: {allowed})")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where} ({name}): bad dur {dur!r}")
    return errors


def assert_valid_trace(doc: Any) -> None:
    """Raise ``ValueError`` listing every schema violation (if any)."""
    errors = validate_trace(doc)
    if errors:
        head = "\n  ".join(errors[:20])
        more = f"\n  ... and {len(errors) - 20} more" if len(errors) > 20 \
            else ""
        raise ValueError(f"invalid trace ({len(errors)} problems):\n"
                         f"  {head}{more}")
