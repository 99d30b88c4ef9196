"""The unified metrics registry: relaxed counters, gauges, histograms.

The runtime's hot paths used to keep ad-hoc ``stats`` dicts whose every
increment took the owning engine's lock
(:class:`repro_torch.core.continuations.ContinuationEngine` paid one lock
round-trip per attach, per completion, and per dispatch).  This module
replaces that with instruments designed for the emit side:

* :class:`Counter` — **striped** per-thread cells: ``inc()`` touches only
  the calling thread's private cell (a one-element list; CPython list
  item assignment is atomic under the GIL), so the hot path takes no lock
  and suffers no cache-line ping-pong.  ``value`` sums the cells under a
  lock — totals are *exact* (each increment lands in exactly one cell;
  the relaxation is only in ordering), which
  ``tests/test_continuations.py`` asserts by reconciling engine totals
  against ground truth after a multi-threaded run.
* :class:`Gauge` — a lock-protected level (in-flight handles, queue
  depths); emission sites only touch gauges when tracing/metrics are
  wanted, so the lock is off the default path.
* :class:`Histogram` — power-of-two bucketed latencies (dispatch latency,
  token latency) with exact count/sum/min/max.

:data:`REGISTRY` is the process-wide registry; engines may also own
private instruments (the continuation engine pre-binds its counters as
attributes so the emit site is one method call).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY"]


class Counter:
    """A monotonically increasing counter with per-thread cells.

    ``inc`` is lock-free after a thread's first increment; ``value`` is
    an exact total (sum over cells).  Decrements are not supported — use
    a :class:`Gauge` for levels.
    """

    __slots__ = ("name", "_lock", "_cells", "_tls")

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._cells: List[List[int]] = []
        self._tls = threading.local()

    def inc(self, n: int = 1) -> None:
        try:
            cell = self._tls.cell
        except AttributeError:
            cell = [0]
            with self._lock:
                self._cells.append(cell)
            self._tls.cell = cell
        cell[0] += n

    @property
    def value(self) -> int:
        with self._lock:
            return sum(cell[0] for cell in self._cells)

    def reset(self) -> None:
        with self._lock:
            for cell in self._cells:
                cell[0] = 0

    def __repr__(self) -> str:    # pragma: no cover - debugging aid
        return f"<Counter {self.name!r} {self.value}>"


class Gauge:
    """A settable level (in-flight operations, queue depth)."""

    __slots__ = ("name", "_lock", "_value", "_max")

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n
            if self._value > self._max:
                self._max = self._value

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    def set(self, value: float) -> None:
        with self._lock:
            self._value = value
            if value > self._max:
                self._max = value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def high_water(self) -> float:
        """The maximum level ever set (peak in-flight / peak depth)."""
        with self._lock:
            return self._max

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0
            self._max = 0.0

    def __repr__(self) -> str:    # pragma: no cover - debugging aid
        return f"<Gauge {self.name!r} {self.value}>"


class Histogram:
    """Power-of-two bucketed samples (latencies, sizes).

    Bucket ``k`` counts samples in ``(2^(k-1)·base, 2^k·base]`` with
    ``base`` the smallest resolvable magnitude (default 1 µs for
    second-denominated latencies).  Exact count/sum/min/max ride along,
    so means are exact and the buckets only approximate quantiles.
    """

    __slots__ = ("name", "base", "_lock", "_buckets", "_count", "_sum",
                 "_min", "_max")

    N_BUCKETS = 64

    def __init__(self, name: str = "", base: float = 1e-6) -> None:
        self.name = name
        self.base = base
        self._lock = threading.Lock()
        self._buckets = [0] * self.N_BUCKETS
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def _index(self, x: float) -> int:
        if x <= self.base:
            return 0
        return min(self.N_BUCKETS - 1,
                   1 + int(math.floor(math.log2(x / self.base))))

    def observe(self, x: float) -> None:
        with self._lock:
            self._buckets[self._index(x)] += 1
            self._count += 1
            self._sum += x
            if self._min is None or x < self._min:
                self._min = x
            if self._max is None or x > self._max:
                self._max = x

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return {"count": float(self._count), "sum": self._sum,
                    "mean": self._sum / self._count if self._count else 0.0,
                    "min": self._min or 0.0, "max": self._max or 0.0}

    def reset(self) -> None:
        with self._lock:
            self._buckets = [0] * self.N_BUCKETS
            self._count = 0
            self._sum = 0.0
            self._min = None
            self._max = None

    def __repr__(self) -> str:    # pragma: no cover - debugging aid
        return f"<Histogram {self.name!r} n={self.count}>"


class MetricsRegistry:
    """Named instruments, created on first use and shared thereafter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, base: float = 1e-6) -> Histogram:
        return self._get(name, Histogram, base=base)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """A snapshot of every instrument (for reports / otherData)."""
        with self._lock:
            items = list(self._instruments.items())
        out: Dict[str, Dict[str, float]] = {}
        for name, inst in items:
            if isinstance(inst, Counter):
                out[name] = {"value": float(inst.value)}
            elif isinstance(inst, Gauge):
                out[name] = {"value": inst.value,
                             "high_water": inst.high_water}
            elif isinstance(inst, Histogram):
                out[name] = inst.summary()
        return out

    def reset(self) -> None:
        with self._lock:
            items = list(self._instruments.values())
        for inst in items:
            inst.reset()             # type: ignore[attr-defined]


#: The process-wide registry.
REGISTRY = MetricsRegistry()
