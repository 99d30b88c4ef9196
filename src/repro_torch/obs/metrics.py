"""Shared metric helpers (moved from ``repro.serving.metrics``).

``percentile``, :class:`TokenRecord` and :class:`MetricSink` started life
in the serving layer but are generic observability primitives; they live
here so every layer (benchmarks, reports, serving) shares one
implementation.  ``repro.serving.metrics`` keeps deprecated re-export
shims.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List

__all__ = ["percentile", "TokenRecord", "MetricSink"]


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list."""
    if not values:
        raise ValueError("percentile of an empty list")
    xs = sorted(values)
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]


@dataclasses.dataclass(frozen=True)
class TokenRecord:
    """One emitted token: which request/step, and its latency window.

    ``t_submit`` is when the scheduler handed the decode micro-step to
    the runtime, ``t_emit`` when the host detokeniser finished with the
    token — so the latency covers device compute, completion
    notification, and host post-processing, which is exactly the window
    the event-bound vs blocking-sentinel legs differ in.
    """

    rid: int
    step: int
    t_submit: float
    t_emit: float

    @property
    def latency_s(self) -> float:
        return self.t_emit - self.t_submit


class MetricSink:
    """Thread-safe collector the engine's tasks append records to."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: List[TokenRecord] = []

    def emit(self, rec: TokenRecord) -> None:
        with self._lock:
            self._records.append(rec)

    @property
    def records(self) -> List[TokenRecord]:
        with self._lock:
            return list(self._records)
