"""Serving metrics: the run report — the port of
``repro/serving/metrics.py``'s :class:`ServeReport`.

``percentile``, :class:`~repro_torch.obs.metrics.TokenRecord` and
:class:`~repro_torch.obs.metrics.MetricSink` live in
:mod:`repro_torch.obs.metrics`; the reference's deprecated re-export shim
has no callers in the port and is not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from ..obs.metrics import TokenRecord, percentile

__all__ = ["ServeReport"]


@dataclasses.dataclass
class ServeReport:
    """Outcome of one :meth:`repro_torch.serving.engine.ServingEngine.run`."""

    completion: str                     # "event" | "blocking"
    requests: int
    tokens: int
    wall_s: float
    tokens_per_s: float
    p50_ms: float
    p99_ms: float
    evictions: int
    recoveries: int
    outputs: Dict[int, List[Any]]       # rid -> emitted tokens, step order

    @staticmethod
    def build(completion: str, records: List[TokenRecord], wall_s: float,
              outputs: Dict[int, List[Any]], evictions: int,
              recoveries: int) -> "ServeReport":
        lat = [r.latency_s for r in records]
        return ServeReport(
            completion=completion,
            requests=len(outputs),
            tokens=len(records),
            wall_s=wall_s,
            tokens_per_s=len(records) / wall_s if wall_s > 0 else 0.0,
            p50_ms=percentile(lat, 50) * 1e3 if lat else 0.0,
            p99_ms=percentile(lat, 99) * 1e3 if lat else 0.0,
            evictions=evictions,
            recoveries=recoveries,
            outputs=outputs)

    def summary(self) -> str:
        return (f"[{self.completion}] {self.tokens} tok / {self.requests} "
                f"req in {self.wall_s:.3f}s = {self.tokens_per_s:.0f} "
                f"tok/s, p50 {self.p50_ms:.2f} ms, p99 {self.p99_ms:.2f} "
                f"ms, evictions={self.evictions}, "
                f"recoveries={self.recoveries}")
