"""``repro_torch.obs`` — tracing, metrics registry, and derived observability.

The cross-cutting observability layer of the runtime:

* :mod:`repro_torch.obs.trace` — bounded per-thread ring-buffer tracing with
  Chrome trace-event / Perfetto JSON export (:func:`export_trace`) and a
  validated span schema shared with the simulator's replay.
* :mod:`repro_torch.obs.registry` — striped lock-free counters, gauges and
  histograms (the unified metrics registry the continuation engine's
  hot-path stats moved onto).
* :mod:`repro_torch.obs.analysis` — derived headline metrics:
  :func:`overlap_fraction` (share of communication hidden under
  compute — the paper's central claim as a number) and
  :func:`straggler_scores`.
* :mod:`repro_torch.obs.metrics` — shared helpers (``percentile``,
  ``TokenRecord``, ``MetricSink``) formerly in ``repro.serving.metrics``.

Tracing is **off by default** (:class:`NullTracer`); every
instrumentation site in the runtime guards on the live module flag
``repro_torch.obs.trace.TRACING`` so the disabled cost is one attribute read.
Enable it with::

    from repro_torch import obs
    with obs.tracing() as tr:
        ...                       # run the workload
        obs.export_trace("out.json", tracer=tr)

``python -m repro_torch.obs out.json`` validates a trace file against
:data:`SPAN_SCHEMA` and prints its summary (exit 0 when valid, 1 on a
violation, 2 without a file).
"""

from __future__ import annotations

from .analysis import (overlap_fraction, per_rank_overlap, straggler_scores,
                       summarize)
from .metrics import MetricSink, TokenRecord, percentile
from .registry import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from .trace import (CATEGORIES, DEFAULT_CAPACITY, SPAN_SCHEMA, NullTracer,
                    Tracer, assert_valid_trace, counter_event, export_trace,
                    get_tracer, instant_event, set_tracer, span_event,
                    tracing, validate_trace)

__all__ = [
    # trace
    "Tracer", "NullTracer", "set_tracer", "get_tracer", "tracing",
    "export_trace", "validate_trace", "assert_valid_trace",
    "span_event", "instant_event", "counter_event",
    "CATEGORIES", "SPAN_SCHEMA", "DEFAULT_CAPACITY",
    "TRACING", "TRACER",
    # registry
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    # analysis
    "overlap_fraction", "per_rank_overlap", "straggler_scores", "summarize",
    # metrics helpers
    "percentile", "TokenRecord", "MetricSink",
]


def __getattr__(name: str):
    # TRACING / TRACER are *live* module globals of repro_torch.obs.trace —
    # forwarding instead of re-exporting keeps `repro_torch.obs.TRACING`
    # truthful after set_tracer() flips the flag.
    if name in ("TRACING", "TRACER"):
        from . import trace
        return getattr(trace, name)
    raise AttributeError(
        f"module 'repro_torch.obs' has no attribute {name!r}")
