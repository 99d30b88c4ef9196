"""Derived metrics over trace events: overlap fractions, straggler scores.

These functions consume the raw event dictionaries of
:mod:`repro_torch.obs.trace` — from the host tracer or from the simulator's
replay (:func:`repro.core.simulate.trace_events`), which emit the same
schema — and turn the timeline into the paper's headline numbers:

* :func:`overlap_fraction` — the share of communication time hidden
  under compute.  Communication time is the union of ``handle/inflight``
  spans (operation posted, not yet complete — §4.3's deferred-release
  window); compute time is the union of ``task/run`` spans whose
  ``label`` is ``"compute"``.  A fraction of 1.0 means every in-flight
  microsecond had compute running beside it (perfect overlap, the
  non-blocking mode's goal); 0.0 means communication was fully exposed
  (the sentinel's serialisation).
* :func:`straggler_scores` — per-rank busy-time slowdown vs the median
  rank, the signal behind the executor's speculative re-execution
  (``speculative_timeout``) now derivable from any trace.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["overlap_fraction", "per_rank_overlap", "straggler_scores",
           "summarize"]

Interval = Tuple[float, float]


# ---------------------------------------------------------------------------
# Interval algebra.
# ---------------------------------------------------------------------------
def _union(intervals: Sequence[Interval]) -> List[Interval]:
    """Merge overlapping/touching intervals; returns a sorted disjoint set."""
    out: List[Interval] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _intersect(a: Sequence[Interval],
               b: Sequence[Interval]) -> List[Interval]:
    """Intersection of two disjoint sorted interval sets (two-pointer)."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _measure(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def _spans(events: Sequence[Dict[str, Any]], cat: str, name: str, *,
           rank: Optional[int] = None,
           label: Optional[str] = None) -> List[Interval]:
    out: List[Interval] = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != cat \
                or ev.get("name") != name:
            continue
        args = ev.get("args") or {}
        if rank is not None and args.get("rank") != rank:
            continue
        if label is not None and args.get("label") != label:
            continue
        ts = ev["ts"]
        out.append((ts, ts + ev["dur"]))
    return out


# ---------------------------------------------------------------------------
# Overlap accounting.
# ---------------------------------------------------------------------------
def overlap_fraction(events: Sequence[Dict[str, Any]], *,
                     rank: Optional[int] = None) -> float:
    """Fraction of in-flight communication time covered by compute.

    ``|union(inflight) ∩ union(compute runs)| / |union(inflight)|`` over
    the given events, optionally restricted to one rank (events carry
    their rank in ``args["rank"]``; unattributed events only count in the
    unrestricted call).  Returns 0.0 when no communication was in flight.
    """
    comm = _union(_spans(events, "handle", "inflight", rank=rank))
    if not comm:
        return 0.0
    compute = _union(_spans(events, "task", "run", rank=rank,
                            label="compute"))
    return _measure(_intersect(comm, compute)) / _measure(comm)


def per_rank_overlap(events: Sequence[Dict[str, Any]]) -> Dict[int, float]:
    """Per-rank overlap fractions, keyed by ``args["rank"]``.

    Only ranks that had at least one attributed in-flight span appear.
    """
    ranks = sorted({(ev.get("args") or {}).get("rank")
                    for ev in events
                    if ev.get("ph") == "X" and ev.get("cat") == "handle"
                    and isinstance((ev.get("args") or {}).get("rank"), int)})
    return {r: overlap_fraction(events, rank=r) for r in ranks}


# ---------------------------------------------------------------------------
# Straggler accounting.
# ---------------------------------------------------------------------------
def straggler_scores(
        events: Sequence[Dict[str, Any]]) -> Dict[int, Dict[str, float]]:
    """Per-rank busy time and slowdown score vs the median rank.

    Busy time is the sum of ``task/run`` span durations attributed to
    each rank; ``score`` is that rank's busy time divided by the median
    across ranks (1.0 == median pace; the executor's speculative
    re-execution targets scores well above 1).  Returns
    ``{rank: {"busy": seconds, "tasks": n, "score": x}}``.
    """
    busy: Dict[int, float] = {}
    count: Dict[int, int] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "task" \
                or ev.get("name") != "run":
            continue
        rank = (ev.get("args") or {}).get("rank")
        if not isinstance(rank, int):
            continue
        busy[rank] = busy.get(rank, 0.0) + ev["dur"]
        count[rank] = count.get(rank, 0) + 1
    if not busy:
        return {}
    ordered = sorted(busy.values())
    median = ordered[len(ordered) // 2]
    return {r: {"busy": busy[r] / 1e6, "tasks": float(count[r]),
                "score": busy[r] / median if median > 0 else 1.0}
            for r in sorted(busy)}


# ---------------------------------------------------------------------------
# Summaries (the trace-file CLI and CI smoke use this).
# ---------------------------------------------------------------------------
def summarize(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Counts per (cat, name), the rank set, and headline metrics."""
    counts: Dict[str, int] = {}
    ranks = set()
    t_min, t_max = None, None
    for ev in events:
        key = f"{ev.get('cat', '?')}/{ev.get('name', '?')}[{ev.get('ph')}]"
        counts[key] = counts.get(key, 0) + 1
        r = (ev.get("args") or {}).get("rank")
        if isinstance(r, int):
            ranks.add(r)
        ts = ev.get("ts")
        if isinstance(ts, (int, float)):
            end = ts + ev.get("dur", 0.0) if ev.get("ph") == "X" else ts
            t_min = ts if t_min is None else min(t_min, ts)
            t_max = end if t_max is None else max(t_max, end)
    return {
        "events": sum(counts.values()),
        "counts": dict(sorted(counts.items())),
        "ranks": sorted(ranks),
        "wall_us": (t_max - t_min) if t_min is not None else 0.0,
        "overlap_fraction": overlap_fraction(events),
        "per_rank_overlap": per_rank_overlap(events),
        "straggler_scores": straggler_scores(events),
    }
