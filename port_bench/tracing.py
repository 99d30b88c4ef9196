"""The traced run's window under ``torch.profiler``, and its reduction to
what the per-layer readers and the result's ``device`` and ``breakdown``
take: the device's busy seconds (the union of kernel, copy and set
intervals), the traced window's length, each device operation's count and
seconds, and the idle gaps named by what the host was doing."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from typing import Dict, List, Tuple

WINDOW = "port_bench/window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[int, float]]        # name -> (count, seconds)
    gaps: Dict[str, float]                  # host activity -> idle seconds

    def top_ops(self, n: int = 10) -> List[List]:
        rank = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name, secs] for name, (_, secs) in rank]

    def top_gaps(self, n: int = 10) -> List[List]:
        rank = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return [[name, secs] for name, secs in rank]

    def kernels(self, pattern) -> Tuple[int, float]:
        """(launches, seconds) of the device operations whose name
        matches the compiled regular expression ``pattern``."""
        n, s = 0, 0.0
        for name, (count, secs) in self.ops.items():
            if pattern.search(name):
                n += count
                s += secs
        return n, s


class Tracer:
    """``with tracer.window(): ...`` runs the window under the profiler
    (CPU and CUDA activity) when ``enabled``; ``summary()`` reduces it."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self.prof = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        with self.prof:
            with record_function(WINDOW):
                yield

    def summary(self) -> Summary:
        return reduce(self.prof.profiler.kineto_results.events())


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _is_device(e) -> bool:
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    return e.device_type().name != "CPU"


def _span(e) -> Tuple[int, int]:
    """(start, end) in ns."""
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = int(e.start_us() * 1000)
    return s, s + int(e.duration_us() * 1000)


def _is_annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def reduce(events) -> Summary:
    """A :class:`Summary` of kineto events, clipped to the host's window
    annotation.  Device events that mirror a host annotation (the GPU
    side of a ``record_function``) are not device work."""
    lo = hi = None
    device, host, marks = [], [], {WINDOW}
    for e in events:
        s, t = _span(e)
        if _is_device(e):
            device.append((s, t, e.name(), _is_annotation(e)))
        else:
            if e.name() == WINDOW:
                lo, hi = s, t
                continue
            if _is_annotation(e):
                marks.add(e.name())
            host.append((s, t, e.name()))
    device = [(s, t, n) for s, t, n, mark in device
              if not mark and n not in marks]
    if lo is None:
        raise RuntimeError("the trace has no window annotation")
    ops: Dict[str, List] = {}
    spans = []
    for s, t, name in device:
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        spans.append((s, t))
        acc = ops.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += (t - s) * 1e-9
    busy = _union(spans)
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        doing = _doing(host, starts, (a + b) // 2)
        gaps[doing] = gaps.get(doing, 0.0) + (b - a) * 1e-9
    return Summary(window_s=(hi - lo) * 1e-9,
                   busy_s=sum(t - s for s, t in busy) * 1e-9,
                   ops={k: (v[0], v[1]) for k, v in ops.items()}, gaps=gaps)


def _doing(host, starts, t: int, look: int = 4000) -> str:
    """The innermost host event running at ``t``: of those begun by then
    and not yet ended, the last begun (among the ``look`` latest)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - look, -1), -1):
        if host[j][1] > t:
            return host[j][2]
    return "(no host event)"
