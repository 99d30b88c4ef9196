"""Admission queue of the continuous-batching scheduler (the port's copy of
``repro/serving/queue.py``).

FCFS within a priority class (lower ``priority`` values run first);
arrival order is preserved by a monotone sequence number, so two
requests of equal priority never reorder.  Two re-entry points:

* :meth:`RequestQueue.push` — normal arrival (and preemption victims,
  which go to the BACK of their class so a preempted request cannot
  immediately preempt someone else — no thrash).
* :meth:`RequestQueue.push_front` — failure re-admission: a request
  evicted because a *rank* died (not because it lost an admission
  race) resumes at the head of its class.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import List, Optional, Tuple

from .request import Request

__all__ = ["RequestQueue"]


class RequestQueue:
    """Priority-then-FCFS admission queue (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._heap: List[Tuple[int, int, Request]] = []
        self._seq = itertools.count()
        # push_front entries take sequence numbers counting DOWN from 0,
        # so within a priority class they beat every normal arrival.
        self._front_seq = itertools.count(-1, -1)

    def push(self, req: Request) -> None:
        with self._lock:
            heapq.heappush(self._heap, (req.priority, next(self._seq), req))

    def push_front(self, req: Request) -> None:
        with self._lock:
            heapq.heappush(self._heap,
                           (req.priority, next(self._front_seq), req))

    def pop(self) -> Optional[Request]:
        with self._lock:
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def peek(self) -> Optional[Request]:
        with self._lock:
            return self._heap[0][2] if self._heap else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def __bool__(self) -> bool:
        return len(self) > 0
