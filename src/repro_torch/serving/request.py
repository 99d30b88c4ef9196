"""Per-request state for the continuous-batching engine (the port's copy of
``repro/serving/request.py``).

Each request is an explicit state machine — the unit the scheduler in
:mod:`repro_torch.serving.engine` admits, steps, evicts, and re-admits.  The
legal transitions:

.. code-block:: text

    QUEUED --admit--> PREFILL --first token--> DECODE --gen_len--> DONE
      ^                  |                        |
      |                  +----evict/failure-------+
      +---- re-admission (EVICTED -> QUEUED, prefill restarts) ----+

Eviction (scheduler preemption or a rank failure surfacing out of
``taskwait``) drops the request's KV cache and returns it to the queue;
re-admission restarts it from prefill under a fresh *incarnation* —
the chain tokens that order its micro-step tasks are incarnation-keyed,
so tasks of a dead incarnation can never interleave with the retry.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional

__all__ = ["RequestState", "Request"]


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    EVICTED = "evicted"
    FAILED = "failed"


#: transitions the state machine accepts; anything else is a scheduler bug.
_TRANSITIONS = {
    RequestState.QUEUED: {RequestState.PREFILL, RequestState.FAILED},
    RequestState.PREFILL: {RequestState.DECODE, RequestState.EVICTED,
                           RequestState.FAILED},
    RequestState.DECODE: {RequestState.DONE, RequestState.EVICTED,
                          RequestState.FAILED},
    RequestState.EVICTED: {RequestState.QUEUED},
    RequestState.DONE: set(),
    RequestState.FAILED: set(),
}


@dataclasses.dataclass
class Request:
    """One inference request: prompt in, ``gen_len`` greedy tokens out.

    ``prompt`` is adapter-defined (token ids for the LM adapter, a seed
    payload for the synthetic one).  ``priority`` orders admission and
    preemption — LOWER values are more urgent, matching the queue's
    sort.  Mutable fields below the fold are scheduler state.
    """

    rid: int
    prompt: Any
    gen_len: int
    priority: int = 0
    arrival_s: float = 0.0

    # -- scheduler state -----------------------------------------------------
    state: RequestState = RequestState.QUEUED
    cache: Any = None                   # adapter decode state (KV cache)
    tokens: List[Any] = dataclasses.field(default_factory=list)
    submitted_steps: int = 0            # decode micro-steps handed to the rt
    incarnation: int = 0                # bumped on every re-admission
    evictions: int = 0
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None

    def to(self, new: RequestState) -> None:
        """Transition with legality checking (scheduler-bug tripwire)."""
        if new not in _TRANSITIONS[self.state]:
            raise RuntimeError(f"request {self.rid}: illegal transition "
                               f"{self.state.value} -> {new.value}")
        self.state = new

    def reset_for_requeue(self) -> None:
        """EVICTED -> QUEUED: drop the cache, restart from prefill."""
        self.to(RequestState.QUEUED)
        self.cache = None
        self.tokens = []
        self.submitted_steps = 0
        self.incarnation += 1
        self.evictions += 1

    @property
    def chain(self) -> str:
        """Dependency token ordering this incarnation's device steps."""
        return f"req-{self.rid}.{self.incarnation}"

    @property
    def detok_chain(self) -> str:
        """Dependency token ordering this incarnation's host detoks."""
        return f"detok-{self.rid}.{self.incarnation}"
