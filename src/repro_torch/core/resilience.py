"""ULFM-style resilience: fault injection, revoke/shrink, elastic resume —
the port's copy of ``repro/core/resilience.py`` (numpy only; the serving
engine's failure path needs it).

Production traffic means ranks die.  MPI's User-Level Failure Mitigation
(ULFM) proposal defines the minimal recovery vocabulary — a failed
process surfaces as ``MPI_ERR_PROC_FAILED`` on the operations that touch
it, any survivor may ``MPI_Comm_revoke`` the communicator to propagate
the failure to peers that would otherwise block forever, and the
survivors call ``MPI_Comm_shrink`` to agree on a working communicator
without the dead ranks.  This module is that vocabulary for the host
runtime, built on the failure model in :mod:`repro_torch.core.tac`:

* **Detection** — :meth:`repro_torch.core.tac.CommWorld.fail_rank` kills a
  rank: every pending handle naming it completes erroneously with
  :class:`~repro_torch.core.tac.RankFailedError`, *pushed* through the
  handles' completion callbacks — the continuation engine dispatches the
  failure exactly like a success, so neither notification backend gains
  a single new poll.  Failures are observable at task granularity: a
  dead peer is a raising ``handle.result`` / ``taskwait``, never a hang.

* **Propagation** — a collective machine that observes a
  ``RankFailedError`` revokes its communicator
  (:meth:`repro_torch.core.collectives._Machine.advance`), failing every
  peer's pending rounds with
  :class:`~repro_torch.core.tac.CommRevokedError`; posts stay failing until
  recovery completes.

* **Agreement** — survivors call
  :meth:`repro_torch.core.tac.CommWorld.shrink`
  (same generation-counted collective construction as ``split``); the
  agreement completes once every live rank voted and yields one shared
  :class:`~repro_torch.core.tac.CommGroup` over the survivors, closing the
  revocation window.

* **Rebuild** — compiled plans are cached keyed on the communicator
  *epoch* (:func:`repro_torch.core.program.epoch_of`), which every
  failure/revoke bumps, so persistent schedules
  (:class:`~repro_torch.core.collectives.PersistentCollective`,
  :class:`~repro_torch.core.collectives.HaloExchange`) recompile themselves on
  first post after recovery; :meth:`repro_torch.core.tac.CommGroup.cart` /
  :meth:`~repro_torch.core.tac.CommGroup.graph` re-shape the shrunken group
  with a fresh topology; the benchmarks resume from
  :mod:`repro_torch.checkpoint` at the last completed step.

:class:`FaultInjector` is the test-first half: it kills a rank either
immediately (:meth:`FaultInjector.kill`) or deterministically at the
victim's N-th posted operation (:meth:`FaultInjector.arm`) — mid-send,
mid-collective, or between schedule rounds, depending on N — which is
what the hypothesis property suite in ``tests/test_resilience.py``
sweeps.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from . import tac
from .tac import CommGroup, CommWorld, CommRevokedError, RankFailedError

__all__ = ["FaultInjector", "RankFailedError", "CommRevokedError",
           "shrink_world", "recover"]


class FaultInjector:
    """Kill ranks of a :class:`~repro_torch.core.tac.CommWorld` on cue.

    Two triggers:

    * :meth:`kill` — immediate: the rank dies *now*, failing its pending
      traffic (a crash between schedule rounds or between iterations).
    * :meth:`arm` — deterministic mid-operation injection: the victim
      dies the instant it posts its ``after_ops``-th send/recv.  Because
      the hook fires *before* the op reaches the matching engine, the
      op that pulls the trigger itself fails — ``after_ops=1`` is death
      on first contact (mid-collective round 0), larger values land the
      failure deeper into a schedule.

    The injector taps ``CommWorld._fault_hook``, which the transport
    invokes synchronously on the posting thread — injection points are
    reproducible for a fixed schedule and driver, which is what lets
    hypothesis shrink failing cases.
    """

    def __init__(self, world: CommWorld) -> None:
        self.world = world
        self.killed: List[int] = []

    def kill(self, rank: int) -> None:
        """Fail ``rank`` immediately (idempotent, like ``fail_rank``)."""
        self.world.fail_rank(rank)
        if rank not in self.killed:
            self.killed.append(rank)

    def arm(self, victim: int, *, after_ops: int = 1,
            kinds: Sequence[str] = ("isend", "irecv")) -> None:
        """Kill ``victim`` when it posts its ``after_ops``-th operation.

        ``kinds`` restricts which posts count (``isend``/``irecv``).  An
        op is attributed to the rank that *posted* it: the source of a
        send, the destination of a recv.  Only one armed trap at a time;
        it disarms itself when it fires.
        """
        if not 0 <= victim < self.world.size:
            raise ValueError(f"victim {victim} out of range for world "
                             f"size {self.world.size}")
        if after_ops < 1:
            raise ValueError(f"after_ops must be >= 1, got {after_ops}")
        state = {"n": 0}

        def hook(kind: str, src: int, dst: int, tag: Any) -> None:
            if kind not in kinds:
                return
            poster = src if kind == "isend" else dst
            if poster != victim:
                return
            state["n"] += 1
            if state["n"] >= after_ops:
                self.world._fault_hook = None
                self.kill(victim)

        self.world._fault_hook = hook

    def disarm(self) -> None:
        """Remove an armed trap that has not fired."""
        self.world._fault_hook = None

    @property
    def armed(self) -> bool:
        return self.world._fault_hook is not None


def shrink_world(world: CommWorld) -> CommGroup:
    """Run the shrink agreement for every survivor and return the group.

    The single-driver convenience (tests, benchmarks): votes for all
    live ranks are cast from the calling thread, so the agreement
    completes synchronously.  All survivors share the returned
    :class:`~repro_torch.core.tac.CommGroup` (dense group-local ranks in
    ascending world order), exactly as if each had called
    ``world.shrink(rank=r)`` itself.
    """
    survivors = world.alive
    if not survivors:
        raise RankFailedError(message="no survivors to shrink onto")
    handles = [world.shrink(rank=r) for r in survivors]
    groups = [h.wait() for h in handles]
    return groups[0]


def recover(world: CommWorld) -> CommGroup:
    """The full ULFM recovery step: revoke, then shrink.

    Call from the survivor that observed a
    :class:`~repro_torch.core.tac.RankFailedError` (e.g. out of ``taskwait``):
    the revoke unsticks any peer still parked on the dead rank's
    traffic, the shrink agreement produces the working communicator.
    Rebuild topologies/persistent objects on the returned group and
    resume from the last checkpoint.
    """
    world.revoke()
    return shrink_world(world)
