"""Fault-injection harness for the port's failure-recovery tests — the
twin of ``tests/fault_harness.py`` over ``repro_torch.core``.

Drives one allreduce across all ranks of a fresh world on a real
:class:`~repro_torch.core.TaskRuntime`, kills a chosen rank at a chosen
operation count (:meth:`repro_torch.core.resilience.FaultInjector.arm`),
harvests how the failure surfaced on every rank, then runs the full ULFM
recovery (revoke + shrink) and a post-recovery collective on the
survivors.

One difference from the reference harness, on purpose: the death can
fire only if the victim posts at least ``after_ops`` operations.  The
harness counts the victim's posts from the schedule
(:func:`victim_posts`: the Send and Recv operations of its program in
``schedule.build(...).programs``).  Beyond that count it asserts a clean
run instead of "injected failure was not observed" (the reference's
assertion fails there: a 2-rank ``doubling`` allreduce posts one Send and
one Recv a rank, so ``after_ops=3`` never fires).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core import Collectives, TaskRuntime, tac
from repro_torch.core import collectives as collectives_mod
from repro_torch.core import schedule as schedule_ir
from repro_torch.core.executor import TaskError
from repro_torch.core.resilience import FaultInjector, recover

ALGORITHMS = ("ring", "doubling", "bruck", "tree")


def victim_posts(n_ranks: int, victim: int, algorithm: str) -> int:
    """How many sends and receives ``victim`` posts in a flat allreduce of
    ``n_ranks`` with ``algorithm`` (its alias resolved as
    ``Collectives`` resolves it)."""
    name = collectives_mod._norm_alg(algorithm)
    prog = schedule_ir.build("allreduce", name, n_ranks).programs[victim]
    return sum(type(op).__name__ in ("Send", "Recv") for op in prog)


@dataclass
class FaultOutcome:
    """What one injected failure did to an n-rank collective."""
    world: tac.CommWorld
    values: List[np.ndarray]
    results: Dict[int, Any] = field(default_factory=dict)   # rank -> value
    errors: Dict[int, BaseException] = field(default_factory=dict)
    survivors: Any = None          # CommGroup after recovery, or None
    recovered: Dict[int, Any] = field(default_factory=dict)
    fired: bool = True             # False: after_ops beyond the posts

    @property
    def failed_ranks(self):
        return sorted(self.errors)

    @property
    def ok_ranks(self):
        return sorted(self.results)


def _resolve(store: Dict[int, Any], outcome: FaultOutcome) -> None:
    for r, v in store.items():
        try:
            if isinstance(v, tac.AsyncHandle):
                v = v.result
            outcome.results[r] = v
        except tac.RankFailedError as exc:    # includes CommRevokedError
            outcome.errors[r] = exc


def run_with_failure(*, n_ranks: int, victim: int, after_ops: int = 1,
                     algorithm: str = "ring", mode: str = "event",
                     notify: Optional[str] = None, op: str = "allreduce",
                     hierarchical: Optional[int] = None, workers: int = 2,
                     recover_after: bool = True,
                     seed: int = 0) -> FaultOutcome:
    """One allreduce over ``n_ranks`` with ``victim`` dying at its
    ``after_ops``-th posted operation; returns the harvested outcome.

    Checked here, for every parameter combination: the taskwait returns;
    every rank lands in exactly one of ``results`` / ``errors`` (event
    mode); the runtime closes with no polling service left.  When the
    victim posts at least ``after_ops`` operations, the failure is
    observed somewhere and, with ``recover_after``, the survivors revoke,
    shrink and re-run the collective, which must equal numpy's sum of
    their values.  When it posts fewer, the run must be clean: every rank
    holds numpy's sum of all values and nothing was killed.
    """
    tac.init(tac.TASK_MULTIPLE)
    world = tac.CommWorld(n_ranks)
    coll = Collectives(world)
    injector = FaultInjector(world)
    rng = np.random.default_rng(seed)
    values = [rng.standard_normal(4) for _ in range(n_ranks)]
    outcome = FaultOutcome(world=world, values=values)
    fires = hierarchical is not None or \
        after_ops <= victim_posts(n_ranks, victim, algorithm)
    outcome.fired = fires
    store: Dict[int, Any] = {}
    kw: Dict[str, Any] = ({"hierarchical": hierarchical}
                          if hierarchical else {"algorithm": algorithm})

    def body(r):
        def run():
            store[r] = coll.allreduce(values[r], rank=r, mode=mode,
                                      key="fh", **kw)
        return run

    rt = TaskRuntime(num_workers=workers, notify=notify)
    rt.start()
    try:
        injector.arm(victim, after_ops=after_ops)
        for r in range(n_ranks):
            rt.submit(body(r), name=f"coll[{r}]")
        try:
            rt.taskwait()       # must NOT hang for any combination
        except TaskError as exc:
            # blocking mode: the raising body never filled its slot
            root = exc.error
            assert isinstance(root, tac.RankFailedError), exc
        while True:             # drain stragglers
            try:
                rt.taskwait()
                break
            except TaskError:
                continue
    finally:
        injector.disarm()
        rt.close()
    assert rt.polling.num_services == 0, "leaked polling services"
    _resolve(store, outcome)
    claimed = set(outcome.results) | set(outcome.errors)
    if mode == "event":
        assert claimed == set(range(n_ranks)), claimed

    if not fires:
        assert injector.killed == [] and not world.failed, injector.killed
        assert outcome.errors == {} and len(outcome.results) == n_ranks
        total = np.sum(values, axis=0)
        for v in outcome.results.values():
            np.testing.assert_allclose(v, total, rtol=1e-10, atol=1e-12)
        return outcome

    assert injector.killed == [victim]
    assert outcome.errors or len(outcome.results) < n_ranks, \
        "injected failure was not observed anywhere"
    if recover_after:
        survivors = recover(world)
        outcome.survivors = survivors
        assert victim not in survivors.ranks
        assert survivors.size == n_ranks - 1
        scoll = Collectives(survivors)
        rkw = {} if hierarchical else {"algorithm": algorithm}
        out = scoll.run_group(
            "allreduce",
            [{"value": values[wr]} for wr in survivors.ranks],
            op="sum", key="fh-rec", **rkw)
        outcome.recovered = {gr: out[gr] for gr in range(survivors.size)}
        ref = np.sum([values[wr] for wr in survivors.ranks], axis=0)
        for v in outcome.recovered.values():
            np.testing.assert_allclose(v, ref, rtol=1e-10, atol=1e-12)
    return outcome
