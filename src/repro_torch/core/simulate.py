"""Deterministic discrete-event makespan simulator for task schedules --
the port's copy of ``repro/core/simulate.py`` (standard library only: the
same Python floats in the same order, so every makespan, ``SimResult``
field and replayed trace equals the reference's exactly).

The paper evaluates TAMPI on a 64-node cluster with wall-clock traces
(Figs. 9–14).  One machine cannot reproduce those scaling curves
directly; instead the benchmarks pair *real* executions of the host task
runtime (small scale) with this simulator, which replays the exact task
graphs of each benchmark version under a machine model (ranks × workers,
per-message latency, task overheads) and reports the makespan.  The
simulator models the four execution disciplines that distinguish the
paper's versions:

* ``compute``        — plain task: worker busy for ``compute`` seconds.
* ``comm-held``      — blocking communication *without* TAMPI: the worker is
                       held until the matching remote event arrives (this is
                       what makes unconstrained blocking calls deadlock-prone
                       and what the Sentinel pattern works around).
* ``comm-paused``    — TAMPI blocking mode (§6.1): worker is released during
                       the wait; on completion the task pays a scheduler
                       round-trip (``resume_overhead``) on a worker to finish.
* ``comm-events``    — TAMPI non-blocking mode (§6.2): the task finishes
                       immediately after its body; its *release* (and hence
                       its successors' readiness) is deferred to the event
                       arrival.  No worker re-acquisition, no held stack.

Dependencies are split accordingly: ``start_deps`` gate the task's start
(regular data flow), ``event_deps`` are bound external events that gate only
its release.  Cross-rank edges carry a latency.

**Collective nodes**: tasks sharing a ``group`` label model one collective
operation — every member must *enter* (finish its body) before any member
completes, plus ``group_latency`` (≈ rounds × per-message latency, see
``collectives.n_rounds``).  The waiting discipline is the member's ``kind``:
``comm-held`` members hold their worker until the last rank arrives (the
sentinel/serialized collective), ``comm-paused`` pause and pay a resume,
``comm-events`` finish immediately and defer their release to collective
completion (the event-bound collective).  Internally a group is expanded
into pairwise event edges, so all four disciplines compose unchanged.

**Neighbourhood nodes**: a comm task with ``neighbors=[(peer id, latency),
...]`` models one rank's round of a *neighbourhood* collective (halo
exchange): it completes once every listed peer has entered (peer body done
+ that edge's latency) — no all-ranks barrier, only the declared halo
edges.  Unlike raw ``event_deps``, neighbour edges are validated (peers
must be comm-kind tasks, so a ``compute`` node cannot silently become a
message source) and declared symmetrically by each member of the exchange.
The waiting discipline is again the task's ``kind``.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

COMPUTE = "compute"
COMM_HELD = "comm-held"
COMM_PAUSED = "comm-paused"
COMM_EVENTS = "comm-events"

Dep = Tuple[int, float]  # (task id, edge latency)


@dataclass
class SimTask:
    id: int
    rank: int
    compute: float
    kind: str = COMPUTE
    start_deps: List[Dep] = field(default_factory=list)
    event_deps: List[Dep] = field(default_factory=list)
    name: str = ""
    group: Optional[str] = None      # collective membership label
    group_latency: float = 0.0       # arrival→completion lag of the group
    neighbors: List[Dep] = field(default_factory=list)  # halo peer edges

    # runtime state
    _pending_start: int = 0
    _pending_events: int = 0
    _had_events: bool = False
    _body_done_at: Optional[float] = None
    _holding_worker: bool = False
    done_time: Optional[float] = None
    start_time: Optional[float] = None


@dataclass
class SimResult:
    makespan: float
    done_times: Dict[int, float]
    busy_time: Dict[int, float]           # per rank
    held_wait_time: Dict[int, float]      # worker-seconds wasted holding
    max_paused: int                        # peak #paused tasks (live stacks)
    resumes: int                           # scheduler round trips paid
    failed: Set[int] = field(default_factory=set)  # tasks lost to rank death

    def utilization(self, workers_per_rank: int, n_ranks: int) -> float:
        total = self.makespan * workers_per_rank * n_ranks
        return sum(self.busy_time.values()) / total if total else 0.0


class Simulator:
    """List-scheduling discrete-event simulator over per-rank worker pools.

    ``dispatch_overhead`` models the completion-notification cost of the
    continuation backend (:mod:`repro_torch.core.continuations`): when the
    *last* pending event of a task arrives, its completion callback is
    dispatched from the engine's queue ``dispatch_overhead`` seconds
    later — the per-completion term of :func:`progress_cost`.  The
    polling backend's per-tick re-test cost is not an event in this DAG
    model (it scales with wall time, not with the graph); use
    :func:`progress_cost` to account for it analytically.
    """

    def __init__(self, n_ranks: int, workers_per_rank: int, *,
                 task_overhead: float = 0.0,
                 resume_overhead: float = 0.0,
                 dispatch_overhead: float = 0.0) -> None:
        self.n_ranks = n_ranks
        self.workers = workers_per_rank
        self.task_overhead = task_overhead
        self.resume_overhead = resume_overhead
        self.dispatch_overhead = dispatch_overhead

    def run(self, tasks: List[SimTask],
            fail: Optional[Tuple[int, float]] = None) -> SimResult:
        """Replay the task graph; ``fail=(rank, time)`` injects rank death.

        Simulated ULFM semantics (deterministic large-n replay of what
        :class:`repro_torch.core.resilience.FaultInjector` does to the real
        runtime): at ``time`` the rank's workers stop — its queued tasks
        never dispatch, its in-flight bodies never complete — while
        anything the dead rank finished *before* the failure stays
        delivered (messages in flight arrive).  Tasks that consequently
        never complete (the dead rank's remainder plus its transitive
        dependency cone, through start, event, neighbour, and collective
        edges alike) are reported in :attr:`SimResult.failed` instead of
        raising the deadlock error; the makespan covers the survivors.
        """
        byid = {t.id: t for t in tasks}
        succ_start: Dict[int, List[Dep]] = {t.id: [] for t in tasks}
        succ_event: Dict[int, List[Dep]] = {t.id: [] for t in tasks}
        for t in tasks:
            t._pending_start = len(t.start_deps)
            t._pending_events = len(t.event_deps)
            t._had_events = bool(t.event_deps)
            t._body_done_at = None
            t._holding_worker = False
            t.done_time = None
            t.start_time = None
            for dep, lat in t.start_deps:
                succ_start[dep].append((t.id, lat))
            for dep, lat in t.event_deps:
                succ_event[dep].append((t.id, lat))

        # Neighbourhood nodes: halo edges from the declared peers only —
        # completion is max(own body done, peer arrival + edge latency).
        # Expanded into event edges (non-destructively, per run).
        for t in tasks:
            if not t.neighbors:
                continue
            if t.kind == COMPUTE:
                raise ValueError(
                    f"neighbourhood node {t.name or t.id} must use a comm "
                    f"kind (held/paused/events), not {COMPUTE!r}")
            for pid, lat in t.neighbors:
                peer = byid.get(pid)
                if peer is None:
                    raise ValueError(f"neighbourhood node {t.name or t.id} "
                                     f"references unknown task {pid}")
                if peer.kind == COMPUTE:
                    raise ValueError(
                        f"neighbour peer {peer.name or pid} of "
                        f"{t.name or t.id} must be a comm-kind task")
                t._pending_events += 1
                t._had_events = True
                succ_event[pid].append((t.id, lat))

        # Collective groups: each member waits (per its kind's discipline)
        # for every other member's arrival + the group's round latency —
        # expanded into pairwise event edges (non-destructively, per run).
        groups: Dict[str, List[SimTask]] = {}
        for t in tasks:
            if t.group is not None:
                if t.kind == COMPUTE:
                    raise ValueError(
                        f"collective member {t.name or t.id} must use a "
                        f"comm kind (held/paused/events), not {COMPUTE!r}")
                groups.setdefault(t.group, []).append(t)
        for members in groups.values():
            for t in members:
                # Edges from every member INCLUDING itself: completion is
                # last-arrival + group_latency for all members (the last
                # arriver still pays the rounds after it enters).
                if len(members) > 1 or t.group_latency > 0.0:
                    t._pending_events += len(members)
                    t._had_events = True
                    for m in members:
                        succ_event[m.id].append((t.id, t.group_latency))

        free = {r: self.workers for r in range(self.n_ranks)}
        ready: Dict[int, List[Tuple[int, SimTask]]] = {
            r: [] for r in range(self.n_ranks)}  # (priority, task) FIFO-ish
        resume_q: Dict[int, List[SimTask]] = {r: [] for r in range(self.n_ranks)}
        busy = {r: 0.0 for r in range(self.n_ranks)}
        held = {r: 0.0 for r in range(self.n_ranks)}
        paused = 0
        max_paused = 0
        resumes = 0

        seq = itertools.count()
        heap: List[Tuple[float, int, str, int]] = []  # (t, seq, kind, task id)

        def push(t: float, kind: str, tid: int) -> None:
            heapq.heappush(heap, (t, next(seq), kind, tid))

        dead_ranks: Set[int] = set()
        if fail is not None:
            fail_rank, fail_time = fail
            if not 0 <= fail_rank < self.n_ranks:
                raise ValueError(f"fail rank {fail_rank} out of range for "
                                 f"{self.n_ranks} ranks")
            push(float(fail_time), "rank-fail", fail_rank)

        now = 0.0
        for t in tasks:
            if t._pending_start == 0:
                ready[t.rank].append((next(seq), t))

        def finish(task: SimTask, t: float) -> None:
            # Full completion (= dependency release): gates start_deps.
            task.done_time = t
            for sid, lat in succ_start[task.id]:
                push(t + lat, "start-arr", sid)

        def dispatch(rank: int, t: float) -> None:
            nonlocal paused, resumes
            if rank in dead_ranks:
                return          # dead workers dispatch nothing
            while free[rank] > 0 and (resume_q[rank] or ready[rank]):
                if resume_q[rank]:
                    task = resume_q[rank].pop(0)
                    free[rank] -= 1
                    paused -= 1
                    resumes += 1
                    dur = self.resume_overhead
                    busy[rank] += dur
                    push(t + dur, "resume-done", task.id)
                    continue
                _, task = ready[rank].pop(0)
                free[rank] -= 1
                task.start_time = t
                dur = task.compute + self.task_overhead
                busy[rank] += dur
                push(t + dur, "body-done", task.id)

        dirty = set(range(self.n_ranks))

        def flush(t: float) -> None:
            for r in list(dirty):
                dirty.discard(r)
                dispatch(r, t)

        flush(now)
        while heap:
            now, _, kind, tid = heapq.heappop(heap)
            if kind == "rank-fail":
                dead_ranks.add(tid)
                continue
            task = byid[tid]
            r = task.rank
            if r in dead_ranks:
                # The dead rank's pending events evaporate: a body that
                # was mid-flight at the failure never completes, so none
                # of its outgoing message/collective edges ever fire —
                # while everything it finished earlier stays delivered.
                continue
            if kind == "start-arr":
                task._pending_start -= 1
                if task._pending_start == 0:
                    ready[r].append((next(seq), task))
                    dirty.add(r)
            elif kind == "body-done":
                task._body_done_at = now
                # Matching/posting semantics: bound external events of *other*
                # tasks fire when this task's body completes (an MPI ssend
                # matches when the recv is posted, not when the recv *task*
                # releases its dependencies).  Start deps, by contrast, wait
                # for the full release — that distinction is the essence of
                # the non-blocking mode's dependency graph.
                for sid, lat in succ_event[task.id]:
                    push(now + lat, "event-arr", sid)
                if task.kind == COMPUTE or task._pending_events == 0:
                    if task.kind == COMM_PAUSED and task._had_events:
                        # events already arrived: still pay the round trip
                        free[r] += 1
                        paused += 1
                        max_paused = max(max_paused, paused)
                        resume_q[r].append(task)
                    else:
                        free[r] += 1
                        finish(task, now)
                    dirty.add(r)
                elif task.kind == COMM_HELD:
                    task._holding_worker = True  # worker NOT released
                elif task.kind == COMM_PAUSED:
                    free[r] += 1
                    paused += 1
                    max_paused = max(max_paused, paused)
                    dirty.add(r)
                elif task.kind == COMM_EVENTS:
                    free[r] += 1  # worker moves on; release deferred
                    dirty.add(r)
                else:
                    raise ValueError(task.kind)
            elif kind == "event-arr":
                task._pending_events -= 1
                if task._pending_events == 0 and task._body_done_at is not None:
                    if self.dispatch_overhead > 0.0:
                        # Continuation backend: the completion callback is
                        # dispatched from the queue, one overhead later.
                        push(now + self.dispatch_overhead, "event-fire",
                             task.id)
                    else:
                        push(now, "event-fire", task.id)
            elif kind == "event-fire":
                if task.kind == COMM_HELD:
                    held[r] += now - task._body_done_at
                    busy[r] += now - task._body_done_at
                    free[r] += 1
                    finish(task, now)
                elif task.kind == COMM_PAUSED:
                    resume_q[r].append(task)
                elif task.kind == COMM_EVENTS:
                    finish(task, now)
                dirty.add(r)
            elif kind == "resume-done":
                free[r] += 1
                finish(task, now)
                dirty.add(r)
            # Dispatch after draining simultaneous events at this timestamp.
            if not heap or heap[0][0] > now:
                flush(now)

        unfinished = [t for t in tasks if t.done_time is None]
        if unfinished and fail is None:
            names = [t.name or str(t.id) for t in unfinished[:5]]
            raise RuntimeError(
                f"simulation deadlock: {len(unfinished)} tasks never "
                f"completed (e.g. {names}) — exactly the §5 scenario")
        finished = [t for t in tasks if t.done_time is not None]
        makespan = max((t.done_time for t in finished), default=0.0)
        return SimResult(makespan=makespan,
                         done_times={t.id: t.done_time for t in finished},
                         busy_time=busy, held_wait_time=held,
                         max_paused=max_paused, resumes=resumes,
                         failed={t.id for t in unfinished})


# ---------------------------------------------------------------------------
# Trace replay: SimTask timelines -> repro_torch.obs span events
# ---------------------------------------------------------------------------
def trace_events(tasks: List[SimTask]) -> List[dict]:
    """Chrome-trace events for a simulated run — same schema as the host.

    Call after :meth:`Simulator.run` (the tasks carry their timestamps).
    Each task body becomes a ``task/run`` span labelled ``compute`` or
    ``comm``; each comm-kind task's wait window (body done → completion)
    becomes a ``handle/inflight`` span, and :data:`COMM_PAUSED` waits
    additionally emit the ``task/pause`` span the host runtime's
    spare-thread block would.  Events carry ``source="sim"`` and validate
    against :func:`repro_torch.obs.trace.SPAN_SCHEMA`, so
    :func:`repro_torch.obs.analysis.overlap_fraction` computes the *same*
    number from a simulated replay as from a host trace — the oracle
    ``tests/test_obs.py`` exploits.
    """
    from ..obs.trace import span_event

    events: List[dict] = []
    for t in tasks:
        if t.start_time is None or t._body_done_at is None:
            continue                      # never ran (failed rank)
        t0 = t.start_time * 1e6
        t1 = t._body_done_at * 1e6
        label = "compute" if t.kind == COMPUTE else "comm"
        if t1 > t0:                       # zero-compute proxies add noise
            events.append(span_event(
                "task", "run", t0, t1 - t0, rank=t.rank,
                task=t.name or str(t.id), label=label, source="sim"))
        if t.kind == COMPUTE or t.done_time is None:
            continue
        t2 = t.done_time * 1e6
        if t2 > t1:
            events.append(span_event(
                "handle", "inflight", t1, t2 - t1, rank=t.rank,
                kind=t.kind, task=t.name or str(t.id), source="sim"))
            if t.kind == COMM_PAUSED:
                events.append(span_event(
                    "task", "pause", t1, t2 - t1, rank=t.rank,
                    task=t.name or str(t.id), mode="sim", source="sim"))
    events.sort(key=lambda e: e["ts"])
    return events


# ---------------------------------------------------------------------------
# Progress-path cost: the α-β term of the two notification backends
# ---------------------------------------------------------------------------
def progress_cost(backend: str, *, in_flight: float, ticks: float,
                  completions: float, test_s: float,
                  dispatch_s: float) -> float:
    """Analytic progress-engine cost of one notification backend.

    The α-β model's missing term: moving bytes is only part of a
    communication task's cost — somebody must also *notice* completions.

    * ``"polling"`` — the registry re-tests every in-flight operation
      each tick and pays a dispatch per completion:
      ``test_s·in_flight·ticks + dispatch_s·completions``.  Per tick the
      cost is **linear in the number of in-flight operations**, even
      when nothing completed.
    * ``"continuation"`` — completions are pushed at match time and only
      ready callbacks are dispatched: ``dispatch_s·completions``.  Per
      tick the cost is **flat** (zero when nothing completed), total
      work O(completions) regardless of how many operations are parked.

    The discrete-event counterpart of the dispatch term is
    ``Simulator(dispatch_overhead=dispatch_s)``;
    ``benchmarks/overlap_bench.py`` measures both backends against this
    model over an in-flight sweep.
    """
    if backend == "continuation":
        return dispatch_s * completions
    if backend == "polling":
        return test_s * in_flight * ticks + dispatch_s * completions
    raise ValueError(f"unknown backend {backend!r}; "
                     f"one of ('polling', 'continuation')")


# ---------------------------------------------------------------------------
# Schedule-IR replay: one Schedule -> a SimTask graph
# ---------------------------------------------------------------------------
def two_tier_link(intra: int, *, alpha: float, beta: float,
                  inter_alpha: float, inter_beta: float):
    """Per-transfer (α, β) for a two-tier (pod) machine.

    Ranks are numbered ``r = pod·intra + local`` (the
    :func:`repro_torch.core.schedule.build_hierarchical` layout); transfers
    between ranks of different pods pay the inter-pod constants.  Pass
    the result as ``link=`` to :func:`schedule_tasks` /
    :func:`schedule_makespan` — it applies to ANY schedule over that rank
    layout, which is what makes the hierarchical-vs-flat-ring replay an
    apples-to-apples comparison on the same machine model.
    """
    def link(src: int, dst: int):
        if src // intra != dst // intra:
            return inter_alpha, inter_beta
        return alpha, beta
    return link


def schedule_tasks(sched, *, size: float, alpha: float, beta: float,
                   gamma: float = 0.0, kind: str = COMM_EVENTS,
                   base_id: int = 0, name_prefix: str = "",
                   link=None) -> List[SimTask]:
    """Expand a :class:`repro_torch.core.schedule.Schedule` into a SimTask
    graph.

    The discrete-event counterpart of :meth:`Schedule.cost`: each matched
    Send/Recv pair becomes a comm task on the destination rank whose
    external event arrives ``α + β·frac·size`` after the payload's
    producer finishes; each ``Combine`` becomes a compute task of
    ``γ·frac·size`` seconds occupying a worker — so with one worker per
    rank, combines serialise per rank while independent transfers fly,
    which is exactly what lets a segmented schedule's transport overlap
    its combines.  Marshalling ops (Copy/Pack/Unpack/Slice/Const) carry
    dependencies but no tasks.

    ``kind`` picks the transfer tasks' waiting discipline (``comm-events``
    by default — the event-bound collective; ``comm-paused`` /
    ``comm-held`` model the blocking and sentinel-serialised runs).
    ``link`` optionally maps ``(src rank, dst rank)`` to that transfer's
    ``(α, β)`` — a heterogeneous machine model; :func:`two_tier_link`
    builds the pod-aware one that makes hierarchical schedules pay cheap
    intra-pod and expensive inter-pod constants.  Returns tasks with ids
    starting at ``base_id``; feed them to :class:`Simulator`
    (``n_ranks=sched.n``), possibly merged with other graphs.
    """
    from .schedule import Combine, Concat, Const, Copy, Pack, Recv, Send, \
        Slice, Unpack

    tasks: List[SimTask] = []
    ids = itertools.count(base_id)

    def new_task(rank, compute, kind_, name, start=(), events=()):
        t = SimTask(next(ids), rank, compute, kind=kind_,
                    start_deps=[(d, 0.0) for d in start],
                    event_deps=list(events),
                    name=f"{name_prefix}{name}")
        tasks.append(t)
        return t.id

    # producers[r][buf] -> set of task ids whose completion makes buf ready
    producers: List[Dict] = []
    entry = []
    for r in range(sched.n):
        eid = new_task(r, 0.0, COMPUTE, f"in[{r}]")
        entry.append(eid)
        producers.append({b: {eid} for b in sched._initial_bufs(r)})

    arrivals: Dict = {}     # transfer tag -> (deps of the sent payload)
    pcs = [0] * sched.n
    remaining = sum(len(p) for p in sched.programs)
    while remaining:
        progressed = False
        for r in range(sched.n):
            prog = sched.programs[r]
            while pcs[r] < len(prog):
                op = prog[pcs[r]]
                deps = producers[r]
                if isinstance(op, Recv):
                    if op.tag not in arrivals:
                        break
                    a, bt = (alpha, beta) if link is None \
                        else link(op.peer, r)
                    lat = a + bt * op.frac * size
                    cid = new_task(
                        r, 0.0, kind, f"xfer:{op.tag}",
                        events=[(d, lat) for d in arrivals[op.tag]])
                    # proxy whose BODY completion == transfer completion,
                    # so downstream event edges measure from the right
                    # instant (event edges fire at body-done).
                    pid = new_task(r, 0.0, COMPUTE, f"got:{op.tag}",
                                   start=[cid])
                    deps[op.buf] = {pid}
                elif isinstance(op, Send):
                    arrivals[op.tag] = frozenset(deps[op.buf])
                elif isinstance(op, Combine):
                    kid = new_task(r, gamma * op.frac * size, COMPUTE,
                                   f"combine:{op.out}",
                                   start=sorted(deps[op.a] | deps[op.b]))
                    deps[op.out] = {kid}
                elif isinstance(op, Copy):
                    deps[op.out] = set(deps[op.src])
                elif isinstance(op, Pack):
                    merged: Set[int] = set()
                    for p in op.parts:
                        merged |= deps[p]
                    deps[op.out] = merged
                elif isinstance(op, Unpack):
                    for o in op.outs:
                        deps[o] = set(deps[op.src])
                elif isinstance(op, Slice):
                    deps[op.out] = set(deps[op.src])
                elif isinstance(op, Concat):
                    merged = set()
                    for p in op.reads:
                        merged |= deps[p]
                    deps[op.out] = merged
                elif isinstance(op, Const):
                    deps[op.out] = {entry[r]}
                else:           # pragma: no cover - new op kinds
                    raise TypeError(f"cannot simulate op {op!r}")
                pcs[r] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            stuck = [r for r in range(sched.n)
                     if pcs[r] < len(sched.programs[r])]
            raise RuntimeError(f"schedule deadlock while expanding: "
                               f"ranks {stuck} cannot progress")
    return tasks


def schedule_makespan(sched, *, size: float, alpha: float, beta: float,
                      gamma: float = 0.0, kind: str = COMM_EVENTS,
                      workers_per_rank: int = 1,
                      task_overhead: float = 0.0,
                      resume_overhead: float = 0.0,
                      link=None) -> float:
    """Discrete-event makespan of one schedule under the α-β(-γ) model —
    the simulator-side twin of :meth:`Schedule.cost` (which is analytic
    and additionally serialises send ports).  ``link`` (see
    :func:`two_tier_link`) replays the DAG on a heterogeneous machine."""
    tasks = schedule_tasks(sched, size=size, alpha=alpha, beta=beta,
                           gamma=gamma, kind=kind, link=link)
    sim = Simulator(sched.n, workers_per_rank, task_overhead=task_overhead,
                    resume_overhead=resume_overhead)
    return sim.run(tasks).makespan
