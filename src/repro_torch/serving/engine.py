"""Continuous-batching inference engine on the task runtime — the port of
``repro/serving/engine.py`` on the port's ``TaskRuntime``, ``tac`` (CUDA
events) and ``resilience``.

The serving tentpole: requests flow through a
:class:`repro_torch.serving.queue.RequestQueue`, an admission/eviction
scheduler keeps at most ``slots`` of them in flight, and EVERY unit of
work — each prefill, each decode micro-step, each host detokenisation —
is one :class:`repro_torch.core.executor.TaskRuntime` task.  Dataflow
tokens (``Request.chain`` / ``Request.detok_chain``) order one request's
micro-steps; requests share nothing, so the runtime interleaves them
freely — continuous batching falls out of task dependencies, there is
no batching loop.

Two completion legs, selected by ``completion=``:

* ``"event"`` (the paper's discipline) — the decode task only
  *dispatches* device work and completes an
  :class:`repro_torch.core.tac.EventHandle`; a separate detok task is
  bound to that event through the unified
  :class:`repro_torch.core.tac.AsyncHandle` protocol (``tac.wait`` →
  continuation engine), so host detokenisation overlaps the next decode
  steps and the device chain never stalls.
* ``"blocking"`` (the sentinel baseline of paper §7.1) — the decode
  task synchronises the device result and detokenises inline, chaining
  host work into the device-step dependency chain exactly like the
  artificial sentinel dependency the paper removes.

Both legs emit identical tokens (asserted by
``tests/test_torch_serving.py``).

Failure handling reuses the ULFM path of
:mod:`repro_torch.core.resilience`: run the engine stepwise
(``sync_every=1``) over a :class:`repro_torch.core.tac.CommWorld` and a
tensor-parallel allreduce rides every micro-step; when a rank dies, the
collective surfaces :class:`~repro_torch.core.tac.RankFailedError` out of
``taskwait``, the scheduler evicts every in-flight request back to the
queue head, revokes + shrinks the world
(:func:`repro_torch.core.resilience.recover`), rebuilds the collectives
over the survivors, and re-admits — each request restarts from prefill
under a fresh incarnation, so its state machine survives the failure.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core import resilience, tac
from ..core.collectives import Collectives
from ..core.executor import TaskError, TaskRuntime
from ..core.tac import CommRevokedError, RankFailedError
from ..obs import trace as _tr
from ..obs.metrics import MetricSink, TokenRecord
from .metrics import ServeReport
from .queue import RequestQueue
from .request import Request, RequestState

__all__ = ["ServingEngine"]


def _weak(method: Callable[..., Any]) -> Callable[..., Any]:
    """``method`` called through a weak reference to its engine.  The
    runtime's task graph is cyclic (tasks, their event counters and the
    runtime reference one another), so it lives until the cyclic collector
    runs; a task body bound to the engine would keep the engine, its
    adapter and the adapter's model alive that long after :meth:`run`
    returns.  The engine is alive whenever one of its tasks runs: ``run``
    holds it until the last task has finished."""
    ref = weakref.WeakMethod(method)

    def call(*args: Any) -> Any:
        return ref()(*args)

    return call


class ServingEngine:
    """Admission/eviction scheduler + task-graph executor for serving.

    ``adapter`` supplies the model: ``prefill(request) -> (tok, state)``
    dispatches the prompt pass and returns the first generated token
    (device value) plus the decode state (KV cache);
    ``decode(request, state, step) -> (tok, state)`` dispatches one
    decode micro-step; ``detok(request, step, tok) -> value`` is the
    host-side detokenisation of a device-complete token.

    ``slots`` bounds concurrent in-flight requests; ``priority`` decides
    preemption — in stepwise mode a queued request preempts (evicts) a
    strictly lower-priority in-flight one when no slot is free.

    ``world=`` + ``tp_elems>0`` adds a tensor-parallel allreduce over
    the communicator to every micro-step; with ``sync_every=1`` a rank
    failure is recovered ULFM-style (see module docstring).
    """

    def __init__(self, adapter: Any, *, slots: int = 4,
                 completion: str = "event",
                 runtime: Optional[TaskRuntime] = None,
                 num_workers: Optional[int] = None,
                 notify: Optional[str] = None,
                 sync_every: int = 0,
                 world: Any = None, tp_elems: int = 0,
                 on_round: Optional[Callable[["ServingEngine", int],
                                             None]] = None) -> None:
        if completion not in ("event", "blocking"):
            raise ValueError(f"unknown completion leg {completion!r}; "
                             f"one of ['event', 'blocking']")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if sync_every < 0:
            raise ValueError(f"sync_every must be >= 0, got {sync_every}")
        self.adapter = adapter
        self.slots = slots
        self.completion = completion
        if completion == "event":
            # The event leg NEEDS the TASK_MULTIPLE interoperability
            # level: without it tac.iwait degrades to a blocking wait
            # inside the decode task body (the legacy-library fallback
            # of §6.3) and the leg silently becomes the sentinel.
            tac.init(tac.TASK_MULTIPLE)
        self.sync_every = sync_every
        self.on_round = on_round
        self._ext_runtime = runtime
        self._num_workers = num_workers or max(4, slots + 2)
        self._notify = notify

        self._world = world
        self._tp_elems = tp_elems
        self._comm = world
        self._coll = (Collectives(world) if world is not None
                      and tp_elems > 0 else None)

        self._lock = threading.Lock()
        self.queue = RequestQueue()
        self.active: Dict[int, Request] = {}
        self.metrics = MetricSink()
        self.recoveries = 0
        self.admission_log: List[int] = []   # rids, in admission order
        self.eviction_log: List[int] = []    # rids, in eviction order
        self._t0 = 0.0

    # -- task bodies --------------------------------------------------------
    def _tp_allreduce(self, req: Request, step: int) -> None:
        """The tensor-parallel leg of one micro-step (optional)."""
        if self._coll is None:
            return
        n = self._coll.world.size
        val = np.ones(self._tp_elems, np.float32)
        self._coll.run_group(
            "allreduce", [{"value": val} for _ in range(n)],
            op="sum", key=("tp", req.rid, req.incarnation, step))

    def _device_step(self, req: Request, step: int) -> Any:
        """One prefill/decode micro-step on the request's device chain.

        Event leg: dispatch, then ``tac.iwait`` the token's handle — the
        task body returns immediately and its *dependency release* is
        bound to device completion through the continuation engine
        (§6.2), so the detok task's RAW dependency opens exactly when
        the token is ready and nobody ever blocks a worker.

        Blocking-sentinel leg: OS-blocking ``handle.wait()`` (the PMPI
        path) plus host detok INSIDE the device chain — the artificial
        serialisation of paper §7.1.
        """
        t0 = time.monotonic() if _tr.TRACING else 0.0
        self._tp_allreduce(req, step)
        if step == 0:
            tok, state = self.adapter.prefill(req)
            with self._lock:
                req.cache = state
                if req.state is RequestState.PREFILL:
                    req.to(RequestState.DECODE)
        else:
            tok, state = self.adapter.decode(req, req.cache, step)
            req.cache = state
        if self.completion == "event":
            req._toks[step] = tok       # type: ignore[attr-defined]
            tac.iwait(tac.as_handle(tok))
            if _tr.TRACING:
                _tr.TRACER.span("serving", "device_step", t0,
                                time.monotonic(), rid=req.rid, step=step,
                                completion=self.completion)
            return tok
        tok = tac.as_handle(tok).wait()     # blocks this worker
        self._emit(req, step, tok)
        if _tr.TRACING:
            _tr.TRACER.span("serving", "device_step", t0, time.monotonic(),
                            rid=req.rid, step=step,
                            completion=self.completion)
        return tok

    def _detok_task(self, req: Request, step: int) -> None:
        """Event-leg host consumer: runs once its RAW dependency on the
        decode task releases — i.e. once the device value completed —
        so the token is ready and the host work starts immediately."""
        tok = req._toks.pop(step, None)     # type: ignore[attr-defined]
        if tok is None:
            return      # the producing step failed; nothing to emit
        t0 = time.monotonic() if _tr.TRACING else 0.0
        self._emit(req, step, tok)
        if _tr.TRACING:
            _tr.TRACER.span("serving", "detok", t0, time.monotonic(),
                            rid=req.rid, step=step)

    def _emit(self, req: Request, step: int, tok: Any) -> None:
        val = self.adapter.detok(req, step, tok)
        now = time.monotonic() - self._t0
        with self._lock:
            req.tokens.append((step, val))
            self.metrics.emit(TokenRecord(
                rid=req.rid, step=step,
                t_submit=req._t_submit[step],    # type: ignore[attr-defined]
                t_emit=now))
        if _tr.TRACING:
            lat = now - req._t_submit[step]  # type: ignore[attr-defined]
            _tr.TRACER.instant("serving", "token", rid=req.rid, step=step,
                               latency_s=lat)

    def _finish(self, req: Request) -> None:
        """Retire the request — but only if every token actually
        emitted — and drop its decode state (the KV cache).  A failed
        micro-step force-releases its dependents (so the graph drains
        instead of hanging), which means this task can run on an
        incomplete request: leave it in flight and let the failure sweep
        of ``_handle_failure`` evict + re-admit it."""
        with self._lock:
            if req.state is RequestState.DECODE \
                    and len(req.tokens) == req.gen_len:
                req.to(RequestState.DONE)
                req.finished_at = time.monotonic() - self._t0
                req.cache = None
                self.active.pop(req.rid, None)

    # -- scheduling ---------------------------------------------------------
    def _admit(self, req: Request) -> None:
        with self._lock:
            req.to(RequestState.PREFILL)
            req.admitted_at = time.monotonic() - self._t0
            req._t_submit = {}          # type: ignore[attr-defined]
            req._toks = {}              # type: ignore[attr-defined]
            self.active[req.rid] = req
            self.admission_log.append(req.rid)

    def _evict(self, req: Request, *, front: bool) -> None:
        """Drop the request's cache and return it to the queue."""
        with self._lock:
            req.to(RequestState.EVICTED)
            req.reset_for_requeue()
            self.active.pop(req.rid, None)
            self.eviction_log.append(req.rid)
        (self.queue.push_front if front else self.queue.push)(req)

    def evict(self, rid: int) -> None:
        """Explicit preemption hook (stepwise mode: call from
        ``on_round``, between fully-drained rounds)."""
        req = self.active.get(rid)
        if req is None:
            raise KeyError(f"request {rid} is not in flight")
        self._evict(req, front=False)

    def _preempt(self) -> None:
        """Evict the worst in-flight request when the queue head is
        strictly more urgent and no slot is free (stepwise only)."""
        while True:
            head = self.queue.peek()
            if head is None or len(self.active) < self.slots:
                return
            with self._lock:
                victim = max(self.active.values(),
                             key=lambda r: (r.priority, r.rid),
                             default=None)
            if victim is None or victim.priority <= head.priority:
                return
            self._evict(victim, front=False)

    def _submit_step(self, rt: TaskRuntime, req: Request) -> None:
        step = req.submitted_steps
        now = time.monotonic() - self._t0
        req._t_submit[step] = now       # type: ignore[attr-defined]
        kind = "prefill" if step == 0 else "decode"
        if self.completion == "event":
            # The decode task WRITES the step's token slot and iwaits the
            # device handle, so the detok task's READ of that slot opens
            # at device completion; successive decode steps depend only
            # on the chain (WAW) — detok never sits on the device chain.
            slot = (req.chain, "tok", step)
            rt.submit(_weak(self._device_step), req, step,
                      inout=[req.chain], out=[slot],
                      name=f"{kind}:{req.rid}@{step}")
            rt.submit(_weak(self._detok_task), req, step, in_=[slot],
                      inout=[req.detok_chain],
                      name=f"detok:{req.rid}@{step}")
        else:
            rt.submit(_weak(self._device_step), req, step,
                      inout=[req.chain], name=f"{kind}:{req.rid}@{step}")
        req.submitted_steps = step + 1
        if req.submitted_steps == req.gen_len:
            # finish orders after the device chain AND (event leg) the
            # detok chain, so the completeness check in _finish sees
            # every emitted token.
            chains = [req.chain] if self.completion == "blocking" \
                else [req.chain, req.detok_chain]
            rt.submit(_weak(self._finish), req, inout=chains,
                      name=f"finish:{req.rid}")

    def _handle_failure(self, err: BaseException) -> None:
        """ULFM recovery: evict in-flight requests, shrink, rebuild."""
        if not isinstance(err, (RankFailedError, CommRevokedError)) \
                or self._world is None:
            raise err
        with self._lock:
            inflight = [r for r in self.active.values()
                        if r.state in (RequestState.PREFILL,
                                       RequestState.DECODE)]
        for req in inflight:
            self._evict(req, front=True)
        group = resilience.recover(self._world)
        self._comm = group
        self._coll = Collectives(group) if self._tp_elems > 0 else None
        self.recoveries += 1

    # -- the driver loop ----------------------------------------------------
    def run(self, requests: Sequence[Request]) -> ServeReport:
        """Serve ``requests`` (arrival times honoured) to completion."""
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        rt = self._ext_runtime or TaskRuntime(
            num_workers=self._num_workers, notify=self._notify)
        rt.start()
        self._t0 = time.monotonic()
        rounds = 0
        try:
            while pending or self.queue or self.active:
                now = time.monotonic() - self._t0
                while pending and pending[0].arrival_s <= now:
                    self.queue.push(pending.pop(0))
                if not self.queue and not self.active:
                    # idle until the next arrival
                    time.sleep(min(max(pending[0].arrival_s - now, 0.0),
                                   0.005))
                    continue
                if self.on_round is not None:
                    self.on_round(self, rounds)
                if self.sync_every:
                    self._preempt()
                while len(self.active) < self.slots and self.queue:
                    req = self.queue.pop()
                    self._admit(req)
                with self._lock:
                    runnable = [r for r in self.active.values()
                                if r.submitted_steps < r.gen_len]
                for req in sorted(runnable, key=lambda r: r.rid):
                    self._submit_step(rt, req)
                rounds += 1
                if self.sync_every and rounds % self.sync_every == 0:
                    try:
                        rt.taskwait()
                    except TaskError as exc:
                        self._handle_failure(exc.error)
                elif not runnable:
                    # all steps submitted: give finish tasks air
                    time.sleep(0.001)
            rt.taskwait()
        finally:
            if self._ext_runtime is None:
                rt.close()
        wall = time.monotonic() - self._t0
        outputs = {}
        evictions = 0
        for req in requests:
            outputs[req.rid] = [v for _, v in sorted(req.tokens)]
            evictions += req.evictions
        return ServeReport.build(self.completion, self.metrics.records,
                                 wall, outputs, evictions,
                                 self.recoveries)
