"""IFSKer benchmark on the port — paper §7.2 (Fig. 14).

The port of ``benchmarks/ifsker.py``: a mock-up of the IFS
spectral-transform weather code, timestep cycles of grid-point physics and
Fourier transforms with a data transposition (all-to-all) between phases.
Grid space distributes *points* across ranks; spectral space distributes
*fields*; the transitions redistribute.  The same three versions:

* ``pure``           — sequential phases with a full exchange between them
                       (``Collectives.run_group("alltoall")``).
* ``interop-blk``    — the transposition is a per-rank Level-A ``alltoall``
                       in *blocking* mode (pause/resume per round).
* ``interop-nonblk`` — the same ``alltoall`` in *event-bound* mode.

What changes is where the data lives: the fields are float64 tensors on
the run's device, physics is elementwise torch and the spectral step is
``torch.fft.rfft`` / ``irfft`` (cuFFT on the card).  Each logical rank has
its own CUDA stream, entered inside every task body.  A block packed on
one rank's stream is read on the receiving rank's stream, so the sender
waits on a :class:`~repro_torch.core.tac.ArrayHandle` over its blocks
before posting the exchange (``tac.wait``, which pauses the task in the
interop versions, §6.1), and every reader marks the blocks it reads with
``record_stream`` so the allocator never hands their memory to the
producer's stream while the read is pending.

The simulated scaling curve (``build_sim`` / ``simulate_version``) replays
the same task graphs on the port's :mod:`~repro_torch.core.simulate`, and
``run_elastic`` survives an injected rank death by shrinking the world
and resuming from :mod:`repro_torch.checkpoint`.  CSV:
name,us_per_call,derived

Run: ``python -m repro_torch.bench.ifsker`` (the bench on the CUDA device),
``--trace PATH`` for the traced interop-nonblk leg, ``--device cpu`` to run
on the CPU.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import Collectives, TaskRuntime, tac
from ..core import schedule as schedule_ir
from ..core.mesh import resolve_device
from ..core.simulate import (COMM_EVENTS, COMM_HELD, COMM_PAUSED, COMPUTE,
                             SimTask, Simulator)

VERSIONS = ("pure", "interop-blk", "interop-nonblk")

# the spectral diffusion factor exp(-0.01 k) per (length, device), computed
# once in numpy float64 (the reference's values bit for bit)
_DIFFUSION: Dict = {}


def physics(x: torch.Tensor) -> torch.Tensor:
    return x + 0.1 * torch.tanh(x) - 0.01 * x ** 3


def _diffusion(m: int, device: torch.device) -> torch.Tensor:
    key = (m, device)
    if key not in _DIFFUSION:
        _DIFFUSION[key] = torch.from_numpy(
            np.exp(-0.01 * np.arange(m))).to(device)
    return _DIFFUSION[key]


def spectral_step(f: torch.Tensor) -> torch.Tensor:
    F = torch.fft.rfft(f)
    F *= _diffusion(F.numel(), F.device)   # diffusion in spectral space
    return torch.fft.irfft(F, n=f.numel())


def run_real(version: str, *, n_ranks: int = 2, workers: int = 2,
             n_fields: int = 8, n_grid: int = 64, steps: int = 3,
             seed: int = 0, notify: Optional[str] = None, device=None):
    """Returns (final fields as an (n_fields, n_grid) float64 tensor on the
    run's device, runtime stats); ``stats["seconds"]`` is the wall time of
    the steps.

    ``device`` defaults to the CUDA device (and raises without one).
    ``notify`` picks the runtime's completion-notification backend
    ("polling" / "continuation"; None = the REPRO_NOTIFY env default).
    The initial fields are the reference's numpy draws, so both packages
    start from bit-identical state.
    """
    if version not in VERSIONS:
        raise ValueError(f"version must be one of {VERSIONS}, got "
                         f"{version!r}")
    if n_fields % n_ranks or n_grid % n_ranks:
        raise ValueError(f"{n_fields} fields / {n_grid} points do not "
                         f"divide over {n_ranks} ranks")
    device = resolve_device(device)
    pts = n_grid // n_ranks
    # the reference draws rng.standard_normal(pts) per (field, rank), field
    # major: the same stream as one (n_fields, n_grid) draw
    fields = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n_fields, n_grid))).to(device)
    # grid space: fields[f] split by points across ranks
    grid: Dict = {(f, r): fields[f, r * pts:(r + 1) * pts]
                  for f in range(n_fields) for r in range(n_ranks)}
    spec: Dict = {}
    exch: Dict = {}   # alltoall results (or event-bound handles)
    streams = ([torch.cuda.Stream(device) for _ in range(n_ranks)]
               if device.type == "cuda" else None)
    if streams:
        # the initial fields were made on the default stream; every rank
        # stream reads them
        torch.cuda.synchronize(device)
        for s in streams:
            fields.record_stream(s)
    del fields
    world = tac.CommWorld(n_ranks)
    coll = Collectives(world)
    tac.init(tac.TASK_MULTIPLE if version.startswith("interop")
             else tac.THREAD_MULTIPLE)
    rt = TaskRuntime(num_workers=workers, notify=notify)
    rt.start()
    t_start = time.perf_counter()

    def on_rank(r):
        """Rank ``r``'s stream as the current one (a no-op on the CPU)."""
        if streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(streams[r])

    def read_on(r, tensors):
        """Mark blocks made on another rank's stream as read on r's."""
        if streams is not None:
            for t in tensors:
                t.record_stream(streams[r])

    def owner(f: int) -> int:
        return f % n_ranks

    fields_of = {o: [f for f in range(n_fields) if owner(f) == o]
                 for o in range(n_ranks)}
    a2a_mode = "event" if version == "interop-nonblk" else "blocking"

    def ready(r, blocks):
        """Blocks made on rank r's stream, complete on the device on
        return (they are read on the receivers' streams)."""
        with on_rank(r):
            handle = tac.ArrayHandle(blocks)
        # Task-aware: pauses a TASK_MULTIPLE task until the event fires,
        # a plain event.synchronize() elsewhere.
        tac.wait(handle)
        return blocks

    def phys_task(f, r, it):
        with on_rank(r):
            grid[(f, r)] = physics(grid[(f, r)])

    def pack_g2s(r):
        """Block for owner o = my point-slices of o's fields, field order."""
        with on_rank(r):
            blocks = [torch.cat([grid[(f, r)] for f in fields_of[o]])
                      for o in range(n_ranks)]
        return ready(r, blocks)

    def pack_s2g(o):
        """Block for rank r = r's point-slices of my fields, field order."""
        with on_rank(o):
            blocks = [torch.cat([spec[f][r * pts:(r + 1) * pts]
                                 for f in fields_of[o]])
                      for r in range(n_ranks)]
        return ready(o, blocks)

    # exch is keyed by rank only: iteration it+1's exchange task cannot
    # start before iteration it's readers finished (it is gated through
    # unpack → phys), so each slot is safely overwritten and peak memory
    # stays O(n_grid × n_fields) instead of growing with step count.
    def a2a_g2s(r, it):
        exch[("g2s", r)] = coll.alltoall(
            pack_g2s(r), rank=r, mode=a2a_mode, key=("g2s", it))

    def a2a_s2g(o, it):
        exch[("s2g", o)] = coll.alltoall(
            pack_s2g(o), rank=o, mode=a2a_mode, key=("s2g", it))

    def fft_field(f, it):
        o = owner(f)
        parts = exch[("g2s", o)]
        if isinstance(parts, tac.AsyncHandle):
            parts = parts.result
        j = fields_of[o].index(f)
        read_on(o, parts)
        with on_rank(o):
            full = torch.cat([parts[s][j * pts:(j + 1) * pts]
                              for s in range(n_ranks)])
            spec[f] = spectral_step(full)

    def unpack(r, it):
        parts = exch.pop(("s2g", r))
        if isinstance(parts, tac.AsyncHandle):
            parts = parts.result
        read_on(r, parts)
        for o in range(n_ranks):
            for j, f in enumerate(fields_of[o]):
                grid[(f, r)] = parts[o][j * pts:(j + 1) * pts]

    for it in range(steps):
        if version == "pure":
            for f in range(n_fields):
                for r in range(n_ranks):
                    phys_task(f, r, it)
            g2s = coll.run_group(
                "alltoall", [{"blocks": pack_g2s(r)}
                             for r in range(n_ranks)], key=("g2s", it))
            for r in range(n_ranks):
                exch[("g2s", r)] = g2s[r]
            for f in range(n_fields):
                fft_field(f, it)
            s2g = coll.run_group(
                "alltoall", [{"blocks": pack_s2g(o)}
                             for o in range(n_ranks)], key=("s2g", it))
            for o in range(n_ranks):
                exch[("s2g", o)] = s2g[o]
            for r in range(n_ranks):
                unpack(r, it)
            continue

        for r in range(n_ranks):
            for f in range(n_fields):
                rt.submit(phys_task, f, r, it, inout=[("g", f, r)],
                          name=f"phys[{f},{r}]@{it}", label="compute",
                          rank=r)
        for r in range(n_ranks):
            rt.submit(a2a_g2s, r, it,
                      in_=[("g", f, r) for f in range(n_fields)],
                      out=[("xg", r, it)], label="comm",
                      name=f"a2a_g2s[{r}]@{it}", rank=r)
        for f in range(n_fields):
            rt.submit(fft_field, f, it, in_=[("xg", owner(f), it)],
                      out=[("s", f)], label="compute",
                      name=f"fft[{f}]@{it}", rank=owner(f))
        for o in range(n_ranks):
            rt.submit(a2a_s2g, o, it,
                      in_=[("s", f) for f in fields_of[o]],
                      out=[("xs", o, it)], label="comm",
                      name=f"a2a_s2g[{o}]@{it}", rank=o)
        for r in range(n_ranks):
            rt.submit(unpack, r, it, in_=[("xs", r, it)],
                      inout=[("g", f, r) for f in range(n_fields)],
                      label="compute", name=f"unp[{r}]@{it}", rank=r)

    rt.taskwait()
    stats = dict(rt.stats)
    rt.close()
    if streams:
        torch.cuda.synchronize(device)
    # wall seconds of the steps, set-up (data, streams, runtime) excluded
    stats["seconds"] = time.perf_counter() - t_start
    # The task closures above and this frame form reference cycles: drop
    # the exchange blocks and spectra now, not at the collector's next
    # pass, and free each grid slice as it is copied out.
    spec.clear()
    exch.clear()
    out = torch.empty((n_fields, n_grid), dtype=torch.float64,
                      device=device)
    for f in range(n_fields):
        for r in range(n_ranks):
            out[f, r * pts:(r + 1) * pts] = grid.pop((f, r))
    return out, stats


# ---------------------------------------------------------------------------
# elastic execution: checkpoint / injected rank death / shrink / resume
# ---------------------------------------------------------------------------
def _elastic_step(comm, coll, fields: torch.Tensor, *, mode, rt, it):
    """One IFSKer timestep of the global ``fields`` tensor over ``comm``.

    Works for ANY communicator size that divides both axes; physics and
    the spectral step are decomposition-independent, so the result is
    bitwise identical at every rank count — which is what lets a
    shrunken world resume a dead one's checkpoint exactly.  Every task
    enqueues on the current stream (one stream for all ranks), so the
    stream orders each exchanged block after the work that made it.
    """
    n_ranks = comm.size
    n_fields, n_grid = fields.shape
    pts = n_grid // n_ranks
    grid = {(f, r): fields[f, r * pts:(r + 1) * pts].clone()
            for f in range(n_fields) for r in range(n_ranks)}
    spec: Dict = {}
    exch: Dict = {}
    fields_of = {o: [f for f in range(n_fields) if f % n_ranks == o]
                 for o in range(n_ranks)}

    def phys_task(f, r):
        grid[(f, r)] = physics(grid[(f, r)])

    def a2a_g2s(r):
        blocks = [torch.cat([grid[(f, r)] for f in fields_of[o]])
                  for o in range(n_ranks)]
        exch[("g2s", r)] = coll.alltoall(blocks, rank=r, mode=mode,
                                         key=("eg2s", it))

    def fft_field(f):
        o = f % n_ranks
        parts = exch[("g2s", o)]
        if isinstance(parts, tac.AsyncHandle):
            parts = parts.result
        j = fields_of[o].index(f)
        full = torch.cat([parts[s][j * pts:(j + 1) * pts]
                          for s in range(n_ranks)])
        spec[f] = spectral_step(full)

    def a2a_s2g(o):
        blocks = [torch.cat([spec[f][r * pts:(r + 1) * pts]
                             for f in fields_of[o]])
                  for r in range(n_ranks)]
        exch[("s2g", o)] = coll.alltoall(blocks, rank=o, mode=mode,
                                         key=("es2g", it))

    def unpack(r):
        parts = exch[("s2g", r)]
        if isinstance(parts, tac.AsyncHandle):
            parts = parts.result
        for o in range(n_ranks):
            for j, f in enumerate(fields_of[o]):
                grid[(f, r)] = parts[o][j * pts:(j + 1) * pts]

    for r in range(n_ranks):
        for f in range(n_fields):
            rt.submit(phys_task, f, r, inout=[("g", f, r)],
                      name=f"ephys[{f},{r}]@{it}", label="compute",
                      rank=r)
    for r in range(n_ranks):
        rt.submit(a2a_g2s, r, in_=[("g", f, r) for f in range(n_fields)],
                  out=[("xg", r, it)], label="comm",
                  name=f"ea2a_g2s[{r}]@{it}", rank=r)
    for f in range(n_fields):
        rt.submit(fft_field, f, in_=[("xg", f % n_ranks, it)],
                  out=[("s", f)], label="compute", name=f"efft[{f}]@{it}",
                  rank=f % n_ranks)
    for o in range(n_ranks):
        rt.submit(a2a_s2g, o, in_=[("s", f) for f in fields_of[o]],
                  out=[("xs", o, it)], label="comm",
                  name=f"ea2a_s2g[{o}]@{it}", rank=o)
    for r in range(n_ranks):
        rt.submit(unpack, r, in_=[("xs", r, it)],
                  inout=[("g", f, r) for f in range(n_fields)],
                  label="compute", name=f"eunp[{r}]@{it}", rank=r)
    rt.taskwait()
    return torch.stack([torch.cat([grid[(f, r)] for r in range(n_ranks)])
                        for f in range(n_fields)])


def run_elastic(ckpt_dir: str, *, n_ranks: int = 4, workers: int = 2,
                n_fields: int = 12, n_grid: int = 24, steps: int = 4,
                kill_step: Optional[int] = None, kill_rank: int = 0,
                kill_after_ops: int = 1, mode: str = "event",
                notify: Optional[str] = None, seed: int = 0, device=None):
    """Fault-tolerant IFSKer: checkpoint each step, survive an injected
    rank death mid-transposition, shrink, resume (see
    ``gauss_seidel.run_elastic`` for the recovery protocol).  The axes
    must divide every rank count the run may shrink to (defaults: 12
    fields / 24 points over 4 ranks survive the loss of one).

    Returns ``(final fields as a tensor on the run's device, info)``.
    """
    from .. import checkpoint as checkpoint_lib
    from ..core import resilience
    from ..core.executor import TaskError

    device = resolve_device(device)
    world = tac.CommWorld(n_ranks)
    injector = resilience.FaultInjector(world)
    tac.init(tac.TASK_MULTIPLE)
    template = {"fields": torch.empty((n_fields, n_grid),
                                      dtype=torch.float64)}

    step = checkpoint_lib.latest_step(ckpt_dir)
    if step is None:
        rng = np.random.default_rng(seed)
        fields = torch.from_numpy(
            rng.standard_normal((n_fields, n_grid))).to(device)
        checkpoint_lib.save_checkpoint(ckpt_dir, {"fields": fields}, 0)
        step = 0
    else:
        state, step = checkpoint_lib.restore_checkpoint(
            ckpt_dir, template, device=device)
        fields = state["fields"]

    comm = world
    coll = Collectives(world)
    rt = TaskRuntime(num_workers=workers, notify=notify)
    rt.start()
    info = {"recoveries": []}

    try:
        while step < steps:
            it = step + 1
            if kill_step is not None and it == kill_step \
                    and not injector.killed:
                injector.arm(kill_rank, after_ops=kill_after_ops)
            try:
                fields = _elastic_step(comm, coll, fields, mode=mode,
                                       rt=rt, it=it)
            except TaskError:
                injector.disarm()
                rt.close()
                shrunk = resilience.recover(world)
                if n_fields % shrunk.size or n_grid % shrunk.size:
                    raise ValueError(
                        f"{n_fields} fields / {n_grid} points do not "
                        f"divide over {shrunk.size} survivors")
                comm, coll = shrunk, Collectives(shrunk)
                rt = TaskRuntime(num_workers=workers, notify=notify)
                rt.start()
                state, step = checkpoint_lib.restore_checkpoint(
                    ckpt_dir, template, device=device)
                fields = state["fields"]
                info["recoveries"].append(
                    {"at_step": it, "killed": list(world.failed),
                     "survivors": comm.size, "resumed_step": step})
                continue
            step = it
            checkpoint_lib.save_checkpoint(ckpt_dir, {"fields": fields},
                                           step)
    finally:
        rt.close()
    info["size"] = comm.size
    return fields, info


# ---------------------------------------------------------------------------
# simulated scaling (Fig. 14)
# ---------------------------------------------------------------------------
def build_sim(version, *, n_ranks, n_fields=64, steps=6, t_phys=1.0,
              t_fft=1.0, t_comm=0.02, latency=0.05):
    """Replays the DAG the real versions execute: per-rank ``alltoall``
    collective nodes for each transposition (g2s / s2g), with the waiting
    discipline of the version (held / paused / event-bound)."""
    tasks: List[SimTask] = []
    index: Dict[str, int] = {}

    def add(rank, cost, kind=COMPUTE, start=(), name="", group=None,
            group_latency=0.0):
        t = SimTask(len(tasks), rank, cost, kind=kind,
                    start_deps=[(index[s], 0.0) for s in start
                                if s and s in index],
                    name=name, group=group, group_latency=group_latency)
        tasks.append(t)
        index[name] = t.id

    kind = {"interop-blk": COMM_PAUSED,
            "interop-nonblk": COMM_EVENTS}.get(version, COMM_HELD)
    fl = n_fields // n_ranks  # fields per rank in spectral space
    tp = t_phys / fl          # physics cost per (field, rank) slice
    # pairwise all-to-all latency from the IR cost model (α = per-message
    # latency, wires free — equals the rounds × latency count)
    a2a_lat = schedule_ir.build("alltoall", "ring", n_ranks).cost(
        latency, 0.0, 0)

    for it in range(steps):
        for r in range(n_ranks):
            for f in range(n_fields):
                add(r, tp, start=[f"unp[{r}]@{it - 1}"] if it else [],
                    name=f"phys[{f},{r}]@{it}")
        for r in range(n_ranks):
            add(r, t_comm, kind=kind,
                start=[f"phys[{f},{r}]@{it}" for f in range(n_fields)],
                group=f"g2s@{it}", group_latency=a2a_lat,
                name=f"a2a_g2s[{r}]@{it}")
        for f in range(n_fields):
            o = f % n_ranks
            add(o, t_fft / fl, start=[f"a2a_g2s[{o}]@{it}"],
                name=f"fft[{f}]@{it}")
        for o in range(n_ranks):
            add(o, t_comm, kind=kind,
                start=[f"fft[{f}]@{it}" for f in range(n_fields)
                       if f % n_ranks == o],
                group=f"s2g@{it}", group_latency=a2a_lat,
                name=f"a2a_s2g[{o}]@{it}")
        for r in range(n_ranks):
            add(r, t_comm, start=[f"a2a_s2g[{r}]@{it}"],
                name=f"unp[{r}]@{it}")
    return tasks


def simulate_version(version, *, n_ranks, workers=4, **kw):
    tasks = build_sim(version, n_ranks=n_ranks, **kw)
    sim = Simulator(n_ranks, 1 if version == "pure" else workers,
                    task_overhead=0.001, resume_overhead=0.005)
    return sim.run(tasks).makespan


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def bench(print_fn=print, device=None):
    """The reference's bench on the port: every version and both notify
    backends within 1e-10 of ``pure`` (the port's versions are in fact
    bitwise equal), then wall times and the simulated scaling rows."""
    rows = []
    ref, _ = run_real("pure", device=device)
    for v in VERSIONS[1:]:
        out, stats = run_real(v, device=device)
        err = _max_diff(out, ref)
        assert err < 1e-10, (v, err)

    # end-to-end notification-backend legs: both engines, same numerics.
    for v in VERSIONS[1:]:
        for nb in ("polling", "continuation"):
            t0 = time.monotonic()
            out, _ = run_real(v, notify=nb, device=device)
            dt = (time.monotonic() - t0) / 3
            assert _max_diff(out, ref) < 1e-10, (v, nb)
            rows.append((f"ifsker_e2e_{v}_{nb}", dt * 1e6, "notify-leg"))

    for v in VERSIONS:
        t0 = time.monotonic()
        _, stats = run_real(v, device=device)
        dt = (time.monotonic() - t0) / 3
        rows.append((f"ifsker_real_{v}", dt * 1e6,
                     f"blocks={stats.get('task_blocks', 0)}"))

    base = simulate_version("pure", n_ranks=1)
    for v in VERSIONS:
        for n in (1, 2, 4, 8, 16):
            mk = simulate_version(v, n_ranks=n)
            rows.append((f"ifsker_sim_{v}_r{n}", mk * 1e6,
                         f"speedup={base / mk:.2f}"))
    for r in rows:
        print_fn(f"{r[0]},{r[1]:.1f},{r[2]}")
    return rows


# ---------------------------------------------------------------------------
# traced leg: Perfetto timeline for the transposition pipeline
# ---------------------------------------------------------------------------
def run_traced(trace_path: str, *, print_fn=print, device=None):
    """``--trace`` leg: one interop-nonblk run under the tracer.

    Exports the task/handle/collective timeline of the event-bound
    transposition pipeline as Perfetto JSON with the per-rank overlap
    fractions and straggler scores in ``otherData``; raises if the
    document violates ``repro_torch.obs.SPAN_SCHEMA``.
    """
    from .. import obs

    with obs.tracing(capacity=1 << 18) as tr:
        run_real("interop-nonblk", n_ranks=2, workers=2,
                 n_fields=8, n_grid=128, steps=3, device=device)
        events = tr.events()
    overlap = obs.overlap_fraction(events)
    doc = obs.export_trace(trace_path, events=events, extra={
        "benchmark": "ifsker",
        "overlap_fraction": overlap,
        "per_rank_overlap": {str(r): f for r, f in
                             obs.per_rank_overlap(events).items()},
        "straggler_scores": {str(r): s for r, s in
                             obs.straggler_scores(events).items()},
    })
    obs.assert_valid_trace(doc)
    print_fn(f"ifsker_trace_overlap,{overlap * 1e6:.1f},"
             f"overlap-fraction-ppm")
    print_fn(f"ifsker_trace_events,{len(events)},file={trace_path}")
    return overlap


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="IFSKer benchmark (paper §7.2)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="run the traced interop-nonblk leg and write "
                         "Perfetto JSON here (skips the plain bench)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ns = ap.parse_args()
    if ns.trace:
        run_traced(ns.trace, device=ns.device)
    else:
        bench(device=ns.device)
