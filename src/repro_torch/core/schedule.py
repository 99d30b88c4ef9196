"""Schedule IR — collective communication schedules as *data* (tentpole).

The paper's central claim is that communication should be ordered by data
dependencies alone, not by which execution substrate runs it.  Before this
module the repository had the same schedules twice: once as Python
generators only the host progress engine could execute
(``repro_torch.core.collectives``), and once hand-written as ``ppermute``/``psum``
calls only XLA could execute (``repro.core.overlap``).  Follow-on work (MPI
Continuations, arXiv:2112.11978; "MPI Progress For All", arXiv:2405.13807)
argues that decoupling the schedule *description* from progress/execution
is what makes such libraries portable across runtimes.

This module is that description.  Every algorithm — ring, recursive
doubling, Bruck, binomial tree, chain, pairwise, dissemination,
neighbourhood — is built **once** as a :class:`Schedule`: a DAG of
:class:`Send`/:class:`Recv`/:class:`Combine`/:class:`Slice`/... ops over
abstract communicator-local ranks, with a per-op payload *fraction* so a
single schedule serves every payload size.  Two consumers execute the same
IR:

* **Level A** — the host progress engine
  (:func:`repro_torch.core.collectives._interpret`): walks a rank's program,
  posting ``isend``/``irecv`` through any communicator and yielding the
  handles it must wait on — blocking and event-bound modes, tag
  discipline, and sub-communicator rank translation all unchanged.
* **Level B** — the XLA lowering (:mod:`repro.core.lowering`): maps the
  same schedule to in-graph collectives (``ppermute`` rounds inside
  ``shard_map``, or a single fused node).

On top of the IR:

* **Segmented/pipelined schedules** (``segments=S``): payloads are chunked
  into ``S`` segments whose rounds interleave, so the *combine* of segment
  ``k`` overlaps the *transport* of segment ``k+1`` — the classic
  large-payload pipelining trick.  ``S=1`` reproduces the unsegmented
  schedules bit-for-bit.
* **An α-β(-γ) cost model** (:meth:`Schedule.cost`): per-transfer latency
  ``α``, per-byte wire time ``β``, and optionally per-byte combine time
  ``γ``, evaluated over the DAG under a one-port model (a rank's sends
  serialise; its combines serialise on its CPU; transport and combine of
  independent ops overlap).  ``cost(α, β, size)`` replaces bare round
  counts for algorithm *and* segment-count selection
  (:func:`best_schedule`), and feeds the simulator's
  predicted-vs-measured makespans
  (:func:`repro.core.simulate.schedule_tasks`).

The IR is deliberately tiny and serialisable: ops are frozen dataclasses
over primitive values, programs are tuples — a schedule can be printed,
diffed, cached, validated (:meth:`Schedule.validate`) and costed without
any runtime present.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Op", "Send", "Recv", "Combine", "Copy", "Pack", "Unpack", "Slice",
    "Concat", "Const", "Schedule", "Transfer", "build", "build_neighbor",
    "build_hierarchical", "best_schedule", "load_calibration",
    "COLLECTIVES", "ALGORITHMS",
]

COLLECTIVES = ("barrier", "bcast", "reduce", "allreduce", "allgather",
               "reduce_scatter", "alltoall")
ALGORITHMS = ("ring", "doubling")


# ---------------------------------------------------------------------------
# Ops.  Frozen dataclasses over primitives: a schedule is pure data.
# Buffer names are hashables (strings or tuples); ``frac`` is the op's
# payload in units of the collective's nominal per-rank size ``m`` (so one
# schedule serves every payload size in the cost model).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Op:
    @property
    def reads(self) -> Tuple[Any, ...]:
        return ()

    @property
    def writes(self) -> Tuple[Any, ...]:
        return ()


@dataclass(frozen=True)
class Send(Op):
    peer: int          # destination rank
    buf: Any           # buffer holding the payload
    tag: Any           # schedule-unique transfer id (matches one Recv)
    frac: float = 1.0

    @property
    def reads(self):
        return (self.buf,)


@dataclass(frozen=True)
class Recv(Op):
    peer: int          # source rank
    buf: Any           # buffer the payload lands in
    tag: Any
    frac: float = 1.0

    @property
    def writes(self):
        return (self.buf,)


@dataclass(frozen=True)
class Combine(Op):
    """``out = op(a, b)`` — the collective's combining operator.

    Operand order is part of the schedule: every rank applies the operator
    with matching order, which is what makes IEEE results bitwise
    identical across ranks.
    """
    out: Any
    a: Any
    b: Any
    frac: float = 1.0

    @property
    def reads(self):
        return (self.a, self.b)

    @property
    def writes(self):
        return (self.out,)


@dataclass(frozen=True)
class Copy(Op):
    out: Any
    src: Any

    @property
    def reads(self):
        return (self.src,)

    @property
    def writes(self):
        return (self.out,)


@dataclass(frozen=True)
class Pack(Op):
    """``out = tuple(parts)`` — one wire message from several buffers
    (Bruck's log-round gathers ship growing item sets)."""
    out: Any
    parts: Tuple[Any, ...]

    @property
    def reads(self):
        return tuple(self.parts)

    @property
    def writes(self):
        return (self.out,)


@dataclass(frozen=True)
class Unpack(Op):
    """``outs... = src`` — split a packed message back into buffers."""
    outs: Tuple[Any, ...]
    src: Any

    @property
    def reads(self):
        return (self.src,)

    @property
    def writes(self):
        return tuple(self.outs)


@dataclass(frozen=True)
class Slice(Op):
    """``out = array_split(flatten(src), parts)[index]`` — the
    reduce-scatter output selection."""
    out: Any
    src: Any
    parts: int
    index: int

    @property
    def reads(self):
        return (self.src,)

    @property
    def writes(self):
        return (self.out,)


@dataclass(frozen=True)
class Concat(Op):
    """``out = concatenate(flatten(p) for p in parts)`` — reassemble a
    segmented payload, the inverse of per-segment ``Slice``/chunk
    splitting.  With ``like`` set the flat result is reshaped to that
    buffer's shape (segmented allgather returns each contribution in the
    sender's shape; the MPI uniform-count contract makes the local
    ``"in"`` a valid template)."""
    out: Any
    parts: Tuple[Any, ...]
    like: Any = None

    @property
    def reads(self):
        parts = tuple(self.parts)
        return parts if self.like is None else parts + (self.like,)

    @property
    def writes(self):
        return (self.out,)


@dataclass(frozen=True)
class Const(Op):
    """``out = value`` — schedule-immanent payloads (barrier tokens)."""
    out: Any
    value: Any

    @property
    def writes(self):
        return (self.out,)


@dataclass(frozen=True)
class Transfer:
    """One matched Send/Recv pair (the schedule's DAG edges)."""
    src: int
    dst: int
    tag: Any
    frac: float
    src_buf: Any
    dst_buf: Any


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Schedule:
    """A collective schedule: per-rank op programs over abstract ranks.

    ``input_kind`` tells the executor how a rank's operand binds to the
    initial buffers; ``output_kind`` how the final buffers form the rank's
    result:

    ======================  ====================================================
    input_kind              binding
    ======================  ====================================================
    ``none``                no operand (barrier)
    ``value``               ``env["in"] = value`` (raw object: bcast, allgather)
    ``array``               ``env["in"] = asarray(value)`` (reductions)
    ``chunks``              flattened value split into ``n×segments`` chunk
                            buffers ``("c", i[, s])`` (ring reductions)
    ``blocks``              ``env[("b", d)] = blocks[d]`` (alltoall)
    ``dirs``                ``env[("s", d)] = sends[d]`` (neighbourhood)
    ======================  ====================================================

    ======================  ====================================================
    output_kind             result
    ======================  ====================================================
    ``none``                ``None`` (barrier)
    ``buf``                 ``env[out_bufs[rank]]`` (``None`` slot → ``None``)
    ``concat``              chunks concatenated and reshaped (ring allreduce)
    ``list``                ``[env[("g", i)] for i in range(n)]``
    ``dirs``                ``{d: env[("rv", d)] for d in (in_dirs or
                            out_dirs)[rank]}``
    ======================  ====================================================
    """
    name: str
    algorithm: str
    n: int
    programs: Tuple[Tuple[Op, ...], ...]
    input_kind: str
    output_kind: str
    segments: int = 1
    out_bufs: Tuple[Any, ...] = ()
    out_dirs: Tuple[Tuple[Any, ...], ...] = ()
    # Receive directions per rank for asymmetric (directed) neighbourhood
    # schedules.  Empty means receives mirror sends (the symmetric case:
    # every out direction has a reciprocal in direction), which is every
    # schedule built before directed dist-graphs existed.
    in_dirs: Tuple[Tuple[Any, ...], ...] = ()
    chunk_bufs: Tuple[Any, ...] = ()
    # ``chunks`` inputs split into this many outer chunks (0 -> ``n``, the
    # flat-ring convention).  Hierarchical schedules split into the INTRA
    # group size instead: every rank of one pod owns one chunk.
    n_chunks: int = 0
    # Mesh factorisation metadata for multi-axis schedules, major -> minor:
    # ``(("inter", n_e), ("intra", n_i))`` with global rank
    # ``r = pod * n_i + local``.  Empty for flat single-axis schedules.
    axes: Tuple[Tuple[str, int], ...] = ()

    # -- structure ----------------------------------------------------------
    def transfers(self) -> List[Transfer]:
        sends: Dict[Any, Tuple[int, Send]] = {}
        recvs: Dict[Any, Tuple[int, Recv]] = {}
        for r, prog in enumerate(self.programs):
            for op in prog:
                if isinstance(op, Send):
                    if op.tag in sends:
                        raise ValueError(f"duplicate send tag {op.tag!r}")
                    sends[op.tag] = (r, op)
                elif isinstance(op, Recv):
                    if op.tag in recvs:
                        raise ValueError(f"duplicate recv tag {op.tag!r}")
                    recvs[op.tag] = (r, op)
        if set(sends) != set(recvs):
            raise ValueError(
                f"unmatched transfers: sends-only "
                f"{sorted(set(sends) - set(recvs), key=repr)}, recvs-only "
                f"{sorted(set(recvs) - set(sends), key=repr)}")
        out = []
        for tag, (src, s) in sends.items():
            dst, rv = recvs[tag]
            if s.peer != dst or rv.peer != src:
                raise ValueError(
                    f"transfer {tag!r}: send {src}->{s.peer} does not match "
                    f"recv {rv.peer}->{dst}")
            out.append(Transfer(src, dst, tag, s.frac, s.buf, rv.buf))
        return out

    def validate(self) -> "Schedule":
        """Structural checks; returns self so builders can chain.

        * every Send matches exactly one Recv (tag, src, dst consistent);
        * peers in range;
        * every buffer is written before it is read *given* the input
          binding (chunk/block/dir/value buffers count as pre-written);
        * output buffers are written somewhere.
        """
        self.transfers()   # raises on mismatches
        for r, prog in enumerate(self.programs):
            written = set(self._initial_bufs(r))
            for op in prog:
                if isinstance(op, (Send, Recv)) and not (
                        0 <= op.peer < self.n):
                    raise ValueError(f"rank {r}: peer {op.peer} out of "
                                     f"range for n={self.n}")
                for b in op.reads:
                    if b not in written:
                        raise ValueError(
                            f"rank {r}: op {op} reads unwritten buffer "
                            f"{b!r}")
                written.update(op.writes)
            for b in self._output_bufs(r):
                if b not in written:
                    raise ValueError(f"rank {r}: output buffer {b!r} is "
                                     f"never written")
        return self

    def _initial_bufs(self, rank: int) -> List[Any]:
        if self.input_kind in ("value", "array"):
            return ["in"]
        if self.input_kind == "chunks":
            return list(self.chunk_bufs)
        if self.input_kind == "blocks":
            return [("b", d) for d in range(self.n)]
        if self.input_kind == "dirs":
            return [("s", d) for d in self.out_dirs[rank]]
        return []

    def _output_bufs(self, rank: int) -> List[Any]:
        if self.output_kind == "buf":
            b = self.out_bufs[rank]
            return [] if b is None else [b]
        if self.output_kind == "concat":
            return list(self.chunk_bufs)
        if self.output_kind == "list":
            return [("g", i) for i in range(self.n)]
        if self.output_kind == "dirs":
            dirs = self.in_dirs or self.out_dirs
            return [("rv", d) for d in dirs[rank]]
        return []

    def wait_plan(self, rank: int) -> Tuple[
            Tuple[Tuple[Op, Tuple[Any, ...]], ...], Tuple[Any, ...]]:
        """Static wait plan of one rank's program.

        Whether an op must wait on an in-flight receive is a property of
        the *schedule*, not of any particular run: a buffer is pending
        exactly when an earlier ``Recv`` posted it and no op between the
        two reads it.  Returns ``(steps, tail)``: ``steps`` pairs every op
        with the (possibly empty) tuple of pending buffers it consumes, in
        posting order; ``tail`` is the receives still in flight after the
        last op — completion waits on them (barrier semantics).  Executors
        that precompute this (:mod:`repro_torch.core.program`) wait exactly
        where the reference interpreter
        (:func:`repro_torch.core.collectives._interpret`) would.
        """
        posted: Dict[Any, None] = {}    # insertion-ordered set
        steps: List[Tuple[Op, Tuple[Any, ...]]] = []
        for op in self.programs[rank]:
            waits = tuple(b for b in op.reads if b in posted)
            for b in waits:
                del posted[b]
            steps.append((op, waits))
            if isinstance(op, Recv):
                posted[op.buf] = None
        return tuple(steps), tuple(posted)

    # -- cost model ---------------------------------------------------------
    def cost(self, alpha: float, beta: float, size: float = 0.0, *,
             gamma: float = 0.0, link=None) -> float:
        """Predicted makespan under the α-β(-γ) model.

        ``alpha`` — per-transfer latency (s); ``beta`` — wire time per byte
        (s/B); ``size`` — the collective's nominal per-rank payload in
        bytes (an op moving/combining ``frac`` of it costs
        ``β·frac·size`` / ``γ·frac·size``); ``gamma`` — combine time per
        byte (s/B; 0 = free combines, the textbook α-β model).

        ``link`` optionally maps ``(src rank, dst rank)`` to that
        transfer's ``(α, β)`` — the heterogeneous-machine model shared
        with :func:`repro.core.simulate.schedule_tasks`; a two-tier link
        makes hierarchical schedules pay cheap intra-pod and expensive
        inter-pod constants, which is how :func:`best_schedule` compares
        flat against hierarchical candidates apples-to-apples.

        One-port evaluation over the DAG: each rank's sends serialise in
        program order (send port busy α + β·b per transfer), so do its
        receives (ingest port) and its combines (CPU, γ·b); transfers and
        combines of *independent* ops overlap freely — which is exactly
        what makes segmented schedules pipeline.  Marshalling ops
        (Copy/Pack/Unpack/Slice/Const) are free.
        """
        n = self.n
        avail: List[Dict[Any, float]] = [dict.fromkeys(
            self._initial_bufs(r), 0.0) for r in range(n)]
        port = [0.0] * n
        rport = [0.0] * n
        cpu = [0.0] * n
        arrival: Dict[Any, float] = {}
        pcs = [0] * n
        remaining = sum(len(p) for p in self.programs)
        while remaining:
            progressed = False
            for r in range(n):
                prog = self.programs[r]
                while pcs[r] < len(prog):
                    op = prog[pcs[r]]
                    env = avail[r]
                    if isinstance(op, Recv):
                        if op.tag not in arrival:
                            break               # sender not launched yet
                        a, bt = (alpha, beta) if link is None \
                            else link(op.peer, r)
                        done = max(arrival[op.tag],
                                   rport[r] + a + bt * op.frac * size)
                        rport[r] = done
                        env[op.buf] = done
                    elif isinstance(op, Send):
                        a, bt = (alpha, beta) if link is None \
                            else link(r, op.peer)
                        ready = max(env[op.buf], port[r])
                        done = ready + a + bt * op.frac * size
                        port[r] = done
                        arrival[op.tag] = done
                    elif isinstance(op, Combine):
                        ready = max(env[op.a], env[op.b], cpu[r])
                        done = ready + gamma * op.frac * size
                        cpu[r] = done
                        env[op.out] = done
                    elif isinstance(op, Copy):
                        env[op.out] = env[op.src]
                    elif isinstance(op, Pack):
                        env[op.out] = max(env[p] for p in op.parts)
                    elif isinstance(op, Unpack):
                        for o in op.outs:
                            env[o] = env[op.src]
                    elif isinstance(op, Slice):
                        env[op.out] = env[op.src]
                    elif isinstance(op, Concat):
                        env[op.out] = max(env[b] for b in op.reads)
                    elif isinstance(op, Const):
                        env[op.out] = 0.0
                    else:               # pragma: no cover - new op kinds
                        raise TypeError(f"unknown op {op!r}")
                    pcs[r] += 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                stuck = [r for r in range(n)
                         if pcs[r] < len(self.programs[r])]
                raise RuntimeError(f"schedule deadlock while costing: "
                                   f"ranks {stuck} cannot progress")
        makespan = max([0.0] + port + rport + cpu + list(arrival.values()))
        # completion also waits for every rank's final buffers
        for r in range(n):
            for b in self._output_bufs(r):
                makespan = max(makespan, avail[r].get(b, 0.0))
        return makespan

    @property
    def rounds(self) -> int:
        """Critical-path transfer rounds — ``cost`` with unit latency and
        free wires/combines.  Matches the closed-form
        :func:`repro_torch.core.collectives.n_rounds` latency model (asserted in
        tests)."""
        return int(round(self.cost(1.0, 0.0, 0.0)))

    def counts(self) -> Dict[str, int]:
        """Op-kind histogram — handy for structural tests and docs."""
        out: Dict[str, int] = {}
        for prog in self.programs:
            for op in prog:
                k = type(op).__name__
                out[k] = out.get(k, 0) + 1
        return out


# ---------------------------------------------------------------------------
# Builder plumbing
# ---------------------------------------------------------------------------
class _B:
    """Accumulates per-rank programs; ``xfer`` appends the matched
    Send/Recv pair with an auto-assigned schedule-unique tag, so transfers
    can never mismatch by construction."""

    def __init__(self, n: int) -> None:
        self.n = n
        self.programs: List[List[Op]] = [[] for _ in range(n)]
        self._tags = iter(range(10 ** 9))

    def xfer(self, src: int, dst: int, src_buf: Any, dst_buf: Any,
             frac: float = 1.0, tag: Any = None) -> Any:
        if tag is None:
            tag = next(self._tags)
        self.programs[src].append(Send(dst, src_buf, tag, frac))
        self.programs[dst].append(Recv(src, dst_buf, tag, frac))
        return tag

    def done(self, **kw: Any) -> Schedule:
        return Schedule(programs=tuple(tuple(p) for p in self.programs),
                        **kw).validate()


# ---------------------------------------------------------------------------
# Builders — each algorithm constructed ONCE as data.
# ---------------------------------------------------------------------------
def _barrier_dissemination(n: int) -> Schedule:
    b = _B(n)
    for r in range(n):
        b.programs[r].append(Const("tok", True))
    tok: List[Any] = ["tok"] * n
    k, rnd = 1, 0
    while k < n:
        nxt = []
        for r in range(n):
            # forward the previously *received* token: the dataflow edge
            # that makes round k+1 wait for round k (barrier transitivity).
            b.xfer(r, (r + k) % n, tok[r], ("m", rnd, (r + k) % n))
        for r in range(n):
            nxt.append(("m", rnd, r))
        tok = nxt
        k <<= 1
        rnd += 1
    return b.done(name="barrier", algorithm="doubling", n=n,
                  input_kind="none", output_kind="none")


def _barrier_ring(n: int) -> Schedule:
    b = _B(n)
    for r in range(n):
        b.programs[r].append(Const("tok", True))
    tok: List[Any] = ["tok"] * n
    for k in range(n - 1):
        for r in range(n):
            b.xfer(r, (r + 1) % n, tok[r], ("m", k, (r + 1) % n))
        tok = [("m", k, r) for r in range(n)]
    return b.done(name="barrier", algorithm="ring", n=n,
                  input_kind="none", output_kind="none")


def _pow2_below(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def _bcast_tree(n: int, root: int) -> Schedule:
    """Binomial-tree broadcast (MPICH-style), any rank count.

    Virtual rank ``vr = (r - root) % n``; vr > 0 receives once from
    ``vr - lowbit(vr)``, then forwards down its subtrees largest-first —
    the exact wave structure of the pre-IR host generator.  Each rank
    receives exactly once, so ``("t", dst)`` tags are schedule-unique and
    the Send/Recv pair is matched by the same closed formula on both
    sides.
    """
    progs: List[List[Op]] = [[] for _ in range(n)]
    buf: List[Any] = [None] * n
    for vr in range(n):
        r = (vr + root) % n
        if vr == 0:
            buf[r] = "in"
            mask = _pow2_below(n - 1) if n > 1 else 0
        else:
            lowbit = vr & -vr
            src = ((vr - lowbit) + root) % n
            buf[r] = ("m", r)
            progs[r].append(Recv(src, buf[r], ("t", r)))
            mask = lowbit >> 1
        while mask:
            if vr + mask < n:
                dst = ((vr + mask) + root) % n
                progs[r].append(Send(dst, buf[r], ("t", dst)))
            mask >>= 1
    return Schedule(name="bcast", algorithm="doubling", n=n,
                    programs=tuple(tuple(p) for p in progs),
                    input_kind="value", output_kind="buf",
                    out_bufs=tuple(buf)).validate()


def _bcast_chain(n: int, root: int) -> Schedule:
    b = _B(n)
    buf: List[Any] = [None] * n
    buf[root] = "in"
    for step in range(n - 1):
        src = (root + step) % n
        dst = (root + step + 1) % n
        buf[dst] = ("m", dst)
        b.xfer(src, dst, buf[src], buf[dst])
    return b.done(name="bcast", algorithm="ring", n=n, input_kind="value",
                  output_kind="buf", out_bufs=tuple(buf))


def _reduce_tree(n: int, root: int) -> Schedule:
    """Binomial-tree reduction to ``root`` (commutative op).

    The mirror of :func:`_bcast_tree`: virtual rank ``vr`` whose lowest
    set bit is ``mask`` sends its accumulator to ``vr - mask`` and is
    done; survivors combine partners at increasing masks, ``acc = op(acc,
    other)`` — operand order preserved from the pre-IR generator.  Each
    rank sends at most once, so ``("t", src)`` tags are schedule-unique.
    """
    progs: List[List[Op]] = [[] for _ in range(n)]
    acc: List[Any] = ["in"] * n
    out: List[Any] = [None] * n
    for vr in range(n):
        r = (vr + root) % n
        mask = 1
        while mask < n:
            if vr & mask:
                dst = ((vr - mask) + root) % n
                progs[r].append(Send(dst, acc[r], ("t", r)))
                break
            if vr + mask < n:
                src = ((vr + mask) + root) % n
                progs[r].append(Recv(src, ("m", src), ("t", src)))
                nxt = ("a", r, mask)
                progs[r].append(Combine(nxt, acc[r], ("m", src)))
                acc[r] = nxt
            mask <<= 1
        else:
            out[r] = acc[r]
    return Schedule(name="reduce", algorithm="doubling", n=n,
                    programs=tuple(tuple(p) for p in progs),
                    input_kind="array", output_kind="buf",
                    out_bufs=tuple(out)).validate()


def _fix_recv_order(sched: Schedule) -> Schedule:
    """Move each Recv immediately before the first op that reads its
    buffer (builders emitting matched pairs in global sweeps can land the
    Recv after its consumer)."""
    progs = []
    for prog in sched.programs:
        prog = list(prog)
        changed = True
        while changed:
            changed = False
            for i, op in enumerate(prog):
                if not isinstance(op, Recv):
                    continue
                for j in range(i):
                    if op.buf in prog[j].reads:
                        prog.insert(j, prog.pop(i))
                        changed = True
                        break
                if changed:
                    break
        progs.append(tuple(prog))
    return dataclasses.replace(sched, programs=tuple(progs))


def _reduce_chain(n: int, root: int) -> Schedule:
    b = _B(n)
    acc: List[Any] = ["in"] * n
    out: List[Any] = [None] * n
    for step in range(n - 1):
        src = (root + n - 1 - step) % n     # vr = n-1-step
        dst = (root + n - 2 - step) % n
        b.xfer(src, dst, acc[src], ("m", src))
        nxt = ("a", dst)
        b.programs[dst].append(Combine(nxt, acc[dst], ("m", src)))
        acc[dst] = nxt
    out[root] = acc[root]
    return b.done(name="reduce", algorithm="ring", n=n, input_kind="array",
                  output_kind="buf", out_bufs=tuple(out))


def _chunk_names(n: int, segments: int) -> List[Any]:
    if segments == 1:
        return [("c", i) for i in range(n)]
    return [("c", i, s) for i in range(n) for s in range(segments)]


def _allreduce_ring(n: int, segments: int = 1) -> Schedule:
    """Ring allreduce: reduce-scatter rounds then allgather rounds.

    With ``segments=S > 1`` every chunk is further split into S segments
    whose rounds interleave — the combine of segment ``s`` overlaps the
    transport of segment ``s+1`` on the cost model's DAG, and the host
    interpreter/the lowering execute the same pipelined order.
    """
    b = _B(n)
    S = segments
    cur: Dict[Tuple[int, int, int], Any] = {}   # (rank, chunk, seg) -> buf
    for r in range(n):
        for i in range(n):
            for s in range(S):
                cur[(r, i, s)] = ("c", i, s) if S > 1 else ("c", i)
    frac = 1.0 / (n * S)
    for k in range(n - 1):                      # reduce-scatter leg
        for s in range(S):
            for r in range(n):
                i_send = (r - 1 - k) % n
                b.xfer(r, (r + 1) % n, cur[(r, i_send, s)],
                       ("m", "s", k, s, (r + 1) % n), frac)
            for r in range(n):
                i = (r - 2 - k) % n
                nxt = ("a", k, s, i)
                b.programs[r].append(
                    Combine(nxt, cur[(r, i, s)], ("m", "s", k, s, r),
                            frac))
                cur[(r, i, s)] = nxt
    for k in range(n - 1):                      # allgather leg
        for s in range(S):
            for r in range(n):
                i_send = (r - k) % n
                b.xfer(r, (r + 1) % n, cur[(r, i_send, s)],
                       ("m", "g", k, s, (r + 1) % n), frac)
            for r in range(n):
                i = (r - k - 1) % n
                nxt = ("m", "g", k, s, r)
                cur[(r, i, s)] = nxt
    # canonicalise chunk buffers for the concat output
    chunk_bufs = _chunk_names(n, S)
    for r in range(n):
        for i in range(n):
            for s in range(S):
                want = ("c", i, s) if S > 1 else ("c", i)
                have = cur[(r, i, s)]
                if have != want:
                    b.programs[r].append(Copy(want, have))
    sched = Schedule(name="allreduce", algorithm="ring", n=n,
                     programs=tuple(tuple(p) for p in b.programs),
                     input_kind="chunks", output_kind="concat",
                     segments=S, chunk_bufs=tuple(chunk_bufs))
    return _fix_recv_order(sched).validate()


def _allreduce_doubling(n: int) -> Schedule:
    """Recursive doubling with fold/unfold for non-power-of-two ``n``."""
    b = _B(n)
    pow2 = _pow2_below(n)
    rem = n - pow2
    acc: List[Any] = ["in"] * n
    out: List[Any] = [None] * n
    members = []            # butterfly participants with their virtual rank
    for r in range(n):
        if r < 2 * rem:
            if r % 2:
                b.xfer(r, r - 1, acc[r], ("m", "fold", r - 1))
            else:
                nxt = ("a", "fold", r)
                b.programs[r].append(
                    Combine(nxt, acc[r], ("m", "fold", r)))
                acc[r] = nxt
                members.append((r, r // 2))
        else:
            members.append((r, r - rem))
    mask = 1
    while mask < pow2:
        for r, vr in members:
            partner_vr = vr ^ mask
            partner = partner_vr * 2 if partner_vr < rem \
                else partner_vr + rem
            b.xfer(r, partner, acc[r], ("m", "x", mask, partner))
        for r, vr in members:
            nxt = ("a", "x", mask, r)
            b.programs[r].append(Combine(nxt, acc[r], ("m", "x", mask, r)))
            acc[r] = nxt
        mask <<= 1
    for r in range(n):
        if r < 2 * rem and r % 2:
            out[r] = ("m", "unfold", r)
        else:
            out[r] = acc[r]
            if r < 2 * rem:
                b.xfer(r, r + 1, acc[r], ("m", "unfold", r + 1))
    sched = Schedule(name="allreduce", algorithm="doubling", n=n,
                     programs=tuple(tuple(p) for p in b.programs),
                     input_kind="array", output_kind="buf",
                     out_bufs=tuple(out))
    return _fix_recv_order(sched).validate()


def _allgather_ring(n: int, segments: int = 1) -> Schedule:
    """Ring allgather; with ``segments=S > 1`` every contribution is
    sliced into S segments forwarded as independent pipelined rings (the
    store-and-forward segmentation), reassembled per source rank by a
    trailing :class:`Concat` shaped like the local ``"in"``."""
    b = _B(n)
    S = segments
    if S == 1:
        for r in range(n):
            b.programs[r].append(Copy(("g", r), "in"))
        for k in range(n - 1):
            for r in range(n):
                b.xfer(r, (r + 1) % n, ("g", (r - k) % n),
                       ("m", k, (r + 1) % n))
            for r in range(n):
                b.programs[r].append(
                    Copy(("g", (r - k - 1) % n), ("m", k, r)))
        sched = Schedule(name="allgather", algorithm="ring", n=n,
                         programs=tuple(tuple(p) for p in b.programs),
                         input_kind="value", output_kind="list")
        return _fix_recv_order(sched).validate()
    for r in range(n):
        for s in range(S):
            b.programs[r].append(Slice(("gs", r, s), "in", S, s))
    frac = 1.0 / S
    for k in range(n - 1):
        for s in range(S):
            for r in range(n):
                b.xfer(r, (r + 1) % n, ("gs", (r - k) % n, s),
                       ("m", k, s, (r + 1) % n), frac)
            for r in range(n):
                b.programs[r].append(
                    Copy(("gs", (r - k - 1) % n, s), ("m", k, s, r)))
    for r in range(n):
        for i in range(n):
            b.programs[r].append(
                Concat(("g", i), tuple(("gs", i, s) for s in range(S)),
                       like="in"))
    sched = Schedule(name="allgather", algorithm="ring", n=n,
                     programs=tuple(tuple(p) for p in b.programs),
                     input_kind="value", output_kind="list", segments=S)
    return _fix_recv_order(sched).validate()


def _allgather_bruck(n: int) -> Schedule:
    """Bruck allgather: ⌈log2 n⌉ rounds, any rank count.  ``("a", j)`` is
    the j-th item of the rank's growing accumulator (item j = rank
    ``(r + j) % n``'s contribution)."""
    b = _B(n)
    for r in range(n):
        b.programs[r].append(Copy(("a", 0), "in"))
    length = 1
    k = 1
    while k < n:
        cnt = min(k, n - k)
        for r in range(n):
            parts = tuple(("a", j) for j in range(cnt))
            b.programs[r].append(Pack(("p", k), parts))
            b.xfer(r, (r - k) % n, ("p", k), ("m", k, (r - k) % n),
                   frac=float(cnt))
        for r in range(n):
            outs = tuple(("a", length + j) for j in range(cnt))
            b.programs[r].append(Unpack(outs, ("m", k, r)))
        length += cnt
        k <<= 1
    for r in range(n):
        for i in range(n):
            b.programs[r].append(Copy(("g", i), ("a", (i - r) % n)))
    sched = Schedule(name="allgather", algorithm="doubling", n=n,
                     programs=tuple(tuple(p) for p in b.programs),
                     input_kind="value", output_kind="list")
    return _fix_recv_order(sched).validate()


def _reduce_scatter_ring(n: int, segments: int = 1) -> Schedule:
    """Ring reduce-scatter; ``segments=S > 1`` pipelines exactly like the
    segmented allreduce's reduce-scatter leg — the combine of segment
    ``s`` overlaps the transport of segment ``s+1`` — and a trailing
    :class:`Concat` reassembles each rank's owned chunk (bit-identical to
    the unsegmented chunk: ``array_split`` composes with itself)."""
    b = _B(n)
    S = segments
    cur: Dict[Tuple[int, int, int], Any] = {}
    for r in range(n):
        for i in range(n):
            for s in range(S):
                cur[(r, i, s)] = ("c", i, s) if S > 1 else ("c", i)
    frac = 1.0 / (n * S)
    for k in range(n - 1):
        for s in range(S):
            for r in range(n):
                b.xfer(r, (r + 1) % n, cur[(r, (r - 1 - k) % n, s)],
                       ("m", k, s, (r + 1) % n), frac)
            for r in range(n):
                i = (r - 2 - k) % n
                nxt = ("a", k, s, i)
                b.programs[r].append(
                    Combine(nxt, cur[(r, i, s)], ("m", k, s, r), frac))
                cur[(r, i, s)] = nxt
    if S == 1:
        out = tuple(cur[(r, r, 0)] for r in range(n))
    else:
        for r in range(n):
            b.programs[r].append(
                Concat(("rs", r), tuple(cur[(r, r, s)] for s in range(S))))
        out = tuple(("rs", r) for r in range(n))
    sched = Schedule(name="reduce_scatter", algorithm="ring", n=n,
                     programs=tuple(tuple(p) for p in b.programs),
                     input_kind="chunks", output_kind="buf", segments=S,
                     out_bufs=out, chunk_bufs=tuple(_chunk_names(n, S)))
    return _fix_recv_order(sched).validate()


def _reduce_scatter_doubling(n: int) -> Schedule:
    """Doubling allreduce + slice (recursive halving's power-of-two block
    mapping clashes with n-way output blocks — same trade as before the
    IR refactor)."""
    base = _allreduce_doubling(n)
    progs = []
    out = []
    for r, prog in enumerate(base.programs):
        prog = list(prog)
        src = base.out_bufs[r]
        prog.append(Slice(("rs", r), src, n, r))
        progs.append(tuple(prog))
        out.append(("rs", r))
    return Schedule(name="reduce_scatter", algorithm="doubling", n=n,
                    programs=tuple(progs), input_kind="array",
                    output_kind="buf", out_bufs=tuple(out)).validate()


def _alltoall_pairwise(n: int) -> Schedule:
    b = _B(n)
    for r in range(n):
        b.programs[r].append(Copy(("g", r), ("b", r)))
    for k in range(1, n):
        for r in range(n):
            dst = (r + k) % n
            b.xfer(r, dst, ("b", dst), ("m", k, dst))
        for r in range(n):
            src = (r - k) % n
            b.programs[r].append(Copy(("g", src), ("m", k, r)))
    sched = Schedule(name="alltoall", algorithm="ring", n=n,
                     programs=tuple(tuple(p) for p in b.programs),
                     input_kind="blocks", output_kind="list")
    return _fix_recv_order(sched).validate()


def _alltoall_bruck(n: int) -> Schedule:
    """Bruck all-to-all: rotate, ⌈log2 n⌉ bit-rounds, inverse rotate."""
    b = _B(n)
    for r in range(n):
        for j in range(n):
            b.programs[r].append(Copy(("t", j), ("b", (r + j) % n)))
    k = 1
    while k < n:
        idxs = [j for j in range(n) if j & k]
        for r in range(n):
            b.programs[r].append(
                Pack(("p", k), tuple(("t", j) for j in idxs)))
            b.xfer(r, (r + k) % n, ("p", k), ("m", k, (r + k) % n),
                   frac=float(len(idxs)))
        for r in range(n):
            b.programs[r].append(
                Unpack(tuple(("t2", k, j) for j in idxs), ("m", k, r)))
            for j in idxs:
                b.programs[r].append(Copy(("t", j), ("t2", k, j)))
        k <<= 1
    for r in range(n):
        for i in range(n):
            b.programs[r].append(Copy(("g", i), ("t", (r - i) % n)))
    sched = Schedule(name="alltoall", algorithm="doubling", n=n,
                     programs=tuple(tuple(p) for p in b.programs),
                     input_kind="blocks", output_kind="list")
    return _fix_recv_order(sched).validate()


# ---------------------------------------------------------------------------
# Public constructors (cached: schedules are immutable data)
# ---------------------------------------------------------------------------
def build(name: str, algorithm: str, n: int, *, root: int = 0,
          segments: int = 1) -> Schedule:
    """Build (or fetch the cached) schedule for one collective.

    ``segments > 1`` is supported for ``("allreduce", "ring")`` — the
    segmented/pipelined large-payload schedule; every other (name,
    algorithm) pair takes ``segments=1``.  Identical parameters return
    the identical (immutable) object.
    """
    return _build_cached(name, algorithm, int(n), int(root), int(segments))


@functools.lru_cache(maxsize=512)
def _build_cached(name: str, algorithm: str, n: int, root: int,
                  segments: int) -> Schedule:
    if n < 1:
        raise ValueError(f"need at least one rank, got n={n}")
    if name not in COLLECTIVES:
        raise ValueError(f"unknown collective {name!r}; "
                         f"one of {sorted(COLLECTIVES)}")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"one of {sorted(ALGORITHMS)}")
    if not 0 <= root < n:
        raise ValueError(f"root {root} out of range for n={n}")
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    if segments > 1 and not (algorithm == "ring" and name in (
            "allreduce", "allgather", "reduce_scatter")):
        raise ValueError("segmented schedules are only defined for the "
                         "ring allreduce/allgather/reduce_scatter")
    if n == 1:
        return _trivial(name, algorithm)
    if name == "barrier":
        return (_barrier_dissemination if algorithm == "doubling"
                else _barrier_ring)(n)
    if name == "bcast":
        return (_bcast_tree if algorithm == "doubling"
                else _bcast_chain)(n, root)
    if name == "reduce":
        return (_reduce_tree if algorithm == "doubling"
                else _reduce_chain)(n, root)
    if name == "allreduce":
        if algorithm == "doubling":
            return _allreduce_doubling(n)
        return _allreduce_ring(n, segments)
    if name == "allgather":
        return (_allgather_bruck(n) if algorithm == "doubling"
                else _allgather_ring(n, segments))
    if name == "reduce_scatter":
        return (_reduce_scatter_doubling(n) if algorithm == "doubling"
                else _reduce_scatter_ring(n, segments))
    return (_alltoall_bruck if algorithm == "doubling"
            else _alltoall_pairwise)(n)


def _trivial(name: str, algorithm: str) -> Schedule:
    """Single-rank schedules: no transfers, identity outputs."""
    prog: Tuple[Op, ...] = ()
    kw: Dict[str, Any] = {}
    if name == "barrier":
        ik, ok = "none", "none"
    elif name == "bcast":
        ik, ok = "value", "buf"
        kw["out_bufs"] = ("in",)
    elif name == "reduce":
        ik, ok = "array", "buf"
        kw["out_bufs"] = ("in",)
    elif name == "allreduce":
        ik, ok = "array", "buf"
        kw["out_bufs"] = ("in",)
    elif name == "allgather":
        ik, ok = "value", "list"
        prog = (Copy(("g", 0), "in"),)
    elif name == "reduce_scatter":
        ik, ok = "array", "buf"
        prog = (Slice(("rs", 0), "in", 1, 0),)
        kw["out_bufs"] = (("rs", 0),)
    else:   # alltoall
        ik, ok = "blocks", "list"
        prog = (Copy(("g", 0), ("b", 0)),)
    return Schedule(name=name, algorithm=algorithm, n=1,
                    programs=(prog,), input_kind=ik, output_kind=ok,
                    **kw).validate()


@functools.lru_cache(maxsize=256)
def build_neighbor(topology: Tuple[Tuple[Tuple[Any, int], ...], ...],
                   in_topology: Optional[
                       Tuple[Tuple[Any, ...], ...]] = None) -> Schedule:
    """Neighbourhood all-to-all over a fixed topology.

    ``topology[r]`` is rank r's persistent *send* neighbour list
    ``(((dim, ±1), neighbour), ...)`` — the shape produced by
    :meth:`repro_torch.core.tac.CartGroup.neighbor_dirs` /
    :meth:`repro_torch.core.tac.CartGroup.topology`.  Rank r sends its
    ``("s", d)`` buffer toward each direction ``d``; the payload lands in
    the neighbour's ``("rv", opp(d))`` buffer where ``opp(d) = (d[0],
    -d[1])``.  By default receives mirror sends (reciprocity: if r's
    ``d``-neighbour is q, then q's ``-d``-neighbour is r).

    For a **directed** topology (one-way edges —
    :meth:`repro_torch.core.tac.DistGraphGroup.in_topology`), pass
    ``in_topology[r]`` = rank r's receive-direction labels.  The derived
    arrivals are validated against the declaration: every send must land
    on a declared in-direction of its destination, and every declared
    in-direction must be fed by exactly one send.
    """
    n = len(topology)
    b = _B(n)
    derived_in: List[List[Any]] = [[] for _ in range(n)]
    for r, dirs in enumerate(topology):
        for d, nbr in dirs:
            dim, disp = d
            opp = (dim, -disp)
            b.xfer(r, nbr, ("s", d), ("rv", opp), tag=("n", d, r))
            derived_in[nbr].append(opp)
    out_dirs = tuple(tuple(d for d, _ in dirs) for dirs in topology)
    in_dirs: Tuple[Tuple[Any, ...], ...] = ()
    if in_topology is not None:
        if len(in_topology) != n:
            raise ValueError(f"in_topology covers {len(in_topology)} ranks, "
                             f"topology has {n}")
        in_dirs = tuple(tuple(dirs) for dirs in in_topology)
        for r in range(n):
            declared, derived = list(in_dirs[r]), derived_in[r]
            if sorted(declared, key=repr) != sorted(derived, key=repr):
                raise ValueError(
                    f"rank {r}: declared in-directions {declared} do not "
                    f"match the directions arriving from the send "
                    f"topology {sorted(derived, key=repr)}")
    sched = Schedule(name="neighbor_alltoall", algorithm="neighbor", n=n,
                     programs=tuple(tuple(p) for p in b.programs),
                     input_kind="dirs", output_kind="dirs",
                     out_dirs=out_dirs, in_dirs=in_dirs)
    return _fix_recv_order(sched).validate()


# ---------------------------------------------------------------------------
# Hierarchical composition: one flat schedule spanning two mesh axes
# ---------------------------------------------------------------------------
def _embed(b: _B, sub: Schedule, ranks: Sequence[int], ns: Any, *,
           inputs: Dict[int, Any], frac_scale: float = 1.0) -> List[Any]:
    """Splice ``sub``'s per-rank programs into builder ``b``.

    ``ranks[sr]`` maps sub-rank ``sr`` to its global rank; ``inputs[sr]``
    binds the sub-schedule's ``"in"`` buffer to an existing global buffer;
    internal buffers and tags are namespaced under ``ns`` (which must be
    unique per embedding) so sibling embeddings can never collide;
    ``frac_scale`` rescales per-op payload fractions to the enclosing
    schedule's nominal size.  Supports ``array``/``value`` input and
    ``buf`` output sub-schedules (the reductions); returns the renamed
    per-sub-rank output buffers.
    """
    if sub.input_kind not in ("array", "value") or sub.output_kind != "buf":
        raise ValueError(f"cannot embed a {sub.input_kind!r}->"
                         f"{sub.output_kind!r} schedule")

    def rename(sr: int, buf: Any) -> Any:
        return inputs[sr] if buf == "in" else (ns, buf)

    for sr, prog in enumerate(sub.programs):
        gr = ranks[sr]
        for op in prog:
            if isinstance(op, Send):
                b.programs[gr].append(Send(
                    ranks[op.peer], rename(sr, op.buf), (ns, op.tag),
                    op.frac * frac_scale))
            elif isinstance(op, Recv):
                b.programs[gr].append(Recv(
                    ranks[op.peer], rename(sr, op.buf), (ns, op.tag),
                    op.frac * frac_scale))
            elif isinstance(op, Combine):
                b.programs[gr].append(Combine(
                    rename(sr, op.out), rename(sr, op.a), rename(sr, op.b),
                    op.frac * frac_scale))
            elif isinstance(op, Copy):
                b.programs[gr].append(Copy(rename(sr, op.out),
                                           rename(sr, op.src)))
            elif isinstance(op, Const):
                b.programs[gr].append(Const(rename(sr, op.out), op.value))
            else:
                raise ValueError(f"cannot embed op {op!r}")
    return [rename(sr, sub.out_bufs[sr]) for sr in range(sub.n)]


def build_hierarchical(intra: int, inter: int, *,
                       inter_algorithm: str = "doubling") -> Schedule:
    """Hierarchical allreduce over a 2-D (inter × intra) rank grid.

    One FLAT schedule over ``n = intra·inter`` ranks (global rank
    ``r = pod·intra + local``) composing three stages:

    1. ring **reduce-scatter** inside each pod (``intra-1`` rounds of
       ``m/intra`` bytes — after it, local rank ``l`` owns the pod-sum of
       chunk ``l``);
    2. recursive-doubling **allreduce** of each owned chunk across pods
       (every pod's rank ``l`` butterflies chunk ``l`` with its peers —
       the :func:`_allreduce_doubling` sub-schedule embedded per chunk via
       :func:`_embed`, fold/unfold handling any pod count);
    3. ring **allgather** inside each pod (shard-wise broadcast back —
       ``intra-1`` more rounds), so every rank finishes with the global
       sum.

    Because the result is an ordinary validated :class:`Schedule`, all
    four consumers run it unchanged: the Level-A interpreter
    (:func:`repro_torch.core.collectives._interpret`), the Level-B two-axis
    lowering (:func:`repro.core.lowering.lower_allreduce` — intra-axis
    ppermute rounds, inter-axis butterfly or fused psum), the α-β
    :meth:`Schedule.cost`, and the discrete-event replay
    (:func:`repro.core.simulate.schedule_tasks`).  ``Schedule.axes``
    records the ``(("inter", n_e), ("intra", n_i))`` factorisation the
    lowering and the two-tier link model key off.
    """
    return _hier_cached(int(intra), int(inter), inter_algorithm)


@functools.lru_cache(maxsize=128)
def _hier_cached(intra: int, inter: int, inter_algorithm: str) -> Schedule:
    if intra < 1 or inter < 1:
        raise ValueError(f"need positive axis sizes, got intra={intra}, "
                         f"inter={inter}")
    if inter_algorithm != "doubling":
        raise ValueError(f"inter stage supports 'doubling' (butterfly / "
                         f"fused psum at Level B), got {inter_algorithm!r}")
    n = intra * inter
    b = _B(n)
    frac = 1.0 / intra
    cur: Dict[Tuple[int, int], Any] = {(r, i): ("c", i)
                                       for r in range(n)
                                       for i in range(intra)}
    # stage 1 — intra ring reduce-scatter within each pod
    for k in range(intra - 1):
        for r in range(n):
            pod, loc = divmod(r, intra)
            dst = pod * intra + (loc + 1) % intra
            b.xfer(r, dst, cur[(r, (loc - 1 - k) % intra)],
                   ("m", "rs", k, dst), frac)
        for r in range(n):
            _, loc = divmod(r, intra)
            i = (loc - 2 - k) % intra
            nxt = ("a", "rs", k, i)
            b.programs[r].append(
                Combine(nxt, cur[(r, i)], ("m", "rs", k, r), frac))
            cur[(r, i)] = nxt
    # stage 2 — inter allreduce of each rank's owned chunk across pods
    if inter > 1:
        sub = build("allreduce", inter_algorithm, inter)
        for loc in range(intra):
            ranks = tuple(pod * intra + loc for pod in range(inter))
            outs = _embed(b, sub, ranks, ("x", loc),
                          inputs={sr: cur[(gr, loc)]
                                  for sr, gr in enumerate(ranks)},
                          frac_scale=frac)
            for sr, gr in enumerate(ranks):
                cur[(gr, loc)] = outs[sr]
    # stage 3 — intra ring allgather (shard-wise broadcast back down)
    for k in range(intra - 1):
        for r in range(n):
            pod, loc = divmod(r, intra)
            dst = pod * intra + (loc + 1) % intra
            b.xfer(r, dst, cur[(r, (loc - k) % intra)],
                   ("m", "ag", k, dst), frac)
        for r in range(n):
            _, loc = divmod(r, intra)
            cur[(r, (loc - k - 1) % intra)] = ("m", "ag", k, r)
    # canonicalise chunk buffers for the concat output
    for r in range(n):
        for i in range(intra):
            if cur[(r, i)] != ("c", i):
                b.programs[r].append(Copy(("c", i), cur[(r, i)]))
    sched = Schedule(name="allreduce", algorithm="hierarchical", n=n,
                     programs=tuple(tuple(p) for p in b.programs),
                     input_kind="chunks", output_kind="concat",
                     chunk_bufs=tuple(("c", i) for i in range(intra)),
                     n_chunks=intra,
                     axes=(("inter", inter), ("intra", intra)))
    return _fix_recv_order(sched).validate()


# ---------------------------------------------------------------------------
# Calibrated constants (tools/calibrate.py output)
# ---------------------------------------------------------------------------
def load_calibration(path: Any = "CALIBRATION.json",
                     family: Optional[str] = None) -> Dict[str, float]:
    """Read α/β/γ least-squares fitted by ``tools/calibrate.py``.

    Returns exactly ``{"alpha", "beta", "gamma"}`` — ready to splat into
    :func:`best_schedule`/:meth:`Schedule.cost` keyword arguments, and
    what ``Collectives(comm, calibration=path)`` consumes so
    ``algorithm="auto"`` selects under measured rather than nominal
    constants.  (The calibration file also carries a per-call
    ``overhead`` term the fit absorbs; schedule costs deliberately
    exclude it.)

    ``family`` selects one of the per-family fits (``"inter"`` is the
    inter-pod transport measured by the butterfly legs of
    ``benchmarks/overlap_bench.py`` — the constants the two-tier
    hierarchical candidate of :func:`best_schedule` pays for cross-pod
    hops); ``None`` keeps the top-level global fit.  Raises ``KeyError``
    when the requested family has not been calibrated yet.
    """
    import json
    import pathlib
    data = json.loads(pathlib.Path(path).read_text())
    if family is not None:
        fams = data.get("families", {})
        if family not in fams:
            raise KeyError(f"no calibrated family {family!r} in {path} "
                           f"(have {sorted(fams)})")
        data = fams[family]
    return {k: float(data[k]) for k in ("alpha", "beta", "gamma")}


# ---------------------------------------------------------------------------
# α-β driven selection
# ---------------------------------------------------------------------------
def best_schedule(name: str, n: int, size: float, *, alpha: float,
                  beta: float, gamma: float = 0.0, root: int = 0,
                  segment_choices: Sequence[int] = (1, 2, 4, 8),
                  intra: Optional[int] = None,
                  inter_alpha: Optional[float] = None,
                  inter_beta: Optional[float] = None) -> Schedule:
    """Pick algorithm AND segment count by minimum predicted cost.

    The α-β replacement for choosing by bare round counts: latency-bound
    payloads pick ``doubling`` (⌈log2 n⌉ rounds), bandwidth-bound ones
    pick ``ring`` (2(n-1) rounds of size/n), and — with a combine cost
    ``gamma > 0`` — large ring allreduces segment so combine pipelines
    against transport.  Selections are cached (the cost() DAG walks are
    pure Python): a per-iteration ``algorithm="auto"`` collective pays
    the evaluation once, not once per rank per posting.

    ``intra`` declares a pod structure (``intra`` consecutive ranks per
    pod): every candidate is then costed under a **two-tier link** —
    intra-pod hops pay (``alpha``, ``beta``), cross-pod hops pay
    (``inter_alpha``, ``inter_beta``; calibrate via
    ``load_calibration(path, family="inter")``, defaulting to the base
    constants) — and for the allreduce the composed
    :func:`build_hierarchical` schedule joins the candidate set, so a
    pod-aware machine picks the hierarchical schedule exactly when the
    inter constants make flat rings lose.
    """
    if intra is not None:
        intra = int(intra)
        if intra < 2 or n % intra or n // intra < 2:
            intra = None        # no real pod structure at this size
    return _best_cached(name, int(n), float(size), float(alpha),
                        float(beta), float(gamma), int(root),
                        tuple(int(s) for s in segment_choices), intra,
                        None if inter_alpha is None else float(inter_alpha),
                        None if inter_beta is None else float(inter_beta))


@functools.lru_cache(maxsize=1024)
def _best_cached(name: str, n: int, size: float, alpha: float, beta: float,
                 gamma: float, root: int,
                 segment_choices: Tuple[int, ...],
                 intra: Optional[int] = None,
                 inter_alpha: Optional[float] = None,
                 inter_beta: Optional[float] = None) -> Schedule:
    candidates: List[Schedule] = []
    for alg in ALGORITHMS:
        candidates.append(build(name, alg, n, root=root))
        if alg == "ring" and name in ("allreduce", "allgather",
                                      "reduce_scatter"):
            for s in segment_choices:
                if s > 1:
                    candidates.append(build(name, alg, n, root=root,
                                            segments=s))
    link = None
    if intra is not None:
        if name == "allreduce":
            candidates.append(build_hierarchical(intra, n // intra))
        ia = alpha if inter_alpha is None else inter_alpha
        ib = beta if inter_beta is None else inter_beta

        def link(src, dst):
            return (alpha, beta) if src // intra == dst // intra \
                else (ia, ib)
    return min(candidates,
               key=lambda s: s.cost(alpha, beta, size, gamma=gamma,
                                    link=link))
