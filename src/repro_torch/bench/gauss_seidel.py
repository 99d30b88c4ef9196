"""Gauss–Seidel / heat-equation benchmark on the port — paper §7.1.

The port of ``benchmarks/gauss_seidel.py``'s real execution: the same five
versions (``pure``, ``forkjoin``, ``sentinel``, ``interop-blk``,
``interop-nonblk``), the same 2-D Cartesian rank grid with ``nby × nbx``
blocks per rank, one :class:`~repro_torch.core.collectives.HaloExchange`
round per rank per iteration (Gauss–Seidel wavefront inside a rank, Jacobi
coupling across ranks) and the per-iteration residual through the
persistent hierarchical allreduce.  What changes is where the data lives:
the grid, its blocks and the halo edges are tensors on the run's device,
and with ``block_impl="cuda"`` every block step is one launch of the
hand-written ``gs_stencil`` kernel.  Only the per-block residual scalars
come to the host, where the reference calls ``float(res)``.

Each logical rank has its own CUDA stream, entered inside every task body
(the current stream is thread-local).  Halo payloads are made on the
sending rank's stream and read by the receiving rank's kernels on theirs,
so the sender waits on an :class:`~repro_torch.core.tac.ArrayHandle` over
them before posting the exchange — ``tac.wait``, which pauses the task in
the interop versions (§6.1).  Every tensor that crosses streams stays
referenced until :func:`run_real` returns.

Besides the real execution: the simulated scaling curves
(``build_sim_graph`` / ``simulate_version``, the same task graphs on the
port's :mod:`~repro_torch.core.simulate`), ``bench`` (the reference's
parity legs and scaling rows), ``run_traced`` (three versions under one
tracer, exported as Perfetto JSON) and ``run_elastic`` (an injected rank
death, shrink and resume from :mod:`repro_torch.checkpoint`).

Run: ``python -m repro_torch.bench.gauss_seidel`` (``--smoke`` for the
parity legs and one simulated point, ``--trace PATH`` for the traced legs,
``--device cpu`` to run on the CPU).
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import (Collectives, HaloExchange, HierarchicalCollectives,
                    TaskRuntime, tac)
from ..core.mesh import resolve_device
from ..core.simulate import (COMM_EVENTS, COMM_HELD, COMM_PAUSED, COMPUTE,
                             SimTask, Simulator)
from ..kernels import ops as kernel_ops

VERSIONS = ("pure", "forkjoin", "sentinel", "interop-blk", "interop-nonblk")
BLOCK_IMPLS = (None, "ref", "cuda")


def grid_dims(n_ranks: int) -> Tuple[int, int]:
    """Most-square 2-D factorization of ``n_ranks`` (py >= px)."""
    for d in range(int(math.isqrt(n_ranks)), 0, -1):
        if n_ranks % d == 0:
            return (n_ranks // d, d)
    return (n_ranks, 1)


def edge_blocks(cart, nby, nbx, r, d):
    """Block coordinates of rank ``r``'s tile edge facing direction ``d``
    (the boundary geometry shared by halo payloads and task deps)."""
    ry, rx = cart.coords(r)
    dim, disp = d
    if dim == 0:
        gy = ry * nby if disp < 0 else (ry + 1) * nby - 1
        return [(gy, rx * nbx + j) for j in range(nbx)]
    gx = rx * nbx if disp < 0 else (rx + 1) * nbx - 1
    return [(ry * nby + i, gx) for i in range(nby)]


def gs_block(block, top, left, bottom, right):
    """The unfused block update, elementwise in the reference's order."""
    padded = torch.nn.functional.pad(block, (1, 1, 1, 1))
    padded[0, 1:-1] = top
    padded[-1, 1:-1] = bottom
    padded[1:-1, 0] = left
    padded[1:-1, -1] = right
    return 0.25 * (padded[:-2, 1:-1] + padded[2:, 1:-1]
                   + padded[1:-1, :-2] + padded[1:-1, 2:])


def state_from_reference(blocks: Sequence[Sequence[np.ndarray]], *,
                         device, dtype) -> List[List[torch.Tensor]]:
    """The port's initial blocks from the reference's numpy draws.

    ``blocks[gy][gx]`` is the reference's initial block list, drawn row-major
    over blocks as ``default_rng(seed).standard_normal((bs, bs))``; the
    result holds the same values as ``dtype`` tensors on ``device``, so both
    packages start from bit-identical state (rounded once where ``dtype``
    is narrower than float64, as the reference's fused path rounds)."""
    device = resolve_device(device)
    return [[torch.from_numpy(np.ascontiguousarray(b)).to(device, dtype)
             for b in row] for row in blocks]


# ---------------------------------------------------------------------------
# real execution on the host runtime, data on the device
# ---------------------------------------------------------------------------
def run_real(version: str, *, n_ranks: int = 4, workers: int = 2,
             nby: int = 2, nbx: int = 2, bs: int = 16, iters: int = 3,
             seed: int = 0, notify: Optional[str] = None,
             block_impl: Optional[str] = "cuda", device=None):
    """Returns (final grid as a tensor on the run's device, stats);
    ``stats["seconds"]`` is the wall time of the iterations.

    ``device`` defaults to the CUDA device (and raises without one).
    ``notify`` picks the runtime's completion-notification backend
    ("polling" / "continuation"; None = the REPRO_NOTIFY env default).

    ``block_impl`` picks the per-block stage:

    * ``"cuda"`` (default) — the fused stage through the ``gs_stencil``
      kernel wrapper, fp32: the hand-written kernel on a CUDA device, its
      plain version for CPU tensors.  ONE pass over the block produces the
      update, the residual contribution AND the four packed boundary edges;
      halo payloads and residual sums are read from those per-block caches.
    * ``"ref"`` — the same fused stage in plain PyTorch, fp32.
    * ``None`` — the unfused float64 path, elementwise in the reference's
      order (bit-exact with ``benchmarks/gauss_seidel.run_real``).

    Dataflow: grids[it][gy][gx]; block (gy,gx) at iteration it reads
    up/left from iteration it when the neighbour block is on the SAME
    rank (spatial wavefront) and self/down/right from it-1; every
    cross-rank side reads the neighbour rank's it-1 boundary, delivered
    by that iteration's halo exchange.
    """
    if version not in VERSIONS:
        raise ValueError(f"version must be one of {VERSIONS}, got "
                         f"{version!r}")
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}, got "
                         f"{block_impl!r}")
    device = resolve_device(device)
    dtype = torch.float64 if block_impl is None else torch.float32
    py, px = grid_dims(n_ranks)
    NYb, NXb = py * nby, px * nbx
    rng = np.random.default_rng(seed)
    grids: Dict[int, list] = {0: state_from_reference(
        [[rng.standard_normal((bs, bs)) for _ in range(NXb)]
         for _ in range(NYb)], device=device, dtype=dtype)}
    for it in range(1, iters + 1):
        grids[it] = [[None] * NXb for _ in range(NYb)]
    zeros = torch.zeros(bs, dtype=dtype, device=device)
    streams = ([torch.cuda.Stream(device) for _ in range(n_ranks)]
               if device.type == "cuda" else None)
    if streams:
        # the initial grid and the zero halos were made on the default
        # stream; every rank stream reads them
        torch.cuda.synchronize(device)

    world = tac.CommWorld(n_ranks)
    cart = world.cart_create((py, px))
    hx = HaloExchange(cart)
    hier = HierarchicalCollectives(world, px)   # intra-row + leader column
    # persistent residual allreduce (MPI_Allreduce_init analogue)
    residual_coll = hier.persistent(op="sum")
    halos: Dict = {}       # (rank, it) -> {direction: edge} | handle
    residuals: Dict = {}   # (rank, it) -> float | CollectiveHandle
    res_cache: Dict = {}   # (gy, gx, it) -> fused per-block residual
    edge_cache: Dict = {}  # (gy, gx, it) -> (top, bottom, left, right)
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

    def rank_of(gy, gx):
        return cart.rank_at((gy // nby, gx // nbx))

    def packed_edge(gy, gx, it, d):
        """A boundary edge from the fused kernel's boundary-pack output."""
        te, be, le, re = edge_cache[(gy, gx, it)]
        dim, disp = d
        if dim == 0:
            return te if disp < 0 else be
        return le if disp < 0 else re

    def column(gy, gx, it, j):
        """Column ``j`` (0 or -1) of block (gy, gx) at iteration ``it`` as
        a contiguous vector: the fused kernel's packed edge where there is
        one, else a copy of the strided column."""
        packed = edge_cache.get((gy, gx, it))
        if packed is not None:
            return packed[2] if j == 0 else packed[3]
        return grids[it][gy][gx][:, j].contiguous()

    def halo_sends(r, it):
        """Outgoing it-1 boundary edges, one concatenated tensor per
        neighbour direction, made on rank r's stream and complete on the
        device on return (they are read on the neighbours' streams)."""
        out = {}
        with on_rank(r):
            for d, _ in hx.neighbors(r):
                cells = edge_blocks(cart, nby, nbx, r, d)
                if block_impl is not None and \
                        (cells[0] + (it - 1,)) in edge_cache:
                    out[d] = torch.cat(
                        [packed_edge(gy, gx, it - 1, d) for gy, gx in cells])
                    continue
                dim, disp = d
                edge = 0 if disp < 0 else -1
                out[d] = torch.cat(
                    [grids[it - 1][gy][gx][edge, :] if dim == 0
                     else grids[it - 1][gy][gx][:, edge]
                     for gy, gx in cells])
            ready = tac.ArrayHandle(out)
        # Task-aware: pauses a TASK_MULTIPLE task until the event fires,
        # a plain event.synchronize() elsewhere.
        tac.wait(ready)
        return out

    def boundary_blocks(r):
        """Block coordinates whose it-1 data feeds r's outgoing halos."""
        keys = set()
        for d, _ in hx.neighbors(r):
            keys.update(edge_blocks(cart, nby, nbx, r, d))
        return sorted(keys)

    def halo_edge(r, it, d, offset):
        h = halos[(r, it)]
        if isinstance(h, tac.AsyncHandle):
            h = h.result
        return h[d][offset * bs:(offset + 1) * bs]

    def compute_block(gy, gx, it):
        r = rank_of(gy, gx)
        with on_rank(r):
            block_step(gy, gx, it, r)

    def block_step(gy, gx, it, r):
        ry, rx = gy // nby, gx // nbx
        g_cur, g_prev = grids[it], grids[it - 1]
        if gy == 0:
            top = zeros
        elif gy % nby == 0:
            top = halo_edge(r, it, (0, -1), gx - rx * nbx)
        else:
            top = g_cur[gy - 1][gx][-1, :]
        if gx == 0:
            left = zeros
        elif gx % nbx == 0:
            left = halo_edge(r, it, (1, -1), gy - ry * nby)
        else:
            left = column(gy, gx - 1, it, -1)
        if gy == NYb - 1:
            bottom = zeros
        elif (gy + 1) % nby == 0:
            bottom = halo_edge(r, it, (0, 1), gx - rx * nbx)
        else:
            bottom = g_prev[gy + 1][gx][0, :]
        if gx == NXb - 1:
            right = zeros
        elif (gx + 1) % nbx == 0:
            right = halo_edge(r, it, (1, 1), gy - ry * nby)
        else:
            right = column(gy, gx + 1, it - 1, 0)
        if block_impl is None:
            grids[it][gy][gx] = gs_block(g_prev[gy][gx], top, left,
                                         bottom, right)
            return
        new, res, edges = kernel_ops.gs_stencil(
            g_prev[gy][gx], top, left, bottom, right, impl=block_impl)
        grids[it][gy][gx] = new
        # the one device-to-host read per block; it also syncs r's
        # stream, so the block and its edges are complete here
        res_cache[(gy, gx, it)] = res.item()
        edge_cache[(gy, gx, it)] = edges

    def block_deps(gy, gx, it):
        """Region deps for the compute task (task versions only)."""
        r = rank_of(gy, gx)
        deps = [("blk", gy, gx, it - 1)]
        crosses = False
        if gy > 0:
            if gy % nby:
                deps.append(("blk", gy - 1, gx, it))
            else:
                crosses = True
        if gx > 0:
            if gx % nbx:
                deps.append(("blk", gy, gx - 1, it))
            else:
                crosses = True
        if gy < NYb - 1:
            if (gy + 1) % nby:
                deps.append(("blk", gy + 1, gx, it - 1))
            else:
                crosses = True
        if gx < NXb - 1:
            if (gx + 1) % nbx:
                deps.append(("blk", gy, gx + 1, it - 1))
            else:
                crosses = True
        if crosses:
            deps.append(("halo", r, it))
        return deps

    def local_residual(r, it):
        ry, rx = cart.coords(r)
        tot = 0.0
        with on_rank(r):
            for gy in range(ry * nby, (ry + 1) * nby):
                for gx in range(rx * nbx, (rx + 1) * nbx):
                    if block_impl is not None:
                        # fused path: the kernel already produced the
                        # per-block |new - old| sum — no grid re-read.
                        tot += res_cache[(gy, gx, it)]
                    else:
                        tot += float(torch.abs(grids[it][gy][gx]
                                               - grids[it - 1][gy][gx])
                                     .sum())
        return np.float64(tot)

    for it in range(1, iters + 1):
        # ---- halo phase --------------------------------------------------
        if version in ("pure", "forkjoin"):
            if version == "forkjoin":
                rt.taskwait()   # barrier: previous iteration fully done
            got = hx.run_group([halo_sends(r, it) for r in range(n_ranks)],
                               key=("h", it))
            for r in range(n_ranks):
                halos[(r, it)] = got[r]
        elif version == "sentinel":
            # Without TASK_MULTIPLE a blocking halo round inside per-rank
            # tasks would deadlock (§5) — the whole neighbourhood
            # collective is serialised into the sentinel chain instead.
            def halo_group(it2=it):
                got = hx.run_group(
                    [halo_sends(r, it2) for r in range(n_ranks)],
                    key=("h", it2))
                for r in range(n_ranks):
                    halos[(r, it2)] = got[r]
            rt.submit(halo_group,
                      in_=[("blk", gy, gx, it - 1)
                           for r in range(n_ranks)
                           for gy, gx in boundary_blocks(r)],
                      out=[("halo", r, it) for r in range(n_ranks)],
                      inout=[("comm-sentinel",)], label="comm",
                      name=f"halo@{it}")
        else:
            mode = "event" if version == "interop-nonblk" else "blocking"

            def halo_task(r, it2=it, mode=mode):
                def body():
                    halos[(r, it2)] = hx.start(halo_sends(r, it2), rank=r,
                                               mode=mode, key=("h", it2))
                return body
            for r in range(n_ranks):
                rt.submit(halo_task(r),
                          in_=[("blk", gy, gx, it - 1)
                               for gy, gx in boundary_blocks(r)],
                          out=[("halo", r, it)], label="comm",
                          name=f"halo[{r}]@{it}", rank=r)

        # ---- compute phase (intra-rank wavefront) ------------------------
        for gy in range(NYb):
            for gx in range(NXb):
                if version == "pure":
                    compute_block(gy, gx, it)
                else:
                    rt.submit(compute_block, gy, gx, it,
                              out=[("blk", gy, gx, it)],
                              in_=block_deps(gy, gx, it),
                              label="compute", name=f"c[{gy},{gx}]@{it}",
                              rank=rank_of(gy, gx))

        # ---- global residual: hierarchical allreduce ---------------------
        if version in ("pure", "forkjoin"):
            if version == "forkjoin":
                rt.taskwait()       # fork-join: iteration fully done
            vals = residual_coll.run_group(
                [local_residual(r, it) for r in range(n_ranks)],
                key=("res", it))
            for r in range(n_ranks):
                residuals[(r, it)] = float(vals[r])
        elif version == "sentinel":
            def res_group(it2=it):
                vals = residual_coll.run_group(
                    [local_residual(r, it2) for r in range(n_ranks)],
                    key=("res", it2))
                for r in range(n_ranks):
                    residuals[(r, it2)] = float(vals[r])
            rt.submit(res_group,
                      in_=[("blk", gy, gx, it) for gy in range(NYb)
                           for gx in range(NXb)],
                      inout=[("comm-sentinel",)], label="comm",
                      name=f"res@{it}")
        else:
            for r in range(n_ranks):
                def res_task(r=r, it2=it):
                    v = local_residual(r, it2)
                    if version == "interop-nonblk":
                        residuals[(r, it2)] = residual_coll.start(
                            v, rank=r, mode="event", key=("res", it2))
                    else:
                        residuals[(r, it2)] = float(residual_coll.start(
                            v, rank=r, mode="blocking", key=("res", it2)))
                ry, rx = cart.coords(r)
                rt.submit(res_task,
                          in_=[("blk", gy, gx, it)
                               for gy in range(ry * nby, (ry + 1) * nby)
                               for gx in range(rx * nbx, (rx + 1) * nbx)],
                          label="comm", name=f"res[{r}]@{it}", rank=r)

    rt.taskwait()
    stats = dict(rt.stats)
    # Resolve event-bound handles and check every rank saw the same value.
    res_by_it: Dict[int, float] = {}
    for (r, it), v in sorted(residuals.items()):
        if isinstance(v, tac.AsyncHandle):
            v = float(v.result)
        prev = res_by_it.setdefault(it, v)
        if abs(prev - v) >= 1e-9:
            raise RuntimeError(f"residual disagreement at iteration {it}: "
                               f"{prev} vs {v}")
    stats["residuals"] = res_by_it
    rt.close()
    if streams:
        torch.cuda.synchronize(device)
    # wall seconds of the iterations, set-up (data, streams, runtime) excluded
    stats["seconds"] = time.perf_counter() - t_start
    grid = torch.cat([torch.cat(row, dim=1) for row in grids[iters]], dim=0)
    # The task closures above and this frame form reference cycles: drop
    # the blocks and edges they reach now, not at the collector's next
    # pass (at full size, every generation of the grid stays on the card
    # until then).
    for held in (grids, halos, edge_cache):
        held.clear()
    return grid, stats


# ---------------------------------------------------------------------------
# elastic execution: checkpoint / injected rank death / shrink / resume
# ---------------------------------------------------------------------------
def _blocks_of(grid: torch.Tensor, NYb: int, NXb: int, bs: int):
    """Re-block a global grid into the benchmark's NYb x NXb tile list."""
    return [[grid[gy * bs:(gy + 1) * bs, gx * bs:(gx + 1) * bs].clone()
             for gx in range(NXb)] for gy in range(NYb)]


def _assemble(blocks) -> torch.Tensor:
    """The global grid of a block list (``np.block`` of the reference)."""
    return torch.cat([torch.cat(row, dim=1) for row in blocks], dim=0)


def _elastic_iteration(cart, hx, coll, prev, *, nby, nbx, bs, mode, rt, it):
    """One halo-coupled Gauss–Seidel iteration over ANY decomposition, on
    the unfused float64 path (bitwise the reference's blocks).

    ``prev`` is the previous iteration's global block list; returns
    ``(next block list, global residual)``.  Per-rank halo tasks post the
    neighbourhood exchange in TAMPI mode ``mode``; per-rank residual
    tasks run the allreduce over the (possibly shrunken) communicator.
    An injected rank death surfaces here as
    :class:`~repro_torch.core.executor.TaskError` out of the taskwait.
    Every task enqueues on the current stream (one stream for all
    ranks), so the stream orders each halo after the blocks it copies.
    """
    n_ranks = cart.size
    NYb, NXb = len(prev), len(prev[0])
    cur = [[None] * NXb for _ in range(NYb)]
    zeros = torch.zeros(bs, dtype=prev[0][0].dtype, device=prev[0][0].device)
    halos: Dict[int, object] = {}
    res: Dict[int, object] = {}

    def rank_of(gy, gx):
        return cart.rank_at((gy // nby, gx // nbx))

    def halo_sends(r):
        out = {}
        for d, _ in hx.neighbors(r):
            dim, disp = d
            edge = 0 if disp < 0 else -1
            out[d] = torch.cat(
                [prev[gy][gx][edge, :] if dim == 0 else prev[gy][gx][:, edge]
                 for gy, gx in edge_blocks(cart, nby, nbx, r, d)])
        return out

    def halo_edge(r, d, offset):
        h = halos[r]
        if isinstance(h, tac.AsyncHandle):
            h = h.result
        return h[d][offset * bs:(offset + 1) * bs]

    def compute_block(gy, gx):
        r = rank_of(gy, gx)
        ry, rx = gy // nby, gx // nbx
        if gy == 0:
            top = zeros
        elif gy % nby == 0:
            top = halo_edge(r, (0, -1), gx - rx * nbx)
        else:
            top = cur[gy - 1][gx][-1, :]
        if gx == 0:
            left = zeros
        elif gx % nbx == 0:
            left = halo_edge(r, (1, -1), gy - ry * nby)
        else:
            left = cur[gy][gx - 1][:, -1]
        if gy == NYb - 1:
            bottom = zeros
        elif (gy + 1) % nby == 0:
            bottom = halo_edge(r, (0, 1), gx - rx * nbx)
        else:
            bottom = prev[gy + 1][gx][0, :]
        if gx == NXb - 1:
            right = zeros
        elif (gx + 1) % nbx == 0:
            right = halo_edge(r, (1, 1), gy - ry * nby)
        else:
            right = prev[gy][gx + 1][:, 0]
        cur[gy][gx] = gs_block(prev[gy][gx], top, left, bottom, right)

    def halo_task(r):
        def body():
            halos[r] = hx.start(halo_sends(r), rank=r, mode=mode,
                                key=("eh", it))
        return body

    for r in range(n_ranks):
        rt.submit(halo_task(r), out=[("halo", r, it)], label="comm",
                  name=f"ehalo[{r}]@{it}", rank=r)
    for gy in range(NYb):
        for gx in range(NXb):
            r = rank_of(gy, gx)
            deps = [("halo", r, it)]
            if gy % nby:
                deps.append(("blk", gy - 1, gx, it))
            if gx % nbx:
                deps.append(("blk", gy, gx - 1, it))
            rt.submit(compute_block, gy, gx, in_=deps,
                      out=[("blk", gy, gx, it)], label="compute",
                      name=f"ec[{gy},{gx}]@{it}", rank=r)
    for r in range(n_ranks):
        def res_task(r=r):
            ry, rx = cart.coords(r)
            tot = np.float64(sum(
                float((cur[gy][gx] - prev[gy][gx]).abs().sum())
                for gy in range(ry * nby, (ry + 1) * nby)
                for gx in range(rx * nbx, (rx + 1) * nbx)))
            res[r] = coll.allreduce(tot, rank=r, mode=mode, key=("er", it))
        ry, rx = cart.coords(r)
        rt.submit(res_task,
                  in_=[("blk", gy, gx, it)
                       for gy in range(ry * nby, (ry + 1) * nby)
                       for gx in range(rx * nbx, (rx + 1) * nbx)],
                  label="comm", name=f"eres[{r}]@{it}", rank=r)
    rt.taskwait()
    vals = {r: float(v.result if isinstance(v, tac.AsyncHandle) else v)
            for r, v in res.items()}
    first = next(iter(vals.values()))
    if not all(abs(v - first) < 1e-9 for v in vals.values()):
        raise RuntimeError(f"residual disagreement at iteration {it}: "
                           f"{vals}")
    return cur, first


def run_elastic(ckpt_dir: str, *, n_ranks: int = 4, workers: int = 2,
                nby: int = 3, nbx: int = 3, bs: int = 8, iters: int = 4,
                kill_iter: Optional[int] = None, kill_rank: int = 0,
                kill_after_ops: int = 1, mode: str = "event",
                notify: Optional[str] = None, seed: int = 0, device=None):
    """Fault-tolerant Gauss–Seidel: the ULFM recovery loop end to end, on
    the unfused float64 path (the grid bitwise the reference's).

    Every completed iteration checkpoints the global grid to
    ``ckpt_dir`` (mesh-agnostic — the restore side may re-decompose).
    With ``kill_iter`` set, a
    :class:`~repro_torch.core.resilience.FaultInjector` arms rank
    ``kill_rank`` to die at its ``kill_after_ops``-th posted operation of
    that iteration (mid-halo / mid-collective); the failure surfaces out
    of the taskwait, the survivors revoke + shrink
    (:func:`repro_torch.core.resilience.recover`), re-shape as a fresh
    Cartesian grid over whatever decomposition divides the global blocks,
    and resume from the last completed checkpoint step.  If a run starts
    with checkpoints already in ``ckpt_dir`` it resumes from the latest
    (which is how the parity test builds its clean reference).

    Returns ``(final grid as a tensor on the run's device, info)`` where
    ``info`` records the residual per completed step, the surviving
    decomposition, and each recovery.
    """
    from .. import checkpoint as checkpoint_lib
    from ..core import resilience
    from ..core.executor import TaskError

    device = resolve_device(device)
    py, px = grid_dims(n_ranks)
    NYb, NXb = py * nby, px * nbx
    world = tac.CommWorld(n_ranks)
    injector = resilience.FaultInjector(world)
    tac.init(tac.TASK_MULTIPLE)
    template = {"grid": torch.empty((NYb * bs, NXb * bs),
                                    dtype=torch.float64)}

    step = checkpoint_lib.latest_step(ckpt_dir)
    if step is None:
        rng = np.random.default_rng(seed)
        grid = torch.from_numpy(np.block(
            [[rng.standard_normal((bs, bs)) for _ in range(NXb)]
             for _ in range(NYb)])).to(device)
        checkpoint_lib.save_checkpoint(ckpt_dir, {"grid": grid}, 0)
        step = 0
    else:
        state, step = checkpoint_lib.restore_checkpoint(
            ckpt_dir, template, device=device)
        grid = state["grid"]

    def shape_over(group_or_world, n):
        spy, spx = grid_dims(n)
        if NYb % spy or NXb % spx:
            raise ValueError(f"global {NYb}x{NXb} blocks do not divide "
                             f"over {n} survivors ({spy}x{spx})")
        cart = (group_or_world.cart((spy, spx))
                if hasattr(group_or_world, "cart")
                else group_or_world.cart_create((spy, spx)))
        return cart, NYb // spy, NXb // spx

    cart, cur_nby, cur_nbx = shape_over(world, n_ranks)
    hx, coll = HaloExchange(cart), Collectives(cart)
    rt = TaskRuntime(num_workers=workers, notify=notify)
    rt.start()
    info = {"residuals": {}, "recoveries": []}

    try:
        while step < iters:
            it = step + 1
            if kill_iter is not None and it == kill_iter \
                    and not injector.killed:
                injector.arm(kill_rank, after_ops=kill_after_ops)
            try:
                blocks, resid = _elastic_iteration(
                    cart, hx, coll, _blocks_of(grid, NYb, NXb, bs),
                    nby=cur_nby, nbx=cur_nbx, bs=bs, mode=mode, rt=rt,
                    it=it)
            except TaskError:
                # ULFM recovery: revoke (unstick peers), shrink
                # (agreement on the survivors), re-decompose, restore.
                injector.disarm()
                rt.close()
                shrunk = resilience.recover(world)
                cart, cur_nby, cur_nbx = shape_over(shrunk, shrunk.size)
                hx, coll = HaloExchange(cart), Collectives(cart)
                rt = TaskRuntime(num_workers=workers, notify=notify)
                rt.start()
                state, step = checkpoint_lib.restore_checkpoint(
                    ckpt_dir, template, device=device)
                grid = state["grid"]
                info["recoveries"].append(
                    {"at_iter": it, "killed": list(world.failed),
                     "survivors": cart.size, "resumed_step": step})
                continue
            grid = _assemble(blocks)
            step = it
            info["residuals"][step] = resid
            checkpoint_lib.save_checkpoint(ckpt_dir, {"grid": grid}, step)
    finally:
        rt.close()
    info["decomposition"] = (cart.size, cur_nby, cur_nbx)
    return grid, info


# ---------------------------------------------------------------------------
# simulated scaling (paper Figs. 9/11/12/13)
# ---------------------------------------------------------------------------
def build_sim_graph(version, *, n_ranks, nby, nbx, iters,
                    t_block=1.0, t_comm=0.05, latency=0.1):
    py, px = grid_dims(n_ranks)
    world = tac.CommWorld(n_ranks)
    cart = world.cart_create((py, px))
    NYb, NXb = py * nby, px * nbx
    tasks: List[SimTask] = []
    index: Dict[str, int] = {}

    def add(rank, compute, kind=COMPUTE, start=(), events=(), name="",
            group=None, group_latency=0.0):
        t = SimTask(len(tasks), rank, compute, kind=kind,
                    start_deps=[(index[s], 0.0) for s in start
                                if s and s in index],
                    event_deps=[(index[e], latency) for e in events
                                if e and e in index], name=name,
                    group=group, group_latency=group_latency)
        tasks.append(t)
        index[name] = t.id

    def rank_of(gy, gx):
        return cart.rank_at((gy // nby, gx // nbx))

    comm_kind = {"sentinel": COMM_HELD, "interop-blk": COMM_PAUSED,
                 "interop-nonblk": COMM_EVENTS}.get(version, COMM_HELD)
    # hierarchical residual latency from the schedule IR's α-β cost model
    # (α = per-message latency, wires/combines free — the pure-latency
    # point of the model, identical to the rounds × latency count)
    res_lat = HierarchicalCollectives(world, px).cost(latency, 0.0, 0)
    last_comm = [None] * n_ranks

    def boundary_names(r, it):
        keys = set()
        for d, _ in cart.neighbor_dirs(r):
            keys.update(edge_blocks(cart, nby, nbx, r, d))
        return [f"c[{gy},{gx}]@{it}" for gy, gx in sorted(keys)]

    for it in range(iters):
        # one neighbourhood-collective node per rank per iteration; the
        # version decides how tightly it is gated:
        #   pure      — after the rank's ENTIRE previous iteration (comm
        #               phase follows compute phase, one flow per rank)
        #   forkjoin  — after the global barrier (main-thread comm phase)
        #   sentinel  — chained on the rank's previous comm task
        #   interop-* — only after the boundary blocks it actually ships
        for r in range(n_ranks):
            if not it:
                start = []
            elif version == "pure":
                ry, rx = cart.coords(r)
                start = [f"c[{gy},{gx}]@{it - 1}"
                         for gy in range(ry * nby, (ry + 1) * nby)
                         for gx in range(rx * nbx, (rx + 1) * nbx)]
            elif version == "forkjoin":
                start = [f"barrier@{it - 1}"]
            else:
                start = boundary_names(r, it - 1)
            if version == "sentinel":
                start = start + [last_comm[r] or ""]
            add(r, t_comm, kind=comm_kind, start=start,
                name=f"h[{r}]@{it}")
            if version == "sentinel":
                last_comm[r] = f"h[{r}]@{it}"
        for r in range(n_ranks):
            tasks[index[f"h[{r}]@{it}"]].neighbors = [
                (index[f"h[{nbr}]@{it}"], latency)
                for nbr in cart.neighbors(r)]

        for gy in range(NYb):
            for gx in range(NXb):
                r = rank_of(gy, gx)
                deps = []
                crosses = False
                if it:
                    deps.append(f"c[{gy},{gx}]@{it - 1}")
                    if version == "forkjoin":
                        deps.append(f"barrier@{it - 1}")
                if gy > 0:
                    if gy % nby:
                        deps.append(f"c[{gy - 1},{gx}]@{it}")
                    else:
                        crosses = True
                if gx > 0:
                    if gx % nbx:
                        deps.append(f"c[{gy},{gx - 1}]@{it}")
                    else:
                        crosses = True
                if gy < NYb - 1:
                    if (gy + 1) % nby:
                        deps.append(f"c[{gy + 1},{gx}]@{it - 1}")
                    else:
                        crosses = True
                if gx < NXb - 1:
                    if (gx + 1) % nbx:
                        deps.append(f"c[{gy},{gx + 1}]@{it - 1}")
                    else:
                        crosses = True
                if crosses:
                    # it == 0 still crosses: the first round ships the
                    # initial boundary data (it reads nothing, so the
                    # filtered @-1 deps leave it immediately ready)
                    deps.append(f"h[{r}]@{it}")
                add(r, t_block, start=deps, name=f"c[{gy},{gx}]@{it}")

        if version == "forkjoin":
            for r in range(n_ranks):
                ry, rx = cart.coords(r)
                add(r, 0.0,
                    start=[f"c[{gy},{gx}]@{it}"
                           for gy in range(ry * nby, (ry + 1) * nby)
                           for gx in range(rx * nbx, (rx + 1) * nbx)],
                    name=f"b[{r}]@{it}")
            add(0, 0.0, start=[f"b[{r}]@{it}" for r in range(n_ranks)],
                name=f"barrier@{it}")

        # residual allreduce: one collective node per rank per iteration
        res_kind = {"interop-blk": COMM_PAUSED,
                    "interop-nonblk": COMM_EVENTS}.get(version, COMM_HELD)
        for r in range(n_ranks):
            ry, rx = cart.coords(r)
            deps = [f"c[{gy},{gx}]@{it}"
                    for gy in range(ry * nby, (ry + 1) * nby)
                    for gx in range(rx * nbx, (rx + 1) * nbx)]
            if version == "forkjoin":
                deps.append(f"barrier@{it}")
            if version == "sentinel":
                deps.append(last_comm[r] or "")
            add(r, t_comm, kind=res_kind, start=deps,
                group=f"res@{it}", group_latency=res_lat,
                name=f"res[{r}]@{it}")
            if version == "sentinel":
                last_comm[r] = f"res[{r}]@{it}"
    return tasks


def simulate_version(version, *, n_ranks, workers=48, nby=4, nbx=16,
                     iters=10, t_block=1.0):
    if version == "pure":
        workers = 1   # Pure MPI: one sequential flow per rank
    tasks = build_sim_graph(version, n_ranks=n_ranks, nby=nby, nbx=nbx,
                            iters=iters, t_block=t_block)
    sim = Simulator(n_ranks, workers, task_overhead=0.002,
                    resume_overhead=0.01)
    return sim.run(tasks).makespan


# ---------------------------------------------------------------------------
def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def bench(print_fn=print, smoke: bool = False, device=None):
    """The reference's bench on the port: the five versions and both
    notify backends on the unfused float64 path within 1e-10 of ``pure``
    (bitwise, in fact), the fused leg through ``gs_stencil`` within 1e-4,
    then (``smoke``) one simulated point, or the real wall times and the
    strong, weak and granularity scaling rows."""
    rows = []
    ref, ref_stats = run_real("pure", block_impl=None, device=device)
    for v in VERSIONS[1:]:
        out, st = run_real(v, block_impl=None, device=device)
        err = _max_diff(out, ref)
        assert err < 1e-10, (v, err)
        for it, val in ref_stats["residuals"].items():
            assert abs(st["residuals"][it] - val) < 1e-9, (v, it)

    # end-to-end notification-backend legs: the same interop run under
    # the polling engine and the continuation engine must agree with the
    # pure reference bit for bit (and with each other).
    for v in ("interop-blk", "interop-nonblk"):
        for nb in ("polling", "continuation"):
            t0 = time.monotonic()
            out, _ = run_real(v, notify=nb, block_impl=None, device=device)
            dt = (time.monotonic() - t0) / 3
            assert _max_diff(out, ref) < 1e-10, (v, nb)
            rows.append((f"gs_e2e_{v}_{nb}", dt * 1e6, "notify-leg"))

    # fused-stencil leg: interior update, residual and boundary-pack in ONE
    # gs_stencil launch per block (the hand-written kernel on the card) —
    # halo payloads and residual sums come from the kernel outputs, not
    # grid re-reads.  The kernel computes in fp32, so the bound is fp32
    # epsilon (~1e-5 after 3 iterations), not the float64 paths' 1e-10.
    t0 = time.monotonic()
    out_f, st_f = run_real("interop-nonblk", block_impl="cuda",
                           device=device)
    dt = (time.monotonic() - t0) / 3
    err_f = _max_diff(out_f, ref)
    assert err_f < 1e-4, err_f
    for it, val in ref_stats["residuals"].items():
        assert abs(st_f["residuals"][it] - val) <= 1e-4 * max(1.0, val), it
    rows.append(("gs_fused_stencil_interop", dt * 1e6,
                 f"maxerr={err_f:.1e}"))

    if smoke:
        # all five versions numerically agree (above) and the schedule
        # acceptance ordering holds on one simulated point — event-bound
        # strictly beats the sentinel serialisation.
        mks = {v: simulate_version(v, n_ranks=4, nby=4, nbx=4, iters=4)
               for v in VERSIONS}
        assert mks["interop-nonblk"] < mks["sentinel"], mks
        for v in VERSIONS:
            rows.append((f"gs_smoke_{v}", mks[v] * 1e6, "smoke"))
        for r in rows:
            print_fn(f"{r[0]},{r[1]:.1f},{r[2]}")
        return rows

    for v in VERSIONS:
        t0 = time.monotonic()
        _, stats = run_real(v, block_impl=None, device=device)
        dt = (time.monotonic() - t0) / 3
        rows.append((f"gs_real_{v}", dt * 1e6,
                     f"blocks={stats.get('task_blocks', 0)}"
                     f";threads={stats.get('threads_spawned', 0)}"))

    # strong scaling (Fig. 9): fixed 8x8 global blocks, split over ranks
    base_s = simulate_version("pure", n_ranks=1, nby=8, nbx=8)
    for v in VERSIONS:
        for n in (1, 2, 4, 8, 16):
            py, px = grid_dims(n)
            mk = simulate_version(v, n_ranks=n, nby=8 // py, nbx=8 // px)
            rows.append((f"gs_strong_{v}_r{n}", mk * 1e6,
                         f"speedup={base_s / mk:.2f}"))

    # weak scaling (Fig. 11): 4x4 blocks per rank
    base_w = simulate_version("pure", n_ranks=1, nby=4, nbx=4)
    for v in VERSIONS:
        for n in (1, 2, 4, 8, 16):
            mk = simulate_version(v, n_ranks=n, nby=4, nbx=4)
            rows.append((f"gs_weak_{v}_r{n}", mk * 1e6,
                         f"efficiency={base_w / mk:.2f}"))

    base6 = simulate_version("pure", n_ranks=1, nby=4, nbx=4, iters=6)
    for v in ("interop-blk", "interop-nonblk"):
        for scale, label in ((1, "1024bs"), (2, "512bs"), (4, "256bs")):
            mk = simulate_version(v, n_ranks=8, nby=4 * scale,
                                  nbx=4 * scale, iters=6,
                                  t_block=1.0 / (scale * scale))
            rows.append((f"gs_gran_{v}_{label}", mk * 1e6,
                         f"speedup={base6 / mk:.2f}"))
    for r in rows:
        print_fn(f"{r[0]},{r[1]:.1f},{r[2]}")
    return rows


# ---------------------------------------------------------------------------
# traced legs: Perfetto timeline + overlap accounting (repro_torch.obs)
# ---------------------------------------------------------------------------
TRACED_LEGS = ("sentinel", "interop-blk", "interop-nonblk")


def trace_legs(trace_path: str, *, smoke: bool = False, device=None):
    """The sentinel, interop-blk and interop-nonblk versions (through
    ``gs_stencil``) under ONE :class:`repro_torch.obs.Tracer`, so the
    exported timeline shows the three legs back to back.  Writes the
    trace-event JSON to ``trace_path``, with each leg's window and overlap
    fraction (share of handle in-flight time covered by concurrent
    compute spans) in ``otherData``, and raises if it violates
    ``repro_torch.obs.SPAN_SCHEMA``.

    Returns ``(events, overlap per leg, interop-blk pause spans)``."""
    from .. import obs

    params = dict(n_ranks=4, workers=2, nby=2, nbx=2,
                  bs=24 if smoke else 48, iters=3, device=device)
    windows: Dict[str, Tuple[float, float]] = {}
    with obs.tracing(capacity=1 << 18) as tr:
        for v in TRACED_LEGS:
            t0 = (time.monotonic() - tr.epoch) * 1e6
            run_real(v, **params)
            windows[v] = (t0, (time.monotonic() - tr.epoch) * 1e6)
        events = tr.events()

    def leg_events(v):
        lo, hi = windows[v]
        return [e for e in events if lo <= e["ts"] < hi]

    overlaps = {v: obs.overlap_fraction(leg_events(v)) for v in TRACED_LEGS}
    nonblk = leg_events("interop-nonblk")
    doc = obs.export_trace(trace_path, events=events, extra={
        "benchmark": "gauss_seidel",
        "legs": {v: {"window_us": list(windows[v]),
                     "overlap_fraction": overlaps[v]} for v in TRACED_LEGS},
        "per_rank_overlap": {str(r): f for r, f in
                             obs.per_rank_overlap(nonblk).items()},
        "straggler_scores": {str(r): s for r, s in
                             obs.straggler_scores(nonblk).items()},
    })
    obs.assert_valid_trace(doc)
    pauses = sum(1 for e in leg_events("interop-blk")
                 if e["ph"] == "X" and e["cat"] == "task"
                 and e["name"] == "pause")
    return events, overlaps, pauses


def run_traced(trace_path: str, *, smoke: bool = False, print_fn=print,
               device=None) -> Dict[str, float]:
    """``--trace`` leg: :func:`trace_legs`, then the hard acceptance
    checks (SystemExit on violation):

    * the interop-blk leg recorded task pause spans (§4.1 pause/resume
      made visible);
    * the event-bound leg's overlap fraction is STRICTLY greater than
      the sentinel leg's (taskified-serialised comm cannot overlap).
    """
    events, overlaps, pauses = trace_legs(trace_path, smoke=smoke,
                                          device=device)
    if pauses == 0:
        raise SystemExit("traced leg: interop-blk recorded no task pause "
                         "spans — §4.1 pause/resume not visible")
    if not overlaps["interop-nonblk"] > overlaps["sentinel"]:
        raise SystemExit(
            f"overlap ordering violated: event-bound "
            f"{overlaps['interop-nonblk']:.3f} <= sentinel "
            f"{overlaps['sentinel']:.3f}")
    for v in TRACED_LEGS:
        print_fn(f"gs_trace_{v},{overlaps[v] * 1e6:.1f},"
                 f"overlap-fraction-ppm")
    print_fn(f"gs_trace_events,{len(events)},file={trace_path}"
             f";pauses={pauses}")
    return overlaps


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(
        description="Gauss-Seidel benchmark (paper §7.1)")
    ap.add_argument("--smoke", action="store_true",
                    help="small leg: parity checks + one simulated point")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="run the traced legs and write Perfetto JSON here "
                         "(skips the plain bench)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ns = ap.parse_args()
    if ns.trace:
        run_traced(ns.trace, smoke=ns.smoke, device=ns.device)
    else:
        bench(smoke=ns.smoke, device=ns.device)
