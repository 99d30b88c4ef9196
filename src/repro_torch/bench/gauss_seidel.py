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

The simulated scaling curves of the reference (``simulate_version``) and
its elastic leg (``run_elastic``) are not ported yet.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import HaloExchange, HierarchicalCollectives, TaskRuntime, tac
from ..core.mesh import resolve_device
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
