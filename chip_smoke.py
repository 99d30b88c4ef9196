#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with a CUDA device::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Build every kernel of the main path from ``src/repro_torch/kernels/csrc``
   (``nvcc`` for sm_90a, one process per source, all started together).
2. Hold each kernel against its plain-PyTorch version on the card:
   ``gs_stencil`` at (1024, 1024), (17, 5) and (1000, 1023) in float32 and
   bfloat16 with four distinct halos — block and edges bitwise, residual
   within rtol 1e-5 (both sides reduce over <= 1M fp32 terms, in different
   orders), two calls bitwise-equal residuals.
3. An ``ArrayHandle`` / ``tac.iwait`` probe: a task launches the kernel
   behind a busy stream and binds the handle; a dependent task reads the
   output; the release was deferred (the handle was still in flight).
4. The main path: ``bench.gauss_seidel.run_real`` on a 16384 x 16384 fp32
   grid in 1024 x 1024 blocks on 4 logical ranks, 5 iterations, all five
   versions with ``block_impl="cuda"`` — grids and residuals bitwise equal
   across versions, the kernel launched exactly 5 x 256 x 5 times; one
   ``block_impl="ref"`` run on the card agrees (grid bitwise, residuals
   rtol 1e-5); a small run on the card equals the CPU plain path.
5. Timing of each kernel at the main path's shape (CUDA events, a ring of
   blocks larger than the L2 cache so every launch reads cold data): device
   time per call from CUDA-graph replay (``ms``, ``plain_ms``) and the
   eager wrapper's time as the main path pays it (``wrapper_ms``).

Prints the per-version wall time, the ``kernels`` JSON line, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``.  It
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# Main-path size: a 2^28-point heat-equation domain (1 GiB per fp32
# generation) on 4 logical ranks in a 2 x 2 grid of 8 x 8 blocks each.
GRID, BLOCK, N_RANKS, ITERS, WORKERS = 16384, 1024, 4, 5, 4
# H100 SXM published peaks (NVIDIA's data sheet, at the 700 W limit): HBM
# bytes/s and fp32 (non-tensor-core) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
RES_RTOL = 1e-5


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, n: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean ms per call of ``fn(i)`` over
    ``n`` calls, by CUDA events around each round (after a warm-up)."""
    import torch
    for i in range(min(n, 8)):
        fn(i)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(i)
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / n)
    return float(np.median(per_call))


def stencil_inputs(H, W, dtype, seed, device):
    import torch
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s) for s in ((H, W), W, H, W, H)]
    return [torch.from_numpy(a).to(device, dtype) for a in arrs]


def check_gs_stencil(stages, ref, device) -> float:
    """Phase 2; returns the largest |kernel - plain| at the main shape."""
    import torch
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for H, W in ((BLOCK, BLOCK), (17, 5), (1000, 1023)):
            block, top, left, bottom, right = stencil_inputs(
                H, W, dtype, H * W, device)
            new, res, edges = stages.gs_stencil(block, top, left, bottom,
                                                right)
            _, res2, _ = stages.gs_stencil(block, top, left, bottom, right)
            new_p, res_p, edges_p = ref.gs_stencil(block, top, left, bottom,
                                                   right)
            torch.cuda.synchronize()
            tag = f"gs_stencil {str(dtype)[6:]} {H}x{W}"
            if not torch.equal(new, new_p):
                raise AssertionError(f"{tag}: block differs from plain")
            for k, (e, ep) in enumerate(zip(edges, edges_p)):
                if not torch.equal(e, ep):
                    raise AssertionError(f"{tag}: edge {k} differs")
            for k, e in enumerate((new[0], new[-1], new[:, 0], new[:, -1])):
                if not torch.equal(edges[k], e):
                    raise AssertionError(f"{tag}: edge {k} is not the "
                                         f"(top, bottom, left, right) row")
            if not torch.equal(res, res2):
                raise AssertionError(f"{tag}: residual not reproducible "
                                     f"({res.item()} vs {res2.item()})")
            r, rp = res.item(), res_p.item()
            if abs(r - rp) > RES_RTOL * abs(rp):
                raise AssertionError(f"{tag}: residual {r} vs plain {rp}")
            if dtype == torch.float32 and (H, W) == (BLOCK, BLOCK):
                worst = max(worst, abs(r - rp))
            log(f"{tag}: block+edges bitwise, residual {r:.9g} vs plain "
                f"{rp:.9g} (rtol {RES_RTOL}), reproducible")
    return worst


def iwait_probe(stages, ref, device) -> None:
    """Phase 3: non-blocking TAC over a CUDA-event ArrayHandle."""
    import torch
    from repro_torch.core import TaskRuntime, tac
    block, top, left, bottom, right = stencil_inputs(BLOCK, BLOCK,
                                                     torch.float32, 7,
                                                     device)
    side = torch.cuda.Stream(device)
    out, state = {}, {}

    def producer():
        with torch.cuda.stream(side):
            torch.cuda._sleep(200_000_000)     # keep the stream busy
            out["v"] = stages.gs_stencil(block, top, left, bottom, right)
            handle = tac.ArrayHandle(out["v"])
        state["in_flight_at_bind"] = not handle.test()
        tac.iwait(handle)

    def consumer():
        state["consumer_saw_done"] = out["v"][0].is_cuda and \
            torch.equal(out["v"][0], ref.gs_stencil(block, top, left,
                                                    bottom, right)[0])

    tac.init(tac.TASK_MULTIPLE)
    with TaskRuntime(num_workers=2) as rt:
        rt.submit(producer, out=["new"])
        rt.submit(consumer, in_=["new"])
        rt.taskwait()
        eng = rt.continuations.stats
    torch.cuda.synchronize()
    if not state.get("in_flight_at_bind"):
        raise AssertionError("iwait probe: the handle completed before it "
                             "was bound; nothing was deferred")
    if not state.get("consumer_saw_done"):
        raise AssertionError("iwait probe: consumer read a wrong output")
    if eng["attached"] < 1 or rt.stats.get("task_blocks", 0) != 0:
        raise AssertionError(f"iwait probe: release not deferred through "
                             f"the engine ({eng}, {dict(rt.stats)})")
    log(f"iwait probe: release deferred (engine {eng}, task_blocks 0)")


def main_path(gs, stages, device):
    """Phase 4: returns per-version seconds/iteration and launches."""
    import torch
    kw = dict(n_ranks=N_RANKS, workers=WORKERS, nby=GRID // BLOCK // 2,
              nbx=GRID // BLOCK // 2, bs=BLOCK, iters=ITERS, seed=0,
              device=device)
    n_blocks = (GRID // BLOCK) ** 2
    grids, per_it = {}, {}
    # warm-up at full size: the first run grows the allocator's cache by
    # every generation (cudaMalloc); the timed runs then start equal
    gs.run_real("pure", block_impl="cuda", **kw)
    stages.gs_stencil.launches = 0
    for version in gs.VERSIONS:
        grid, stats = gs.run_real(version, block_impl="cuda", **kw)
        grids[version] = (grid, stats["residuals"])
        per_it[version] = stats["seconds"] / ITERS
        log(f"main path {version}: {per_it[version]:.6f} s/iteration, "
            f"residuals {stats['residuals']}")
    launches = stages.gs_stencil.launches
    want = len(gs.VERSIONS) * n_blocks * ITERS
    if launches != want:
        raise AssertionError(f"gs_stencil launched {launches} times on the "
                             f"main path, expected {want}")
    base, base_res = grids["pure"]
    if base.shape != (GRID, GRID) or not torch.isfinite(base).all():
        raise AssertionError(f"main path: grid {tuple(base.shape)} not "
                             f"finite {GRID}x{GRID}")
    for version, (grid, res) in grids.items():
        if not torch.equal(grid, base) or res != base_res:
            raise AssertionError(f"main path: {version} differs from pure")
    vals = [base_res[it] for it in range(1, ITERS + 1)]
    if not all(b < a for a, b in zip(vals, vals[1:])):
        raise AssertionError(f"main path: residuals not decreasing {vals}")
    grids.clear()
    grid_r, stats_r = gs.run_real("interop-nonblk", block_impl="ref", **kw)
    if not torch.equal(grid_r, base):
        raise AssertionError("main path: block_impl='ref' grid differs")
    for it, v in base_res.items():
        if abs(stats_r["residuals"][it] - v) > RES_RTOL * abs(v):
            raise AssertionError(f"main path: ref residual {it} differs")
    log(f"main path: five versions bitwise equal, {launches} launches; "
        f"block_impl='ref' grid bitwise, residuals rtol {RES_RTOL}")
    small = dict(n_ranks=4, nby=2, nbx=2, bs=64, iters=3, seed=1)
    g_dev, s_dev = gs.run_real("interop-nonblk", block_impl="cuda",
                               device=device, **small)
    g_cpu, s_cpu = gs.run_real("interop-nonblk", block_impl="cuda",
                               device="cpu", **small)
    if not torch.equal(g_dev.cpu(), g_cpu):
        raise AssertionError("small run: card grid differs from CPU plain")
    for it, v in s_cpu["residuals"].items():
        if abs(s_dev["residuals"][it] - v) > RES_RTOL * abs(v):
            raise AssertionError(f"small run: residual {it} differs")
    log("small run (256x256, 3 iterations): card grid bitwise equal to the "
        "CPU plain path")
    return per_it, launches


def graph_ms(fn, n_calls: int) -> float:
    """Device ms per call of ``fn(i)``: ``n_calls`` calls captured in one
    CUDA graph and replayed, so no host launch overhead is counted."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)                   # warm the allocator before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            fn(i)
    return time_ms(lambda _: graph.replay(), 20) / n_calls


def time_gs_stencil(stages, ref, device):
    """Phase 5: times per call at the main path's block shape, on cold data
    (a ring of 16 blocks, 64 MiB of inputs, larger than the 50 MB L2):
    device time from CUDA-graph replay for the kernel and for the plain
    version, and the eager wrapper's time as the main path calls it."""
    import torch
    ring = [stencil_inputs(BLOCK, BLOCK, torch.float32, 100 + i, device)
            for i in range(16)]
    t = {"ms": graph_ms(lambda i: stages.gs_stencil(*ring[i % 16]), 16),
         "plain_ms": graph_ms(lambda i: ref.gs_stencil(*ring[i % 16]), 16),
         "wrapper_ms": time_ms(lambda i: stages.gs_stencil(*ring[i % 16]),
                               200),
         "plain_eager_ms": time_ms(lambda i: ref.gs_stencil(*ring[i % 16]),
                                   50)}
    H = W = BLOCK
    nbytes = 2 * H * W * 4 + 2 * (2 * W + 2 * H) * 4 + 4
    flops = 6 * H * W      # 3 adds, 1 scale, 1 subtract, 1 accumulate
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    t["bound_ms"] = max(t_bytes, t_ops)
    t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return t


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.bench import gauss_seidel as gs
    from repro_torch.kernels import build, collective_stages as stages, ref
    device = torch.device("cuda")

    t0 = time.perf_counter()
    outputs = build.build()
    log(f"build: {time.perf_counter() - t0:.3f} s")
    for name, out in outputs.items():
        log(f"nvcc {name}:\n{out.strip()}")

    max_err = check_gs_stencil(stages, ref, device)
    iwait_probe(stages, ref, device)
    per_it, launches = main_path(gs, stages, device)
    t = time_gs_stencil(stages, ref, device)
    log(f"gs_stencil 1024x1024 fp32: device {t['ms']:.6f} ms/call (plain "
        f"{t['plain_ms']:.6f}), eager wrapper {t['wrapper_ms']:.6f} ms/call "
        f"(plain {t['plain_eager_ms']:.6f}), bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']})")
    for version, s in per_it.items():
        log(f"wall {version}: {s:.6f} s/iteration")

    kernels = [{
        "name": "gs_stencil", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gs_stencil.cu",
        "replaces": "src/repro/kernels/collective_stages.py:200",
        "launches": launches, "max_abs_err": max_err, **t,
        "library_ms": None,
    }]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
