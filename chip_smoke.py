#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with a CUDA device::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Build every kernel of the main path from ``src/repro_torch/kernels/csrc``
   (``nvcc`` for sm_90a, one process per source, all started together).
2. Hold each kernel against its plain-PyTorch version on the card:
   ``gs_stencil`` at (1024, 1024), (17, 5), (1000, 1023), (1, 8), (8, 1),
   (1, 1), (70, 264), (64, 1020) and (1024, 1024) at an element offset of
   1, in float32 and bfloat16, with four distinct halos — each case on the
   route ``collective_stages.route`` names (logged; both routes must run)
   and launched once a call; block and edges bitwise, the residual
   bitwise equal to ``residual_in_kernel_order`` (the kernel's summation
   order) and within rtol 1e-5 of plain (both reduce over <= 1M fp32
   terms, in different orders), two calls bitwise-equal residuals.  Four
   streams, each held back by a sleep, then launching 50 calls that run
   at once, give results bitwise equal to the same calls made alone; the
   profiler sees 10 ``gs_stencil`` kernels over 10 calls and no other.
2b. Views through ``kernels.ops``: transposed (non-contiguous) and
   element-offset (misaligned) views of every input of ``flash_attention``,
   ``mamba2_ssd``, ``mlstm_chunked``, ``moe_gmm`` (bf16) and
   ``gs_stencil`` (fp32) reach the kernels (each launch counted) and
   match the plain versions on the contiguous inputs: bf16 within 2e-2
   and the SSD / mLSTM states within 1e-3 of their largest value; the
   stencil's block and edges bitwise, its residual within rtol 1e-5.
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
   time per call from CUDA-graph replay (``ms``, ``plain_ms``), the eager
   wrapper's time as the main path pays it (``wrapper_ms``), ``bound_ms /
   ms``, and ``copy_ms``: ``dst.copy_(block)`` of the same cold blocks by
   the same replay, the practical floor for moving these bytes at this
   size (a yardstick, not a library version of the function).
6. Level-A collectives on CUDA tensors: allreduce, reduce_scatter and a
   persistent plan over 4 ranks return CUDA tensors, bitwise equal to the
   same run on CPU tensors and within rtol 1e-6 of a float64 sum.
7. The Level-B stage kernels against their plain versions on the card,
   bitwise: ``fused_combine`` in every variant (acc fp32/bf16 x got
   fp32/bf16/int8+scale x accumulate, and in place) at lengths 1, 257,
   1031, 2^20+3 and the main path's fused-mode ring chunk, and at the
   lengths below the chunk also on views at element offsets 1 and 3 (acc
   and got misaligned together and against each other);
   ``quantize_wire`` (fp32 and bf16 input, values on exact .5 boundaries
   rounding half to even) and ``dequantize_wire`` to fp32 and bf16.
8. The Level-B main path: ``bench.overlap.run_sync`` on hubert-xlarge's
   gradient tree (944,611,840 parameters, 13 leaves) on 4 logical ranks —
   fused, bucketed and sentinel rings with ``stage_impl="cuda"``, fused
   with bf16 and int8 wires, doubling and hierarchical 2 x 2, each beside
   a plain (``None``, fp32 wire) or ``"ref"`` (bf16, int8 wires) twin on
   the same inputs.  All ranks bitwise equal; every ``"cuda"`` run
   bitwise equal to its twin; bucketed equal to sentinel; every leaf
   within its stated
   tolerance of a float64 mean; ``ppermute`` calls, sentinel waits and
   kernel launches equal to the counts derived from the schedule and the
   7 buckets.
9. Timing of the three stage kernels at the main path's chunk shapes, as
   in phase 5, beside one PyTorch call computing the same function
   (``library_ms``): ``torch.add``, ``torch.add(alpha=scale)``,
   ``torch.quantize_per_tensor`` (eager) and ``torch.mul``;
   ``fused_combine``'s share of its bound is logged.
10. ``flash_attention`` against its plain version on the card: the five
    shapes of the JAX package's kernel test, S = T = 1000 and S = 1 with
    T = 2080, the prefill shape of the smoke-scale granite-3-2b that the
    serving CLI runs by default (1, 32, 4/2, 16), and the edges of the
    bf16 kernel's TMA tiles (B = 2 with T ragged at the first batch's end,
    MQA with 32 heads packed in one block, S != T with a window, 126 of
    128 rows used with a ragged T at head dim 16, ragged S and T at head
    dim 32), in fp32 and bf16, then granite-3-2b's prefill shape (1, 2048,
    32/8, 64), zamba2-2.7b's shared-attention shape (1, 2048, 32/32, 80)
    and olmoe-1b-7b's prefill shape (1, 2048, 16/16, 128), each in bf16
    (the main path's, on the tensor cores) and in fp32 (the FMA kernel,
    held to fp32's tolerance) — within 2e-5 (fp32) and 2e-2 (bf16), at
    the three served shapes in bf16 also RMS(kernel - plain) / RMS(plain)
    within ``FLASH_SERVED_REL_RMS``, and two calls bitwise equal.
11. The serving main path: granite-3-2b at full width and depth
    (2,533,531,648 parameters, bf16, random weights from seed 0) served
    by ``ServingEngine`` + ``LMAdapter`` — 4 requests of 2048 prompt
    tokens and 32 generated tokens, 4 slots, 4 workers — on the ``event``
    and the ``blocking`` leg, each after an untimed warm-up request.  Both
    legs emit identical streams of 32 tokens per request; the kernel is
    launched exactly 40 x 4 times per leg (prefill only); one request with
    ``attn_impl="ref"`` agrees in its prefill logits within
    ``SERVE_LOGIT_RTOL`` and in its first token where the plain path's
    top-1/top-2 margin exceeds that tolerance.  One request alone gives
    prefill ms and decode ms per token.
12. Timing of ``flash_attention`` at granite's prefill shape (the
    ``kernels`` line's) and at zamba2's shared-attention shape, as in
    phase 5, beside ``scaled_dot_product_attention`` (``library_ms``),
    with the achieved TFLOP/s and ``bound_ms / ms``.
13. ``mamba2_ssd`` against its plain version on the card: the JAX
    package's kernel-test shapes, p = n = 8, smoke zamba2-2.7b's prefill,
    p = n = 128 at chunk 256 and a chunk of 12, in fp32 and bf16, the
    bf16 ``wgmma`` route's edges (n = 16, 48, 80, 96, 112, p = 128 with
    narrow n, chunks of 64-256, b = 2) and an unaligned bf16 view of x, from
    a zero and a random initial state — y within 2e-5 (fp32) and 2e-2
    (bf16), the state within 1e-3, two calls bitwise equal, each case
    launched on the route ``mamba2_ssd.route`` names (logged; zamba2's and
    p = n = 128's bf16 cases on ``wgmma``; both routes must run); s = 24
    and 12 through ``ops.mamba2_ssd`` (padding, a short chunk); two halves
    chained through the final state equal the whole, in fp32 and in bf16 on
    the ``wgmma`` route; zamba2-2.7b's prefill shape x (1, 2048, 80, 64),
    B/C (1, 2048, 64), chunk 256, in fp32 and bf16, each error stated as
    max|diff| / max|plain|.
14. The zamba2 serving path: zamba2-2.7b at full width and depth
    (2,435,777,440 parameters: 54 Mamba2 blocks and one shared attention
    block called after every sixth), as phase 11 — identical streams on
    both legs, ``mamba2_ssd`` launched exactly 54 x 4 and
    ``flash_attention`` 9 x 4 times per leg (prefill only), one request on
    the plain versions (``ssd_impl="ref"``, ``attn_impl="ref"``) within
    ``SERVE_LOGIT_RTOL``.
15. Timing of ``mamba2_ssd`` at zamba2's prefill shape on the ``wgmma``
    route, as in phase 5 (no PyTorch call computes the scan:
    ``library_ms`` is null), with the achieved TFLOP/s and ``bound_ms /
    ms``, and of the ``fma`` route at the same shape (x at an element
    offset of 1).
16. ``mlstm_chunk`` against its plain version on the card: the JAX
    package's kernel-test shapes, smoke xlstm-350m's prefill at the
    serving CLI's default prompt of 32, d = 512 at chunk 256 and a chunk of
    12, in fp32 and bf16, and the bf16 ``wgmma`` route's edges (d = 64,
    128, 192, 448 and 512, chunks of 64-256, s of one chunk and of
    several, b = 2, one and four heads) — y within 2e-5 (fp32) and 2e-2
    (bf16), C and n within 2e-4 (fp32) and 2e-2 (bf16) absolute with 2e-2
    relative, m within 1e-3, two calls bitwise equal, each case launched
    on the route ``mlstm_chunk.route`` names (logged; both routes must
    run); an unaligned bf16 view of q, which ``route`` sends to ``fma``
    and the wrapper refuses before any launch; s = 24 through
    ``ops.mlstm_chunked`` (padding); xlstm-350m's prefill shape (1, 2048,
    4, 512), chunk 256, in fp32 and bf16 (bf16 on ``wgmma``), each error
    stated as max|diff| / max|plain|.
17. The xlstm serving path: xlstm-350m at full width and depth
    (491,908,240 parameters: 18 mLSTM and 6 sLSTM blocks), as phase 11 —
    identical streams on both legs, ``mlstm_chunk`` launched exactly
    18 x 4 times per leg (prefill only), every launch on ``wgmma``.  The bf16 model turns a one-ulp
    difference anywhere into O(1) differences in the logits, so the plain
    version (``mlstm_impl="ref"``) is held block by block in bf16 (each
    mLSTM block alone on the plain path's input to it, within 2e-2), and
    as a whole on an fp32 copy of the same weights, with phase 11's gates
    (prefill logits within ``SERVE_LOGIT_RTOL``, first token); the bf16
    whole-model difference is reported beside a one-ulp baseline.
18. Timing of ``mlstm_chunk`` at xlstm's prefill shape on the ``wgmma``
    route, as in phase 5 (no PyTorch call computes the chunked mLSTM:
    ``library_ms`` is null), with the achieved TFLOP/s and ``bound_ms /
    ms``, and of the ``fma`` route at the same shape (through the C entry
    point's route code).
19. ``moe_gmm`` against its plain version on the card: the JAX package's
    kernel-test shapes (E, C, K, N), ragged C, K and N down to C = 2,
    olmoe-1b-7b's decode shapes (64, 8, 2048, 1024) and (64, 8, 1024, 2048)
    and its prefill shapes (64, 320, 2048, 1024) and (64, 320, 1024, 2048),
    in fp32 and bf16, and in bf16 the edges of the wgmma route's tiles (C
    from 1 to 321 across the 8- and 160-row tiles of x, K and N
    multiples of 8 but not of the tile, E = 1) and x and w as views at
    element offsets 8 (16-byte aligned) and 1 (not) — within 2e-5 (fp32)
    and 2e-2 (bf16), atol = rtol, at the small shapes, and as max|diff| /
    max|plain| at olmoe's (K of 1024-2048 makes an elementwise rtol
    meaningless near 0); two calls bitwise equal.  Each case logs its
    route; the served bf16 shapes must take ``wgmma`` / ``wgmma_decode``
    and all four routes must run.
20. The olmoe serving path: olmoe-1b-7b at full width and depth
    (6,919,096,320 parameters: 16 layers of attention and a MoE block of 64
    experts, top-8), as phase 11 — identical streams on both legs,
    ``flash_attention`` launched exactly 16 x 4 times per leg (prefill)
    and ``moe_gmm`` 48 x 32 x 4 (three expert products per MoE block, in
    prefill and in each of the 31 decode steps).  Routing is
    discontinuous (a one-ulp change of a router input can swap an expert),
    so every MoE block is held alone on the plain path's input to it
    (identical expert choices, y within 2e-2 of its largest value); the
    whole model gets phase 11's gates in bf16 where they hold, else on an
    fp32 copy of the weights; the number of (layer, token) top-8 sets that
    differ between the kernel and plain paths is printed.
21. Timing of ``moe_gmm`` at olmoe's two prefill and two decode shapes,
    as in phase 5, beside ``torch.bmm`` in bf16 (``library_ms``) and the
    bound,
    and of ``flash_attention`` at olmoe's prefill shape beside
    ``scaled_dot_product_attention``, as in phase 12.

After each served model, the memory it held must be free again without
the cyclic garbage collector (within 1 GiB of what was allocated before).
Prints the per-version wall time, the wall time of each ``sync_grads``
run, tokens/s and p50/p99 token latency per serving leg of each model,
the ``kernels`` JSON line (eight kernels), the card's name and power
limit, and last ``{"ok": true,
"device": {...}}``.  It imports nothing of the JAX package.
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
# Level-B main path: hubert-xlarge's gradient (944,611,840 parameters) on
# 4 logical ranks; the fused-mode ring chunk is a quarter of it, and the
# bucketed mode's chunks are an attention and an MLP weight bucket.
HUBERT_PARAMS = 944_611_840
FUSED_CHUNK = HUBERT_PARAMS // N_RANKS
BUCKET_CHUNKS = ((1280 * 2 + 48 * 1280 * 1280) // N_RANKS,
                 (48 * 1280 * 2 + 48 * 5120 * 1280) // N_RANKS)
STAGE_LENGTHS = (1, 257, 1031, (1 << 20) + 3, FUSED_CHUNK)
# fused_combine on views (acc offset, got offset, in elements) into flat
# buffers, as ring chunks are: 1 and 3 misalign every dtype's 16-byte
# vectors, together (both at 1 or 3) and against each other (1 with 3).
STAGE_VIEW_OFFSETS = ((1, 1), (3, 3), (1, 3), (0, 3))
# Tolerances of a sync_grads result against the float64 mean, as
# max|result - mean| / max|mean| per leaf: an fp32 wire rounds fp32 leaves
# at the last bit and bf16 leaves at bf16's (2^-8); the narrow wires as
# the JAX package's lowering test states them.
SYNC_RTOL = {None: {"float32": 1e-6, "bfloat16": 2 ** -8},
             "bf16": {"float32": 2e-2, "bfloat16": 2e-2},
             "int8": {"float32": 5e-2, "bfloat16": 5e-2}}
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


def stencil_inputs(H, W, dtype, seed, device, offset: int = 0):
    """Block and four distinct halos; the block a contiguous view
    ``offset`` elements into a flat buffer."""
    import torch
    rng = np.random.default_rng(seed)
    arrs = [torch.from_numpy(rng.standard_normal(s)).to(device, dtype)
            for s in ((H, W), W, H, W, H)]
    if offset:
        buf = torch.zeros(H * W + offset, dtype=dtype, device=device)
        arrs[0] = buf[offset:].view(H, W).copy_(arrs[0])
    return arrs


# Phase 2's shapes (H, W, element offset of the block): the main path's,
# ragged W, H = 1 and W = 1 (both halos of a pair), several CTAs each way,
# a W that is a multiple of 4 but not of 8, and a misaligned block.
GS_CASES = ((BLOCK, BLOCK, 0), (17, 5, 0), (1000, 1023, 0), (1, 8, 0),
            (8, 1, 0), (1, 1, 0), (70, 264, 0), (64, 1020, 0),
            (BLOCK, BLOCK, 1))


def check_gs_stencil(stages, ref, device) -> float:
    """Phase 2; returns the largest |kernel - plain| residual at the main
    shape."""
    import torch
    worst = 0.0
    ran = set()
    for dtype in (torch.float32, torch.bfloat16):
        for H, W, offset in GS_CASES:
            args = stencil_inputs(H, W, dtype, H * W, device, offset)
            which = stages.route(args[0])
            tag = f"gs_stencil {str(dtype)[6:]} {H}x{W}+{offset} {which}"
            if which != ("vec" if offset == 0 and
                         W % stages.GS_VEC[dtype] == 0 else "scalar"):
                raise AssertionError(f"{tag}: unexpected route")
            before = stages.gs_stencil.route_launches[which]
            new, res, edges = stages.gs_stencil(*args)
            _, res2, _ = stages.gs_stencil(*args)
            new_p, res_p, edges_p = ref.gs_stencil(*args)
            order = stages.residual_in_kernel_order(*args, which=which)
            torch.cuda.synchronize()
            if stages.gs_stencil.route_launches[which] != before + 2:
                raise AssertionError(f"{tag}: not one launch a call on "
                                     f"its route")
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
            if not torch.equal(res, order):
                raise AssertionError(f"{tag}: residual {res.item()!r} is "
                                     f"not the kernel-order sum "
                                     f"{order.item()!r}")
            r, rp = res.item(), res_p.item()
            if abs(r - rp) > RES_RTOL * abs(rp):
                raise AssertionError(f"{tag}: residual {r} vs plain {rp}")
            if dtype == torch.float32 and (H, W, offset) == GS_CASES[0]:
                worst = max(worst, abs(r - rp))
            ran.add(which)
            log(f"{tag}: block+edges bitwise, residual {r:.9g} = kernel "
                f"order, plain {rp:.9g} (rtol {RES_RTOL}), reproducible")
    if ran != set(stages.GS_ROUTES):
        raise AssertionError(f"gs_stencil: routes run {sorted(ran)}")
    check_gs_streams(stages, device)
    check_gs_one_launch(stages, device)
    return worst


def check_gs_streams(stages, device, n_calls: int = 50) -> None:
    """Four streams, each held back by a sleep so that its calls queue,
    then launching ``n_calls`` calls from a thread of its own: the calls
    of the four streams run at once, and each result must equal, bitwise,
    the same call made alone (a ticket or partials buffer shared between
    streams would mix their sums)."""
    import threading
    import torch
    cases = [stencil_inputs(H, W, torch.float32, 50 + k, device)
             for k, (H, W) in enumerate(((BLOCK, BLOCK), (1000, 1023),
                                         (BLOCK, BLOCK), (256, 8)))]
    alone = [[t.clone() for t in (r[0], r[1], *r[2])]
             for r in (stages.gs_stencil(*a) for a in cases)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device) for _ in cases]
    results = [[] for _ in cases]

    def run(k):
        with torch.cuda.stream(streams[k]):
            torch.cuda._sleep(50_000_000)
            for _ in range(n_calls):
                results[k].append(stages.gs_stencil(*cases[k]))

    threads = [threading.Thread(target=run, args=(k,))
               for k in range(len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for k, want in enumerate(alone):
        if len(results[k]) != n_calls:
            raise AssertionError(f"gs_stencil streams: stream {k} made "
                                 f"{len(results[k])} calls")
        for new, res, edges in results[k]:
            if not all(torch.equal(g, w)
                       for g, w in zip((new, res, *edges), want)):
                raise AssertionError(f"gs_stencil streams: a call on "
                                     f"stream {k} differs from alone")
    log(f"gs_stencil: 4 streams x {n_calls} calls at once, each bitwise "
        f"equal to the call alone")


def check_gs_one_launch(stages, device, n_calls: int = 10) -> None:
    """torch.profiler over ``n_calls`` eager calls sees exactly that many
    device kernels, all ``gs_stencil`` (no second pass, no memset, no
    halo cast)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    args = stencil_inputs(BLOCK, BLOCK, torch.float32, 10, device)
    stages.gs_stencil(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            stages.gs_stencil(*args)
        torch.cuda.synchronize()
    seen = {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("Activity Buffer")}
    if sum(seen.values()) != n_calls or not all("gs_stencil" in k
                                                for k in seen):
        raise AssertionError(f"gs_stencil: {n_calls} calls gave device "
                             f"activity {seen}")
    log(f"gs_stencil: {n_calls} calls, {n_calls} kernels ({seen})")


def _strided(t):
    """``t``'s values in a non-contiguous layout of the same shape."""
    import torch
    if t.dim() >= 2:
        v = t.transpose(-1, -2).contiguous().transpose(-1, -2)
    else:
        v = torch.zeros(2 * t.numel(), dtype=t.dtype,
                        device=t.device)[::2].copy_(t)
    assert not v.is_contiguous()
    return v


def _offset(t, k: int = 1):
    """``t``'s values in a contiguous view ``k`` elements into a flat
    buffer: misaligned for every dtype's 16-byte vectors."""
    import torch
    buf = torch.zeros(t.numel() + k, dtype=t.dtype, device=t.device)
    return buf[k:].view(t.shape).copy_(t)


def _rel_err(got, want) -> float:
    """max|got - want| / max|want|."""
    return _max_abs_diff(got, want) / max(float(want.double().abs().max()),
                                          1e-30)


def check_ops_views(device) -> None:
    """Phase 2b: transposed and offset views of every input through the
    five ``kernels.ops`` entry points with a hand kernel reach the kernel
    and match its plain version on the contiguous inputs."""
    import torch
    from repro_torch.kernels import collective_stages as stages
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import mlstm_chunk as mk
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ops
    bf = torch.bfloat16
    # entry point: (its kernel, inputs, keywords, the outputs held to plain
    # as (output, tolerance as max|diff| / max|plain|))
    cases = {
        "flash_attention": (fa.flash_attention,
                            _qkv((1, 128, 128, 4, 2, 64), bf, device, 21),
                            {}, lambda r: [(r, 2e-2)]),
        "mamba2_ssd": (ssd.mamba2_ssd,
                       _ssd_inputs((1, 128, 4, 64, 64), bf, device, 22),
                       {"chunk": 64}, lambda r: [(r[0], 2e-2), (r[1], 1e-3)]),
        "mlstm_chunked": (mk.mlstm_chunk,
                          _mlstm_inputs((1, 128, 2, 64), bf, device, 23),
                          {"chunk": 64},
                          lambda r: [(r[0], 2e-2)] + [(t, 1e-3)
                                                      for t in r[1]]),
        "moe_gmm": (mg.moe_gmm, _gmm_inputs((4, 16, 64, 48), bf, device, 24),
                    {}, lambda r: [(r, 2e-2)]),
        "gs_stencil": (stages.gs_stencil,
                       stencil_inputs(96, 128, torch.float32, 25, device),
                       {}, lambda r: [(r[1], RES_RTOL)]),
    }
    for name, (kernel, args, kw, held) in cases.items():
        entry = getattr(ops, name)
        want = entry(*args, impl="ref", **kw)
        for kind, make in (("transposed", _strided), ("offset", _offset)):
            before = kernel.launches
            got = entry(*(make(t) for t in args), **kw)
            torch.cuda.synchronize()
            tag = f"ops views {name} {kind}"
            if kernel.launches <= before:
                raise AssertionError(f"{tag}: the kernel did not launch")
            if name == "gs_stencil" and not (
                    torch.equal(got[0], want[0]) and all(
                        torch.equal(e, w) for e, w in zip(got[2], want[2]))):
                raise AssertionError(f"{tag}: block or edges differ")
            errs = []
            for (g, tol), (w, _) in zip(held(got), held(want)):
                errs.append(_rel_err(g, w))
                if not errs[-1] <= tol:
                    raise AssertionError(f"{tag}: {errs[-1]} of max|plain| "
                                         f"(limit {tol})")
            log(f"{tag}: launched, max|diff| / max|plain| "
                f"{', '.join(f'{e:.3g}' for e in errs)}")


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
    device time from CUDA-graph replay for the kernel, for the plain
    version and for ``dst.copy_(block)`` into 16 destinations (the floor
    for moving the block's bytes at this size), and the eager wrapper's
    time as the main path calls it."""
    import torch
    ring = [stencil_inputs(BLOCK, BLOCK, torch.float32, 100 + i, device)
            for i in range(16)]
    dst = [torch.empty_like(r[0]) for r in ring]
    t = {"ms": graph_ms(lambda i: stages.gs_stencil(*ring[i % 16]), 16),
         "plain_ms": graph_ms(lambda i: ref.gs_stencil(*ring[i % 16]), 16),
         "copy_ms": graph_ms(lambda i: dst[i % 16].copy_(ring[i % 16][0]),
                             16),
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
    t["bound_share"] = t["bound_ms"] / t["ms"]
    return t


def level_a_tensors(device) -> None:
    """Phase 6: Level-A collectives keep tensor payloads on the card."""
    import torch
    from repro_torch.core import Collectives, tac
    rng = np.random.default_rng(6)
    host = [rng.standard_normal(1 << 20).astype(np.float32)
            for _ in range(N_RANKS)]
    want = np.sum(np.stack(host).astype(np.float64), axis=0)
    for name, kw in (("allreduce", {}), ("allreduce", {"segments": 4}),
                     ("reduce_scatter", {}),
                     ("allreduce", {"algorithm": "doubling"})):
        outs = {}
        for dev in (device, torch.device("cpu")):
            coll = Collectives(tac.CommWorld(N_RANKS))
            outs[dev.type] = coll.run_group(
                name, [{"value": torch.from_numpy(h).to(dev)} for h in host],
                **kw)
        for r, (g, c) in enumerate(zip(outs["cuda"], outs["cpu"])):
            if not (isinstance(g, torch.Tensor) and g.is_cuda):
                raise AssertionError(f"Level-A {name} {kw}: rank {r} got "
                                     f"{type(g).__name__} off the card")
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"Level-A {name} {kw}: card and CPU "
                                     f"differ at rank {r}")
            ref = (want if name == "allreduce"
                   else np.array_split(want, N_RANKS)[r])
            if not np.allclose(g.cpu().double().numpy(), ref, rtol=1e-6,
                               atol=1e-6):
                raise AssertionError(f"Level-A {name} {kw}: rank {r} is not "
                                     f"the float64 sum")
    coll = Collectives(tac.CommWorld(N_RANKS))
    plan = coll.persistent("allreduce")
    for it in range(2):
        got = plan.run_group([torch.from_numpy(h).to(device) for h in host])
        for g in got:
            if not g.is_cuda or not np.allclose(g.cpu().double().numpy(),
                                                want, rtol=1e-6, atol=1e-6):
                raise AssertionError(f"Level-A persistent allreduce, "
                                     f"iteration {it}: wrong or off the card")
    log("Level-A on CUDA tensors: allreduce (ring, segmented, doubling), "
        "reduce_scatter and a persistent plan return CUDA tensors, bitwise "
        "equal to the CPU run, rtol 1e-6 of the float64 sum")


def _stage_inputs(m: int, device, seed: int = 0):
    """acc/got for every combine variant at length ``m``, from a seed."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device=device)
    gen.manual_seed(m + seed)
    acc32 = torch.randn(m, generator=gen, device=device)
    got32 = torch.randn(m, generator=gen, device=device) * 3.0
    q, scale = ops.quantize_stage(got32, impl="ref")
    accs = {"fp32": acc32, "bf16": acc32.to(torch.bfloat16)}
    gots = {"fp32": (got32, None), "bf16": (got32.to(torch.bfloat16), None),
            "int8": (q, scale)}
    return accs, gots


def _max_abs_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_combine_views(stages, ref, device, m, held) -> int:
    """Every ``fused_combine`` variant, and the in-place update, on views
    of length ``m`` at the offsets of STAGE_VIEW_OFFSETS, bitwise against
    the plain version (``held``); returns the number of calls."""
    accs, gots = _stage_inputs(m + 3, device, seed=2)
    n = 0
    for oa, og in STAGE_VIEW_OFFSETS:
        for an, acc0 in accs.items():
            acc = acc0[oa:oa + m]
            for gn, (got0, scale) in gots.items():
                got = got0[og:og + m]
                what = f"acc {an} got {gn} m={m} views at {oa}, {og}"
                for accumulate in (True, False):
                    held("fused_combine",
                         stages.fused_combine(acc, got, scale,
                                              accumulate=accumulate),
                         ref.combine_stage(acc, got, scale,
                                           accumulate=accumulate),
                         f"{what} accumulate {accumulate}")
                buf = acc0.clone()
                inplace = buf[oa:oa + m]
                stages.fused_combine(inplace, got, scale, out=inplace)
                held("fused_combine", inplace,
                     ref.combine_stage(acc, got, scale), f"in place {what}")
                n += 3
    return n


def check_stage_kernels(stages, ref, device,
                        lengths=STAGE_LENGTHS) -> dict:
    """Phase 7: each Level-B stage kernel bitwise against its plain version
    on the card; returns each kernel's largest |kernel - plain| over every
    variant and length."""
    import torch
    from repro_torch.kernels import ops
    worst = {"fused_combine": 0.0, "quantize_wire": 0.0,
             "dequantize_wire": 0.0}

    def held(name, k, p, what):
        worst[name] = max(worst[name], _max_abs_diff(k, p))
        if k.dtype != p.dtype or not torch.equal(k, p):
            raise AssertionError(f"{name} {what}: kernel differs from plain")

    for m in lengths:
        accs, gots = _stage_inputs(m, device)
        n_var = 0
        for an, acc in accs.items():
            for gn, (got, scale) in gots.items():
                for accumulate in (True, False):
                    k = stages.fused_combine(acc, got, scale,
                                             accumulate=accumulate)
                    p = ref.combine_stage(acc, got, scale,
                                          accumulate=accumulate)
                    if k.dtype != acc.dtype:
                        raise AssertionError(f"fused_combine acc {an}: "
                                             f"result dtype {k.dtype}")
                    held("fused_combine", k, p, f"acc {an} got {gn} "
                         f"accumulate {accumulate} m={m}")
                    n_var += 1
                    del k, p
                inplace = acc.clone()
                stages.fused_combine(inplace, got, scale, out=inplace)
                held("fused_combine", inplace,
                     ref.combine_stage(acc, got, scale),
                     f"in place acc {an} got {gn} m={m}")
                del inplace
        x32 = gots["fp32"][0]
        for xn, x in (("fp32", x32), ("bf16", gots["bf16"][0])):
            scale = ops.wire_scale(x)
            held("quantize_wire", stages.quantize_wire(x, scale),
                 ref.quantize_stage(x, scale), f"{xn} m={m}")
        q, scale = gots["int8"]
        for dt in (torch.float32, torch.bfloat16):
            held("dequantize_wire", stages.dequantize_wire(q, scale, dt),
                 ref.dequantize_stage(q, scale, dt), f"{dt} m={m}")
        torch.cuda.synchronize()
        del accs, gots, x32, q
        log(f"stage kernels m={m}: fused_combine {n_var} variants + in "
            f"place, quantize_wire fp32/bf16, dequantize_wire fp32/bf16 "
            f"bitwise equal to plain")
        if m < FUSED_CHUNK:
            n_view = check_combine_views(stages, ref, device, m, held)
            log(f"stage kernels m={m}: fused_combine on views at offsets "
                f"{STAGE_VIEW_OFFSETS}, {n_view} calls bitwise equal to "
                f"plain")
    # exact .5 boundaries: scale = 15.875 / 127 = 0.125 exactly, so
    # x / scale lands on k + 0.5 and must round half to even
    half = torch.arange(-127, 127, dtype=torch.float32) + 0.5
    x = torch.cat([half * 0.125, torch.tensor([15.875, -15.875])]).to(device)
    q, scale = ops.quantize_stage(x, impl="cuda")
    held("quantize_wire", q, ref.quantize_stage(x, scale), ".5 boundaries")
    want = torch.round(half).clamp(-127, 127).to(torch.int8)
    if scale.item() != 0.125 or not torch.equal(q[:254].cpu(), want):
        raise AssertionError("quantize_wire: .5 boundaries do not round "
                             "half to even")
    log("quantize_wire: 256 values on exact .5 boundaries round half to "
        "even, equal to plain")
    log(f"stage kernels: max |kernel - plain| {worst}")
    return worst


def _leaf_rel_errors(result, grads, step: int = 1 << 25):
    """max|result - float64 mean| / max|mean| per leaf, the mean built in
    float64 leaf by leaf, ``step`` elements at a time."""
    from repro_torch.core.overlap import tree_flatten
    res, _ = tree_flatten(result)
    per_rank = [[l.reshape(-1) for l in tree_flatten(g)[0]] for g in grads]
    errs = []
    for i, leaf in enumerate(res):
        leaf = leaf.reshape(-1)
        err = top = 0.0
        for a in range(0, leaf.numel(), step):
            mean = per_rank[0][i][a:a + step].double()
            for r in range(1, len(grads)):
                mean += per_rank[r][i][a:a + step]
            mean /= len(grads)
            err = max(err, float((leaf[a:a + step] - mean).abs().max()))
            top = max(top, float(mean.abs().max()))
        errs.append((str(leaf.dtype)[6:], err / top))
    return errs


def _trees_equal(a, b) -> bool:
    import torch
    from repro_torch.core.overlap import tree_flatten
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# The Level-B main path's runs: (label, run_sync keyword arguments).
SYNC_RUNS = (
    ("fused ring cuda", dict(mode="fused")),
    ("fused ring None", dict(mode="fused", stage_impl=None)),
    ("bucketed ring cuda", dict(mode="bucketed")),
    ("bucketed ring None", dict(mode="bucketed", stage_impl=None)),
    ("sentinel ring cuda", dict(mode="sentinel")),
    ("fused ring cuda bf16-wire", dict(mode="fused", stage_wire="bf16")),
    ("fused ring ref bf16-wire", dict(mode="fused", stage_impl="ref",
                                      stage_wire="bf16")),
    ("fused ring cuda int8-wire", dict(mode="fused", stage_wire="int8")),
    ("fused ring ref int8-wire", dict(mode="fused", stage_impl="ref",
                                      stage_wire="int8")),
    ("fused doubling cuda", dict(mode="fused", algorithm="doubling")),
    ("fused doubling None", dict(mode="fused", algorithm="doubling",
                                 stage_impl=None)),
    ("fused hierarchical-2x2 cuda", dict(mode="fused", hierarchical=True)),
    ("fused hierarchical-2x2 None", dict(mode="fused", hierarchical=True,
                                         stage_impl=None)),
)
# label -> the earlier run it must equal bitwise: every configuration that
# launches fused_combine has a plain (None) or "ref" twin on the same inputs
SYNC_EQUAL = {"fused ring None": "fused ring cuda",
              "bucketed ring None": "bucketed ring cuda",
              "sentinel ring cuda": "bucketed ring cuda",
              "fused ring ref bf16-wire": "fused ring cuda bf16-wire",
              "fused ring ref int8-wire": "fused ring cuda int8-wire",
              "fused doubling None": "fused doubling cuda",
              "fused hierarchical-2x2 None": "fused hierarchical-2x2 cuda"}


def level_b_main_path(stages, device):
    """Phase 8: returns per-run wall seconds and each stage kernel's
    launches over the whole main path."""
    import torch
    from repro_torch.bench import overlap as ov
    from repro_torch.core.overlap import tree_flatten
    grads = ov.make_grads(N_RANKS, seed=0, device=device)
    meshes = {h: ov.mesh_for(N_RANKS, h, device) for h in (False, True)}
    n_par = sum(l.numel() for l in tree_flatten(grads[0])[0])
    if n_par != HUBERT_PARAMS:
        raise AssertionError(f"hubert-xlarge gradient has {n_par} params")
    log(f"Level-B main path: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated before the runs (the inputs included)")
    for k in ov.KERNELS:
        getattr(stages, k).launches = 0
    kept, seconds = {}, {}
    # a run's result is kept until every run that must equal it has run
    pending = {}
    for other in SYNC_EQUAL.values():
        pending[other] = pending.get(other, 0) + 1
    for label, kw in SYNC_RUNS:
        kw = dict(kw)
        mode = kw.pop("mode")
        mesh = meshes[kw.get("hierarchical", False)]
        # warm-up of the same configuration on the plain tier (it launches
        # no kernel): the caching allocator keeps a pool per stream and
        # each configuration needs blocks of its own sizes, so the timed
        # run reads the steady state, not cudaMalloc/cudaFree
        warm = dict(kw, stage_impl="ref" if kw.get("stage_wire") else None)
        ov.run_sync(mode, grads=grads, mesh=mesh, device=device, **warm)
        torch.cuda.reset_peak_memory_stats()
        run = ov.run_sync(mode, grads=grads, mesh=mesh, device=device, **kw)
        peak = torch.cuda.max_memory_allocated() / 2**30
        seconds[label] = run["seconds"]
        res = run.pop("results")
        for r in range(1, N_RANKS):
            if not _trees_equal(res[r], res[0]):
                raise AssertionError(f"{label}: rank {r} differs from rank 0")
        res = res[0]
        exp = ov.expected_counts(mode, **kw)
        if mode != "fused" and exp["reductions"] != 7:
            raise AssertionError(f"{label}: {exp['reductions']} buckets, "
                                 f"expected 7")
        if (run["ppermute_calls"] != [exp["ppermute_per_rank"]] * N_RANKS
                or run["token_waits"] != [exp["token_waits_per_rank"]]
                * N_RANKS or run["launches"] != exp["launches"]):
            raise AssertionError(f"{label}: counts {run} differ from the "
                                 f"derived {exp}")
        rtol = SYNC_RTOL[kw.get("stage_wire")]
        errs = _leaf_rel_errors(res, grads)
        worst = max(e for _, e in errs)
        for dt, e in errs:
            if not e <= rtol[dt]:
                raise AssertionError(f"{label}: a {dt} leaf is {e} from the "
                                     f"float64 mean (rtol {rtol[dt]})")
        if label in SYNC_EQUAL:
            other = SYNC_EQUAL[label]
            if not _trees_equal(res, kept[other]):
                raise AssertionError(f"{label}: not bitwise equal to {other}")
            pending[other] -= 1
            if not pending[other]:
                del kept[other]
            log(f"{label}: bitwise equal to {other}")
        if label in pending:
            kept[label] = res
        del res
        log(f"sync_grads {label}: {seconds[label]:.6f} s, peak device "
            f"memory {peak:.2f} GiB, ranks bitwise "
            f"equal, worst leaf {worst:.3g} of the float64 mean, ppermute "
            f"{run['ppermute_calls'][0]}/rank, sentinel waits "
            f"{run['token_waits'][0]}/rank, launches {run['launches']}")
    if kept:
        raise AssertionError(f"runs left uncompared: {sorted(kept)}")
    launches = {k: getattr(stages, k).launches for k in ov.KERNELS}
    log(f"Level-B main path: launches {launches}")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"{k} was not launched on the main path")
    return seconds, launches


def time_stage_kernels(stages, ref, device):
    """Phase 9: per-kernel times at the main path's chunk shapes (the
    fused-mode ring chunk: every call's operands are far larger than the
    50 MB L2, so each launch reads cold data), as in phase 5, plus one
    PyTorch call computing the same function where there is one."""
    import torch
    from repro_torch.kernels import ops
    out = {}
    for m in (FUSED_CHUNK,) + BUCKET_CHUNKS:
        sets = [_stage_inputs(m, device, seed=1 + i) for i in range(2)]
        acc = [s[0]["fp32"] for s in sets]
        got = [s[1]["fp32"][0] for s in sets]
        t = {"ms": graph_ms(lambda i: stages.fused_combine(
                 acc[i % 2], got[i % 2]), 4),
             "plain_ms": graph_ms(lambda i: ref.combine_stage(
                 acc[i % 2], got[i % 2]), 4),
             "library_ms": graph_ms(lambda i: torch.add(
                 acc[i % 2], got[i % 2]), 4),
             "wrapper_ms": time_ms(lambda i: stages.fused_combine(
                 acc[i % 2], got[i % 2]), 20),
             "bound_ms": 12 * m / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes"}
        q = [s[1]["int8"][0] for s in sets]
        sc = [s[1]["int8"][1] for s in sets]
        alpha = [float(v) for v in sc]      # read before any capture
        t8 = {"ms": graph_ms(lambda i: stages.fused_combine(
                  acc[i % 2], q[i % 2], sc[i % 2]), 4),
              "plain_ms": graph_ms(lambda i: ref.combine_stage(
                  acc[i % 2], q[i % 2], sc[i % 2]), 4),
              "library_ms": graph_ms(lambda i: torch.add(
                  acc[i % 2], q[i % 2], alpha=alpha[i % 2]), 4),
              "bound_ms": 9 * m / HBM_BYTES_PER_S * 1e3}
        # |library - plain| in ulps of the larger addend
        lib8 = torch.add(acc[0], q[0], alpha=alpha[0])
        big = torch.maximum(acc[0].abs(), (q[0].float() * sc[0]).abs())
        ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
        ulp8 = float(((lib8 - ref.combine_stage(acc[0], q[0], sc[0])).abs()
                      / ulp).max())
        del lib8, big, ulp
        log(f"fused_combine m={m} fp32+fp32: device {t['ms']:.6f} ms (plain "
            f"{t['plain_ms']:.6f}, torch.add {t['library_ms']:.6f}, kernel "
            f"/ add {t['ms'] / t['library_ms']:.4f}), eager wrapper "
            f"{t['wrapper_ms']:.6f}, bound {t['bound_ms']:.6f} ms, bound / "
            f"ms {t['bound_ms'] / t['ms']:.4f}")
        log(f"fused_combine m={m} fp32+int8*scale: device {t8['ms']:.6f} ms "
            f"(plain {t8['plain_ms']:.6f}, torch.add(alpha=scale) "
            f"{t8['library_ms']:.6f}, at most {ulp8:.3g} ulp of the larger "
            f"addend from the kernel's result), bound "
            f"{t8['bound_ms']:.6f} ms, bound / ms "
            f"{t8['bound_ms'] / t8['ms']:.4f}")
        if m != FUSED_CHUNK:
            del sets, acc, got, q, sc
            continue
        out["fused_combine"] = t
        x = got
        scales = [ops.wire_scale(v) for v in x]
        fscales = [float(v) for v in scales]
        # torch.quantize_per_tensor(x, scale, 0, qint8) is the same
        # function up to where x / scale rounds; how many q values differ
        # from the kernel's is printed beside its time
        lib_q = torch.quantize_per_tensor(x[0], fscales[0], 0,
                                          torch.qint8).int_repr()
        q_diff = int((lib_q != stages.quantize_wire(x[0], scales[0])).sum())
        del lib_q
        out["quantize_wire"] = {
            "ms": graph_ms(lambda i: stages.quantize_wire(
                x[i % 2], scales[i % 2]), 4),
            "plain_ms": graph_ms(lambda i: ref.quantize_stage(
                x[i % 2], scales[i % 2]), 4),
            # eager, timed by CUDA events: quantized tensors are not
            # captured in a graph here
            "library_ms": time_ms(lambda i: torch.quantize_per_tensor(
                x[i % 2], fscales[i % 2], 0, torch.qint8), 20),
            "wrapper_ms": time_ms(lambda i: stages.quantize_wire(
                x[i % 2], scales[i % 2]), 20),
            "bound_ms": (5 * m + 4) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
        out["dequantize_wire"] = {
            "ms": graph_ms(lambda i: stages.dequantize_wire(
                q[i % 2], sc[i % 2]), 4),
            "plain_ms": graph_ms(lambda i: ref.dequantize_stage(
                q[i % 2], sc[i % 2]), 4),
            "library_ms": graph_ms(lambda i: torch.mul(q[i % 2], sc[i % 2]),
                                   4),
            "wrapper_ms": time_ms(lambda i: stages.dequantize_wire(
                q[i % 2], sc[i % 2]), 20),
            "bound_ms": (5 * m + 4) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
        for k in ("quantize_wire", "dequantize_wire"):
            v = out[k]
            log(f"{k} m={m}: device {v['ms']:.6f} ms (plain "
                f"{v['plain_ms']:.6f}, library {v['library_ms']}), eager "
                f"wrapper {v['wrapper_ms']:.6f}, bound {v['bound_ms']:.6f} ms")
        log(f"torch.quantize_per_tensor m={m}: {q_diff} of {m} q values "
            f"differ from quantize_wire's")
        del sets, acc, got, q, sc, x
    torch.cuda.empty_cache()
    return out


# Phase 10 shapes: (B, S, T, H, Hkv, D, causal, window) -- the sweep of the
# JAX package's kernel test, a ragged pair, the smoke-scale granite-3-2b
# prefill of the serving CLI's defaults, and the edges of the bf16 kernel's
# 128-row, 128-key TMA tiles at every head dim.
FLASH_CASES = (
    (1, 256, 256, 4, 2, 64, True, None),
    (2, 128, 128, 8, 8, 128, False, None),
    (1, 256, 256, 4, 1, 64, True, 64),
    (2, 512, 512, 2, 2, 32, True, None),
    (1, 128, 128, 6, 2, 80, True, None),
    (1, 1000, 1000, 4, 2, 64, True, None),
    (1, 1, 2080, 4, 2, 64, False, None),
    (1, 32, 32, 4, 2, 16, True, None),
    (2, 1000, 1000, 4, 2, 80, True, None),
    (1, 300, 300, 32, 1, 128, True, None),
    (2, 77, 200, 8, 2, 64, False, 50),
    (1, 130, 257, 6, 2, 16, False, None),
    (2, 200, 333, 4, 4, 32, True, 64),
)
GRANITE_PREFILL = (1, 2048, 2048, 32, 8, 64, True, None)
# zamba2-2.7b's shared attention: 32 heads of dim 80 over 32 kv heads
ZAMBA_PREFILL = (1, 2048, 2048, 32, 32, 80, True, None)
# olmoe-1b-7b's attention: 16 heads of dim 128 over 16 kv heads
OLMOE_PREFILL = (1, 2048, 2048, 16, 16, 128, True, None)
# tests/test_kernels.py's tolerances (atol = rtol), compared in fp32
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# At the three served shapes the bf16 kernel is also held to RMS(kernel -
# plain) / RMS(plain): there a causal row averages up to 2048 values, so a
# late row's |o| is about 0.03 and 2e-2 absolute is loose for it.  On an
# NVIDIA H100 80GB HBM3 at 700 W the kernel reads 0.0021 (the bf16 rounding
# of o), and faults planted in a copy of its pipeline read 0.034 to 0.51
# (alpha forced to 1 or the O rescale dropped from the 9th key tile on, one
# tile or half a tile dropped deep in a row, the last tile dropped).
FLASH_SERVED_REL_RMS = 1e-2
# Phases 11, 14 and 17: granite-3-2b, zamba2-2.7b and xlstm-350m at full width
# and depth, served on one card.
GRANITE_PARAMS = 2_533_531_648
ZAMBA_PARAMS = 2_435_777_440
SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN, SERVE_SLOTS = 4, 2048, 32, 4
# The kernel path's prefill logits against the plain attention's, as
# max|diff| / max|plain logits|.  Both attentions read the same bf16 q, k,
# v and accumulate in fp32, in different orders (about 1e-6 relative); the
# bf16 rounding of their outputs then differs by one ulp (2^-8) on the
# elements that straddle a rounding boundary, and 40 layers of bf16
# matmuls and residual adds carry those flips to the logits.  So: the bf16
# tolerance of the kernel test (2e-2), widened 2.5x for the depth, as the
# CPU model test widens it for two layers (5e-2).  zamba2's 54 SSD scans
# round y to bf16 the same way and are held to the same gate.  xlstm-350m
# with random weights amplifies such flips to O(1) (compare_chaotic), so
# its whole-model gate runs on an fp32 copy of its weights.
SERVE_LOGIT_RTOL = 5e-2
BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak


def _qkv(case, dtype, device, seed):
    import torch
    B, S, T, H, Hkv, D = case[:6]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, D))]


def check_flash_attention(fa, ref, device) -> float:
    """Phase 10: the kernel against its plain version on the card at every
    shape, in fp32 and bf16 (at the served shapes in bf16 also as a ratio
    of RMS), and bitwise repeatable; returns the largest
    |kernel - plain| at granite's prefill shape (bf16)."""
    import torch
    worst = 0.0
    cases = [(c, dt) for dt in ("float32", "bfloat16") for c in FLASH_CASES]
    served = (GRANITE_PREFILL, ZAMBA_PREFILL, OLMOE_PREFILL)
    cases += [(c, dt) for c in served for dt in ("bfloat16", "float32")]
    for case, dt in cases:
        causal, window = case[6], case[7]
        q, k, v = _qkv(case, getattr(torch, dt), device, seed=sum(case[:6]))
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        again = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tag = f"flash_attention {dt} {case}"
        if got.dtype != q.dtype or got.shape != q.shape:
            raise AssertionError(f"{tag}: result {got.dtype} "
                                 f"{tuple(got.shape)}")
        if not torch.equal(got, again):
            raise AssertionError(f"{tag}: two calls differ")
        tol = FLASH_TOL[dt]
        err = _max_abs_diff(got, want)
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"{tag}: max |kernel - plain| {err} beyond "
                                 f"atol = rtol = {tol}")
        if case == GRANITE_PREFILL and dt == "bfloat16":
            worst = err
        rel = ""
        if case in served and dt == "bfloat16":
            diff = got.double() - want.double()
            rms = float(diff.square().mean().sqrt()
                        / want.double().square().mean().sqrt())
            if not rms <= FLASH_SERVED_REL_RMS:
                raise AssertionError(f"{tag}: RMS(kernel - plain) / "
                                     f"RMS(plain) {rms} beyond "
                                     f"{FLASH_SERVED_REL_RMS}")
            rel = (f", RMS(kernel - plain) / RMS(plain) {rms:.3g} "
                   f"(<= {FLASH_SERVED_REL_RMS})")
        log(f"{tag}: max |kernel - plain| {err:.3g} (atol = rtol = {tol})"
            f"{rel}, two calls bitwise equal")
    return worst


def serving_main_path(arch: str, n_params: int, width: tuple,
                      kernels: dict, plain: dict, device,
                      compare=None, routes=None) -> dict:
    """Phases 11, 14, 17 and 20: ``arch`` at full width and depth
    (``width`` is its (n_layers, d_model, n_heads, n_kv_heads)) served
    through the port's engine on both completion legs.  ``kernels`` maps
    each kernel's name to (its wrapper, launches per request): every leg
    launches each exactly that many times per request (a prefill kernel
    once a block, ``moe_gmm`` in prefill and every decode step); ``plain``
    names the ``*_impl`` arguments that put one request on the plain
    versions, and ``compare`` (default :func:`compare_with_plain`) holds
    the kernel path against them.  ``routes`` maps a kernel with
    ``route_launches`` to the route every launch of a leg must take.
    Returns what the run measured and each kernel's launches over both
    legs."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as port_model
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.lm import LMAdapter
    cfg = configs.get(arch)
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads) != width:
        raise AssertionError(f"{arch} config is not full width: {cfg}")
    t0 = time.perf_counter()
    model = port_model.init(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_par = port_model.param_count(model)
    if n_par != n_params:
        raise AssertionError(f"{arch} has {n_par} parameters, expected "
                             f"{n_params}")
    log(f"{arch}: {n_par} parameters in bf16, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, init "
        f"{time.perf_counter() - t0:.3f} s")
    adapter = LMAdapter(cfg, model, prompt_len=SERVE_PROMPT,
                        gen_len=SERVE_GEN, device=device)
    out = {"legs": {}, "launches": dict.fromkeys(kernels, 0)}

    # one request alone, step by step: prefill ms and decode ms per token
    adapter.warmup()
    req = Request(rid=-2, prompt=12345, gen_len=SERVE_GEN)
    t0 = time.perf_counter()
    handle, state = adapter.prefill(req)
    handle.wait()
    t1 = time.perf_counter()
    for step in range(1, SERVE_GEN):
        handle, state = adapter.decode(req, state, step)
        handle.wait()
    t2 = time.perf_counter()
    del state
    out["prefill_ms"] = (t1 - t0) * 1e3
    out["decode_ms_per_token"] = (t2 - t1) * 1e3 / (SERVE_GEN - 1)
    log(f"{arch}, one request alone: prefill {out['prefill_ms']:.3f} ms "
        f"({SERVE_PROMPT} tokens), decode {out['decode_ms_per_token']:.3f} "
        f"ms/token")

    streams = {}
    for leg in ("event", "blocking"):
        adapter.warmup()
        torch.cuda.reset_peak_memory_stats()
        for fn, _ in kernels.values():
            fn.launches = 0
            if hasattr(fn, "route_launches"):
                fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        reqs = [Request(rid=i, prompt=1000 + i, gen_len=SERVE_GEN)
                for i in range(SERVE_REQUESTS)]
        rep = ServingEngine(adapter, slots=SERVE_SLOTS, completion=leg,
                            num_workers=SERVE_SLOTS).run(reqs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        for r in reqs:
            r.cache = None
        counts = {}
        for name, (fn, per_request) in kernels.items():
            counts[name] = n = fn.launches
            out["launches"][name] += n
            if n != per_request * SERVE_REQUESTS:
                raise AssertionError(f"{arch} {leg} leg: {name} launched {n} "
                                     f"times, expected {per_request} a "
                                     f"request x {SERVE_REQUESTS}")
            if hasattr(fn, "route_launches"):
                counts[name] = dict(fn.route_launches)
                need = (routes or {}).get(name)
                if need and fn.route_launches[need] != n:
                    raise AssertionError(f"{arch} {leg} leg: {name} "
                                         f"launches by route "
                                         f"{fn.route_launches}, all {n} "
                                         f"expected on {need}")
        for rid, toks in rep.outputs.items():
            if len(toks) != SERVE_GEN or not all(
                    0 <= t < cfg.vocab for t in toks):
                raise AssertionError(f"{arch} {leg} leg: request {rid} "
                                     f"emitted {toks}")
        streams[leg] = rep.outputs
        out["legs"][leg] = {"tokens_per_s": rep.tokens_per_s,
                            "p50_ms": rep.p50_ms, "p99_ms": rep.p99_ms,
                            "wall_s": rep.wall_s, "peak_gib": peak}
        log(f"serve {arch} {rep.summary()}; launches {counts}; peak "
            f"allocated {peak:.2f} GiB")
    if streams["event"] != streams["blocking"]:
        raise AssertionError(f"{arch}: the event and blocking legs emitted "
                             f"different token streams")
    log(f"serve {arch}: both legs emitted identical streams; request 0: "
        f"{streams['event'][0]}")

    compare = compare or compare_with_plain
    out.update(compare(arch, cfg, model, kernels, plain, device,
                       streams["event"][0]))
    return out


def _request0_prompt(cfg, model, device):
    from repro_torch.serving import Request
    from repro_torch.serving.lm import LMAdapter
    ad = LMAdapter(cfg, model, prompt_len=SERVE_PROMPT, gen_len=SERVE_GEN,
                   device=device)
    return {"tokens": ad.prompt_tokens(Request(rid=0, prompt=1000,
                                               gen_len=1)).to(device)}


def _prefill_logits(model, toks, **impls):
    import torch
    from repro_torch.models import model as port_model
    with torch.inference_mode():
        logits, _, _ = port_model.apply(model, toks, mode="prefill", **impls)
    return logits[0, -1].float()


def _serve_request0(cfg, model, device, **impls):
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.lm import LMAdapter
    ad = LMAdapter(cfg, model, prompt_len=SERVE_PROMPT, gen_len=SERVE_GEN,
                   device=device, **impls)
    return ServingEngine(ad, slots=1, completion="blocking",
                         num_workers=1).run(
        [Request(rid=0, prompt=1000, gen_len=SERVE_GEN)]).outputs[0]


def compare_with_plain(arch, cfg, model, kernels, plain, device,
                       stream) -> dict:
    """Request 0 on the plain versions (``plain``, the ``*_impl``
    arguments) against the kernel path on ``model``: prefill logits within
    ``SERVE_LOGIT_RTOL`` of the largest logit; served on the plain
    versions it launches no kernel, and its first token equals the kernel
    path's ``stream`` where the top-1/top-2 margin exceeds that
    tolerance."""
    import torch
    toks = _request0_prompt(cfg, model, device)
    lk = _prefill_logits(model, toks)
    lr = _prefill_logits(model, toks, **plain)
    scale = float(lr.abs().max())
    diff = float((lk - lr).abs().max())
    if not diff <= SERVE_LOGIT_RTOL * scale:
        raise AssertionError(f"{arch} prefill logits: kernels vs plain "
                             f"versions max |diff| {diff} > "
                             f"{SERVE_LOGIT_RTOL} x {scale}")
    top2 = torch.topk(lr, 2).values
    margin = float(top2[0] - top2[1])
    before = {k: fn.launches for k, (fn, _) in kernels.items()}
    ref_stream = _serve_request0(cfg, model, device, **plain)
    if {k: fn.launches for k, (fn, _) in kernels.items()} != before:
        raise AssertionError(f"{arch}: {plain} launched a kernel")
    if margin > SERVE_LOGIT_RTOL * scale and ref_stream[0] != stream[0]:
        raise AssertionError(f"{arch}: first token {stream[0]} differs from "
                             f"the plain path's {ref_stream[0]} with a "
                             f"top-1/top-2 margin of {margin}")
    agree = sum(a == b for a, b in zip(ref_stream, stream))
    log(f"{arch} ({cfg.dtype}), plain versions ({plain}), request 0: "
        f"prefill logits max |kernel - plain| {diff:.4g} = "
        f"{diff / scale:.4g} of max |logit| {scale:.4g} (rtol "
        f"{SERVE_LOGIT_RTOL}); top-1/top-2 margin {margin:.4g}; {agree} of "
        f"{SERVE_GEN} tokens agree with the kernel path's stream")
    return {"logit_rel_diff": diff / scale, "plain_tokens_agree": agree}


def _wide_copy(cfg, model, dtype: str, device):
    """A copy of ``model`` with every weight in ``dtype`` (and its
    config)."""
    import dataclasses
    import torch
    from repro_torch.models import model as port_model
    wide_cfg = dataclasses.replace(cfg, dtype=dtype)
    wide = port_model.Model(wide_cfg, device)
    weights = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in wide.named_parameters():
            p.copy_(weights[name])
    return wide_cfg, wide


def compare_chaotic(arch, cfg, model, kernels, plain, device, stream,
                    dtype: str = "float32") -> dict:
    """The plain-version check of a model whose bf16 forward amplifies a
    one-ulp difference to O(1) in the logits (xlstm-350m with random
    weights: a single input element of its first block moved by one bf16
    ulp moves the plain path's prefill logits by ~18 % of the largest
    one).  So, on the served bf16 model: the kernel-vs-plain logit
    difference and that one-ulp baseline are reported, and every block
    that runs the kernel is held alone, on the plain path's input to it,
    within the kernel test's bf16 tolerance (2e-2 of its largest output).
    Then the same weights in ``dtype`` get :func:`compare_with_plain`'s
    whole-model gates, with request 0's kernel-path stream served on
    that copy (the bf16 ``stream`` is not held: see above)."""
    import torch
    from repro_torch.models import layers as L
    toks = _request0_prompt(cfg, model, device)
    lr = _prefill_logits(model, toks, **plain)
    scale = float(lr.abs().max())
    rel = float((_prefill_logits(model, toks) - lr).abs().max()) / scale
    first = model.units[0].blocks["L0_0_mlstm"]

    def nudge(mod, args):           # one element one bf16 ulp further out
        x = args[0].clone()
        x.view(torch.int16).view(-1)[100 * cfg.d_model + 5] += 1
        return (x,) + args[1:]

    hook = first.register_forward_pre_hook(nudge)
    base = float((_prefill_logits(model, toks, **plain) - lr).abs().max())
    hook.remove()
    inputs, hooks = [], []
    for unit in model.units:
        for blk in unit.blocks.values():
            if isinstance(blk, L.MLSTM):
                hooks.append(blk.register_forward_pre_hook(
                    lambda mod, args: inputs.append((mod, args[0].clone()))))
    _prefill_logits(model, toks, **plain)
    for h in hooks:
        h.remove()
    worst, n_blocks = 0.0, len(inputs)
    with torch.inference_mode():
        for blk, x in inputs:
            want = blk(x, impl="ref")
            err = float((blk(x) - want).abs().max() / want.abs().max())
            worst = max(worst, err)
    del inputs
    if not worst <= MLSTM_TOL["bfloat16"]:
        raise AssertionError(f"{arch}: an mLSTM block alone on the plain "
                             f"path's input differs from its plain version "
                             f"by {worst:.4g} of its largest output")
    log(f"{arch} (bfloat16), request 0's prefill: logits max |kernel - "
        f"plain| = {rel:.4g} of max |logit| {scale:.4g}, against "
        f"{base / scale:.4g} for the plain path with one input element of "
        f"the first block moved one bf16 ulp (not gated: the bf16 model "
        f"amplifies one-ulp differences); each of the {n_blocks} mLSTM blocks "
        f"alone on the plain path's input: kernel within {worst:.4g} of its "
        f"plain version's largest output (tolerance "
        f"{MLSTM_TOL['bfloat16']})")
    wide_cfg, wide = _wide_copy(cfg, model, dtype, device)
    stream = _serve_request0(wide_cfg, wide, device)
    out = compare_with_plain(arch, wide_cfg, wide, kernels, plain, device,
                             stream)
    out.update({"bf16_logit_rel_diff": rel,
                "bf16_one_ulp_rel_diff": base / scale,
                "block_alone_rel_err": worst})
    del wide
    return out


def time_flash_attention(fa, ref, device, cases) -> dict:
    """Phases 12 and 21: times per call at each of ``cases`` (granite's
    prefill shape and zamba2's shared-attention shape; olmoe's prefill
    shape), bf16 (rings of four input sets, 84-168 MB, larger than the 50
    MB L2), as in phase 5, and one PyTorch call computing the same
    function (``library_ms``: ``scaled_dot_product_attention``, causal,
    GQA).  Returns them by case."""
    import torch
    import torch.nn.functional as F
    out = {}
    for case in cases:
        B, S, T, H, Hkv, D = case[:6]
        ring = [_qkv(case, torch.bfloat16, device, seed=50 + i)
                for i in range(4)]
        sdpa = [[t.transpose(1, 2) for t in qkv] for qkv in ring]
        t = {"ms": graph_ms(lambda i: fa.flash_attention(*ring[i % 4]), 8),
             "plain_ms": graph_ms(lambda i: ref.flash_attention(
                 *ring[i % 4]), 4),
             "library_ms": graph_ms(lambda i: F.scaled_dot_product_attention(
                 *sdpa[i % 4], is_causal=True, enable_gqa=True), 8),
             "wrapper_ms": time_ms(lambda i: fa.flash_attention(
                 *ring[i % 4]), 40)}
        lib = F.scaled_dot_product_attention(*sdpa[0], is_causal=True,
                                             enable_gqa=True).transpose(1, 2)
        lib_err = _max_abs_diff(lib, fa.flash_attention(*ring[0]))
        flops = 2 * 2 * S * T * D * H / 2          # QK^T and PV, causal half
        nbytes = 2 * (2 * B * S * H * D + 2 * B * T * Hkv * D)
        t_ops = flops / BF16_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t["bound_ms"] = max(t_ops, t_bytes)
        t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        log(f"flash_attention {case} bf16: device {t['ms']:.6f} ms (plain "
            f"{t['plain_ms']:.6f}, SDPA {t['library_ms']:.6f}, max |SDPA - "
            f"kernel| {lib_err:.3g}), eager wrapper {t['wrapper_ms']:.6f}, "
            f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}: "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
            f"{flops / t['ms'] / 1e9:.1f} TFLOP/s, bound / ms "
            f"{t['bound_ms'] / t['ms']:.4f}")
        out[case] = t
        del ring, sdpa, lib
    return out


# Phase 13 shapes (b, s, h, p, n, chunk): the JAX package's kernel tests
# (tests/test_kernels.py), p = n = 8 at chunk 16, smoke zamba2-2.7b's
# prefill at the serving CLI's default prompt of 32, the widest p and n at
# the longest chunk, and a chunk of 12; then zamba2-2.7b's prefill.
SSD_CASES = (
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 64, 64),
    (1, 64, 8, 16, 32, 64),
    (2, 64, 2, 8, 8, 16),
    (1, 32, 2, 64, 16, 16),
    (1, 512, 2, 128, 128, 256),
    (1, 12, 2, 64, 16, 12),
)
ZAMBA_SSD = (1, 2048, 80, 64, 64, 256)
# bf16 only: the edges of the wgmma route (n not a multiple of 64 under the
# 32-byte swizzle, p = 128 with narrow n, chunks of 64, 128 and 192, b = 2).
SSD_WGMMA_CASES = (
    (1, 512, 3, 64, 80, 128),
    (2, 384, 2, 128, 48, 192),
    (1, 128, 2, 64, 16, 64),
    (1, 192, 2, 64, 112, 64),
    (1, 256, 2, 128, 96, 256),
)
# y as tests/test_kernels.py's _tol states it (atol = rtol), the state as
# its 1e-3; at zamba2's shape each as max|diff| / max|plain|.
SSD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_STATE_TOL = 1e-3


def _ssd_inputs(case, dtype, device, seed):
    """x, dt = softplus(normal), A = -exp(normal) fp32, B, C from a seed."""
    import torch
    import torch.nn.functional as F
    b, s, h, p, n = case[:5]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x = normal(b, s, h, p).to(dtype)
    dt = F.softplus(normal(b, s, h)).to(dtype)
    A = -torch.exp(normal(h))
    return x, dt, A, normal(b, s, n).to(dtype), normal(b, s, n).to(dtype)


def check_mamba2_ssd(ssd, ref, device) -> float:
    """Phase 13: the kernel against its plain version on the card at every
    shape, in fp32 and bf16, from a zero and a random initial state, and
    bitwise repeatable, each case on the route ``ssd.route`` names (logged;
    zamba2's and p = n = 128's bf16 cases on ``wgmma``, both routes run);
    the wgmma route's edge cases and an unaligned bf16 view (``fma``); any
    s through ``ops.mamba2_ssd`` (s = 24 pads to 32, s = 12 runs a chunk of
    12); two halves chained through the final state equal the whole, in
    fp32 and on the wgmma route; zamba2's prefill shape.  Returns the
    largest |kernel - plain| of y at zamba2's shape (bf16)."""
    import torch
    from repro_torch.kernels import ops
    worst = 0.0
    ran = dict.fromkeys(ssd.ROUTES, 0)
    cases = [(c, dt) for dt in ("float32", "bfloat16") for c in SSD_CASES]
    cases += [(c, "bfloat16") for c in SSD_WGMMA_CASES]
    cases += [(ZAMBA_SSD, "float32"), (ZAMBA_SSD, "bfloat16")]
    cases += [(SSD_CASES[1] + ("view",), "bfloat16")]
    for case, dt in cases:
        b, s, h, p, n, chunk = case[:6]
        args = _ssd_inputs(case, getattr(torch, dt), device, seed=sum(case[:6]))
        if case[6:] == ("view",):       # x at an element offset of 1
            buf = torch.empty(args[0].numel() + 1, dtype=args[0].dtype,
                              device=device)
            args = (buf[1:].view(args[0].shape).copy_(args[0]),) + args[1:]
        which = ssd.route(args[0], args[3], chunk, args[4])
        if (dt == "bfloat16" and case in (ZAMBA_SSD, SSD_CASES[5])
                and which != "wgmma"):
            raise AssertionError(f"mamba2_ssd {case}: route {which}, not "
                                 f"wgmma")
        init = torch.randn((b, h, p, n), device=device)
        for ini in (None, init):
            before = dict(ssd.mamba2_ssd.route_launches)
            y, st = ssd.mamba2_ssd(*args, chunk=chunk, init_state=ini)
            y2, st2 = ssd.mamba2_ssd(*args, chunk=chunk, init_state=ini)
            yp, sp = ref.ssd_chunked(*args, chunk=chunk, init_state=ini)
            torch.cuda.synchronize()
            tag = (f"mamba2_ssd {dt} {case} route {which}, "
                   f"{'zero' if ini is None else 'random'} initial state")
            if {k: v - before[k] for k, v in
                    ssd.mamba2_ssd.route_launches.items()} != {
                        k: 2 * (k == which) for k in ssd.ROUTES}:
                raise AssertionError(f"{tag}: launched on another route")
            ran[which] += 2
            if y.dtype != args[0].dtype or y.shape != args[0].shape or \
                    st.dtype != torch.float32 or st.shape != (b, h, p, n):
                raise AssertionError(f"{tag}: results {y.dtype} "
                                     f"{tuple(y.shape)}, {st.dtype} "
                                     f"{tuple(st.shape)}")
            if not (torch.equal(y, y2) and torch.equal(st, st2)):
                raise AssertionError(f"{tag}: two calls differ")
            tol = SSD_TOL[dt]
            ey, es = _max_abs_diff(y, yp), _max_abs_diff(st, sp)
            if case == ZAMBA_SSD:
                ry = ey / float(yp.float().abs().max())
                rs = es / float(sp.abs().max())
                if not (ry <= tol and rs <= SSD_STATE_TOL):
                    raise AssertionError(
                        f"{tag}: max|diff| / max|plain| {ry:.3g} (y, "
                        f"tolerance {tol}), {rs:.3g} (state, "
                        f"{SSD_STATE_TOL})")
                if dt == "bfloat16" and ini is None:
                    worst = ey
                log(f"{tag}: y max|diff| {ey:.3g} = {ry:.3g} of max|plain| "
                    f"(tolerance {tol}), state {es:.3g} = {rs:.3g} "
                    f"({SSD_STATE_TOL}), two calls bitwise equal")
                continue
            if not (torch.allclose(y.float(), yp.float(), atol=tol, rtol=tol)
                    and torch.allclose(st, sp, atol=SSD_STATE_TOL,
                                       rtol=SSD_STATE_TOL)):
                raise AssertionError(f"{tag}: max |kernel - plain| {ey} (y, "
                                     f"atol = rtol = {tol}), {es} (state)")
            log(f"{tag}: max |kernel - plain| y {ey:.3g} (atol = rtol = "
                f"{tol}), state {es:.3g} ({SSD_STATE_TOL}), two calls "
                f"bitwise equal")
    if not all(ran.values()):
        raise AssertionError(f"mamba2_ssd: a route never ran: {ran}")
    log(f"mamba2_ssd launches by route in the checks: {ran}")
    for s in (24, 12):
        args = _ssd_inputs((2, s, 4, 32, 16), torch.float32, device, seed=s)
        before = ssd.mamba2_ssd.launches
        y, st = ops.mamba2_ssd(*args, chunk=16)
        yp, sp = ops.mamba2_ssd(*args, chunk=16, impl="ref")
        torch.cuda.synchronize()
        if ssd.mamba2_ssd.launches != before + 1 or y.shape != yp.shape:
            raise AssertionError(f"ops.mamba2_ssd s={s}: no kernel launch or "
                                 f"shape {tuple(y.shape)}")
        if not (torch.allclose(y, yp, atol=2e-5, rtol=2e-5) and
                torch.allclose(st, sp, atol=1e-3, rtol=1e-3)):
            raise AssertionError(f"ops.mamba2_ssd s={s} chunk 16: kernel "
                                 f"and plain differ")
        log(f"ops.mamba2_ssd s={s} chunk 16: kernel within 2e-5 of plain, "
            f"y {tuple(y.shape)}")
    x, dt, A, B, C = _ssd_inputs((1, 128, 2, 16, 16), torch.float32, device,
                                 seed=3)
    y_full, st_full = ssd.mamba2_ssd(x, dt, A, B, C, chunk=32)
    y1, st1 = ssd.mamba2_ssd(x[:, :64].contiguous(), dt[:, :64].contiguous(),
                             A, B[:, :64].contiguous(),
                             C[:, :64].contiguous(), chunk=32)
    y2, st2 = ssd.mamba2_ssd(x[:, 64:].contiguous(), dt[:, 64:].contiguous(),
                             A, B[:, 64:].contiguous(),
                             C[:, 64:].contiguous(), chunk=32,
                             init_state=st1)
    torch.cuda.synchronize()
    if not (torch.allclose(torch.cat([y1, y2], 1), y_full, atol=2e-5,
                           rtol=2e-5)
            and torch.allclose(st2, st_full, atol=1e-4, rtol=1e-4)):
        raise AssertionError("mamba2_ssd: two chained halves differ from "
                             "the whole")
    log("mamba2_ssd: two halves chained through the final state equal the "
        "whole (2e-5 y, 1e-4 state)")
    x, dt, A, B, C = _ssd_inputs((1, 1024, 4, 64, 64), torch.bfloat16, device,
                                 seed=4)
    y_full, st_full = ssd.mamba2_ssd(x, dt, A, B, C, chunk=256)
    halves = [[t[:, k:k + 512].contiguous() for t in (x, dt, B, C)]
              for k in (0, 512)]
    if any(ssd.route(hx, hB, 256, hC) != "wgmma" for hx, _, hB, hC in halves):
        raise AssertionError("mamba2_ssd: a chained half is off the wgmma "
                             "route")
    (x1, dt1, B1, C1), (x2, dt2, B2, C2) = halves
    y1, st1 = ssd.mamba2_ssd(x1, dt1, A, B1, C1, chunk=256)
    y2, st2 = ssd.mamba2_ssd(x2, dt2, A, B2, C2, chunk=256, init_state=st1)
    torch.cuda.synchronize()
    ey = _max_abs_diff(torch.cat([y1, y2], 1), y_full)
    es = _max_abs_diff(st2, st_full)
    if not (torch.allclose(torch.cat([y1, y2], 1).float(), y_full.float(),
                           atol=2e-2, rtol=2e-2)
            and torch.allclose(st2, st_full, atol=SSD_STATE_TOL,
                               rtol=SSD_STATE_TOL)):
        raise AssertionError(f"mamba2_ssd wgmma: two chained halves differ "
                             f"from the whole (y {ey}, state {es})")
    log(f"mamba2_ssd wgmma bf16: two halves chained through the final state "
        f"equal the whole within 2e-2 (y, max |diff| {ey:.3g}) and "
        f"{SSD_STATE_TOL} (state, {es:.3g})")
    return worst


def time_mamba2_ssd(ssd, ref, device) -> dict:
    """Phase 15: times per call at zamba2's prefill shape, bf16 (a ring of
    four input sets, 88 MB, larger than the 50 MB L2), as in phase 5.  No
    single PyTorch call computes the chunked scan: ``library_ms`` is None.
    The bound counts each input read once and each output written once
    (x, dt, B, C, A, y and the final state; no initial state on the
    prefill path) and the work of the lower triangles: per (chunk, head)
    C B^T and its product with x dt over l(l+1)/2 entries, the carried
    state's term and the state update, 2 FLOP per multiply-add.  The
    ``fma`` route is timed at the same shape too, on x at an element
    offset of 1 (logged only: the served calls take ``wgmma``)."""
    import torch
    b, s, h, p, n, chunk = ZAMBA_SSD
    ring = [_ssd_inputs(ZAMBA_SSD, torch.bfloat16, device, seed=60 + i)
            for i in range(4)]
    views = []
    for x, *rest in ring:
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
        views.append((buf[1:].view(x.shape).copy_(x), *rest))
    if ssd.route(views[0][0], views[0][3], chunk, views[0][4]) != "fma":
        raise AssertionError("mamba2_ssd: the unaligned view is not on fma")
    fma_ms = graph_ms(lambda i: ssd.mamba2_ssd(*views[i % 4], chunk=chunk),
                      8)
    del views
    t = {"ms": graph_ms(lambda i: ssd.mamba2_ssd(*ring[i % 4], chunk=chunk),
                        8),
         "plain_ms": graph_ms(lambda i: ref.ssd_chunked(*ring[i % 4],
                                                        chunk=chunk), 4),
         "wrapper_ms": time_ms(lambda i: ssd.mamba2_ssd(*ring[i % 4],
                                                        chunk=chunk), 40),
         "library_ms": None}
    tri = chunk * (chunk + 1) // 2
    flops = 2 * (tri * n + tri * p + 2 * chunk * p * n) * (s // chunk) * h * b
    nbytes = (2 * (2 * b * s * h * p + b * s * h + 2 * b * s * n)
              + 4 * h + 4 * b * h * p * n)
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t["bound_ms"] = max(t_ops, t_bytes)
    t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"mamba2_ssd {ZAMBA_SSD} bf16, route "
        f"{ssd.route(ring[0][0], ring[0][3], chunk, ring[0][4])}: device "
        f"{t['ms']:.6f} ms (plain {t['plain_ms']:.6f}, no library call), "
        f"eager wrapper {t['wrapper_ms']:.6f}, bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB); "
        f"{flops / t['ms'] / 1e9:.1f} TFLOP/s, bound / ms "
        f"{t['bound_ms'] / t['ms']:.4f}; the fma route at the same shape "
        f"{fma_ms:.6f} ms")
    return t


# Phase 16 shapes (b, s, h, d, chunk): the JAX package's kernel tests
# (tests/test_kernels.py), smoke xlstm-350m's prefill at the serving CLI's
# default prompt of 32 (head dim 128 / 4 = 32, chunk 16), the widest d at
# the longest chunk, and a chunk of 12; then xlstm-350m's prefill.
MLSTM_CASES = (
    (2, 64, 2, 16, 16),
    (1, 128, 4, 32, 64),
    (1, 32, 4, 32, 16),
    (1, 512, 2, 512, 256),
    (1, 12, 2, 64, 12),
)
XLSTM_MLSTM = (1, 2048, 4, 512, 256)
# The bf16 wgmma route's edges: d = 64 (column tiles of 64), 128, 192, 448
# and 512; chunks of one to four 64-row slabs; s of one chunk and of
# several; b = 2; one and four heads.
MLSTM_WGMMA_CASES = (
    (2, 64, 1, 64, 64),
    (2, 512, 4, 64, 64),
    (2, 128, 4, 128, 128),
    (2, 1024, 1, 128, 128),
    (2, 384, 2, 192, 192),
    (2, 512, 2, 448, 128),
    (2, 256, 1, 512, 256),
    (2, 2048, 4, 512, 256),
)
# tests/test_kernels.py's bounds: y (atol = rtol), C and n (atol; rtol
# 2e-2), m; at xlstm's shape each as max|diff| / max|plain|.
MLSTM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MLSTM_STATE_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
MLSTM_M_TOL = 1e-3
XLSTM_PARAMS = 491_908_240


def _mlstm_inputs(case, dtype, device, seed):
    """q, k ~ N(0, 0.25), v ~ N(0, 1) in ``dtype``; fp32 gate logits
    i ~ N(0, 1), f ~ N(2, 1) (tests/test_kernels.py's)."""
    import torch
    b, s, h, d = case[:4]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return ((normal(b, s, h, d) * 0.5).to(dtype),
            (normal(b, s, h, d) * 0.5).to(dtype), normal(b, s, h, d).to(dtype),
            normal(b, s, h), normal(b, s, h) + 2.0)


def check_mlstm_chunk(mk, ref, device) -> float:
    """Phase 16: the kernel against its plain version on the card at every
    shape, in fp32 and bf16, and bitwise repeatable, each case on the route
    ``mk.route`` names (logged; xlstm's bf16 shape on ``wgmma``, both
    routes run); the wgmma route's edge cases; an unaligned bf16 view of q
    (``fma``, which the wrapper refuses: no launch); s = 24 through
    ``ops.mlstm_chunked`` (padding to the chunk of 16); xlstm's prefill
    shape.  Returns the largest |kernel - plain| of y at xlstm's shape
    (bf16)."""
    import torch
    from repro_torch.kernels import ops
    worst = 0.0
    ran = dict.fromkeys(mk.ROUTES, 0)
    cases = [(c, dt) for dt in ("float32", "bfloat16") for c in MLSTM_CASES]
    cases += [(c, "bfloat16") for c in MLSTM_WGMMA_CASES]
    cases += [(XLSTM_MLSTM, "float32"), (XLSTM_MLSTM, "bfloat16")]
    for case, dt in cases:
        b, s, h, d, chunk = case
        args = _mlstm_inputs(case, getattr(torch, dt), device, seed=sum(case))
        which = mk.route(args[0], chunk, args[1], args[2])
        if dt == "bfloat16" and case == XLSTM_MLSTM and which != "wgmma":
            raise AssertionError(f"mlstm_chunk {case}: route {which}, not "
                                 f"wgmma")
        before = dict(mk.mlstm_chunk.route_launches)
        y, st = mk.mlstm_chunk(*args, chunk=chunk)
        y2, st2 = mk.mlstm_chunk(*args, chunk=chunk)
        yp, sp = ref.mlstm_chunked(*args, chunk=chunk)
        torch.cuda.synchronize()
        tag = f"mlstm_chunk {dt} {case} route {which}"
        if {k: n - before[k] for k, n in
                mk.mlstm_chunk.route_launches.items()} != {
                    k: 2 * (k == which) for k in mk.ROUTES}:
            raise AssertionError(f"{tag}: launched on another route")
        ran[which] += 2
        shapes = ((b, h, d, d), (b, h, d), (b, h))
        if y.dtype != args[0].dtype or y.shape != args[0].shape or any(
                t.dtype != torch.float32 or t.shape != shp
                for t, shp in zip(st, shapes)):
            raise AssertionError(f"{tag}: results {y.dtype} "
                                 f"{tuple(y.shape)}, "
                                 f"{[tuple(t.shape) for t in st]}")
        if not (torch.equal(y, y2) and
                all(torch.equal(a, c) for a, c in zip(st, st2))):
            raise AssertionError(f"{tag}: two calls differ")
        tol, stol = MLSTM_TOL[dt], MLSTM_STATE_TOL[dt]
        ey = _max_abs_diff(y, yp)
        eC, en, em = (_max_abs_diff(a, c) for a, c in zip(st, sp))
        if case == XLSTM_MLSTM:
            rel = [e / float(t.float().abs().max())
                   for e, t in ((ey, yp), (eC, sp[0]), (en, sp[1]),
                                (em, sp[2]))]
            if not (rel[0] <= tol and rel[1] <= stol and rel[2] <= stol
                    and rel[3] <= MLSTM_M_TOL):
                raise AssertionError(
                    f"{tag}: max|diff| / max|plain| {rel[0]:.3g} (y, "
                    f"tolerance {tol}), {rel[1]:.3g} (C), {rel[2]:.3g} (n; "
                    f"{stol}), {rel[3]:.3g} (m, {MLSTM_M_TOL})")
            if dt == "bfloat16":
                worst = ey
            log(f"{tag}: max|diff| / max|plain| y {ey:.3g} = {rel[0]:.3g} "
                f"(tolerance {tol}), C {eC:.3g} = {rel[1]:.3g}, n {en:.3g} "
                f"= {rel[2]:.3g} ({stol}), m {em:.3g} = {rel[3]:.3g} "
                f"({MLSTM_M_TOL}), two calls bitwise equal")
            continue
        ok = (torch.allclose(y.float(), yp.float(), atol=tol, rtol=tol)
              and torch.allclose(st[0], sp[0], atol=stol, rtol=2e-2)
              and torch.allclose(st[1], sp[1], atol=stol, rtol=2e-2)
              and torch.allclose(st[2], sp[2], atol=MLSTM_M_TOL,
                                 rtol=MLSTM_M_TOL))
        if not ok:
            raise AssertionError(f"{tag}: max |kernel - plain| {ey} (y, atol "
                                 f"= rtol = {tol}), C {eC}, n {en} ({stol}), "
                                 f"m {em}")
        log(f"{tag}: max |kernel - plain| y {ey:.3g} (atol = rtol = {tol}), "
            f"C {eC:.3g}, n {en:.3g} ({stol}), m {em:.3g}, two calls bitwise "
            f"equal")
    if not all(ran.values()):
        raise AssertionError(f"mlstm_chunk: a route never ran: {ran}")
    log(f"mlstm_chunk launches by route in the checks: {ran}")
    q, k, v, ig, fg = _mlstm_inputs((1, 512, 2, 128), torch.bfloat16, device,
                                    seed=17)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=device)
    qv = buf[1:].view(q.shape).copy_(q)     # q at an element offset of 1
    before = dict(mk.mlstm_chunk.route_launches)
    try:
        mk.mlstm_chunk(qv, k, v, ig, fg, chunk=128)
    except ValueError as err:
        refused = str(err)
    else:
        raise AssertionError("mlstm_chunk: an unaligned bf16 view ran")
    if mk.route(qv, 128, k, v) != "fma" or \
            mk.mlstm_chunk.route_launches != before:
        raise AssertionError("mlstm_chunk: the unaligned bf16 view is not on "
                             "fma, or launched")
    log(f"mlstm_chunk bf16 q at an element offset of 1: route fma, refused "
        f"before any launch ({refused})")
    args = _mlstm_inputs((2, 24, 4, 32), torch.float32, device, seed=24)
    before = mk.mlstm_chunk.launches
    y, st = ops.mlstm_chunked(*args, chunk=16)
    yp, sp = ops.mlstm_chunked(*args, chunk=16, impl="ref")
    torch.cuda.synchronize()
    if mk.mlstm_chunk.launches != before + 1 or y.shape != yp.shape:
        raise AssertionError(f"ops.mlstm_chunked s=24: no kernel launch or "
                             f"shape {tuple(y.shape)}")
    if not (torch.allclose(y, yp, atol=2e-5, rtol=2e-5) and
            all(torch.allclose(a, c, atol=2e-4, rtol=2e-2)
                for a, c in zip(st, sp))):
        raise AssertionError("ops.mlstm_chunked s=24 chunk 16: kernel and "
                             "plain differ")
    log(f"ops.mlstm_chunked s=24 chunk 16 (padded to 32): kernel within 2e-5 "
        f"of plain, y {tuple(y.shape)}")
    return worst


def _mlstm_fma(mk, args, chunk):
    """One launch of the ``fma`` route on bf16 ``args``, through the C entry
    point's route code: the wrapper sends an aligned bf16 call at xlstm's
    shape to ``wgmma``, so this is how the other route is timed there."""
    import torch
    from repro_torch.kernels import build
    q, k, v, ig, fg = args
    b, s, h, d = q.shape
    y = torch.empty_like(q)
    out = [torch.empty(shape, dtype=torch.float32, device=q.device)
           for shape in ((b, h, d, d), (b, h, d), (b, h))]
    err = build.load("mlstm_chunk").mlstm_chunk_fwd(
        *(t.data_ptr() for t in (q, k, v, ig, fg, y, *out)), b, s, h, d,
        chunk, 1, mk.ROUTES.index("fma"), None, None,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "mlstm_chunk fma")
    return y


def time_mlstm_chunk(mk, ref, device) -> dict:
    """Phase 18: times per call at xlstm's prefill shape, bf16 (a ring of
    four input sets, 101 MB, larger than the 50 MB L2), as in phase 5, on
    the route the wrapper takes there (``wgmma``).  No single PyTorch call
    computes the chunked mLSTM: ``library_ms`` is None.  The bound counts
    each input read once and each output written once (q, k, v, the two
    gates, y and the final C, n, m) and the work of the lower triangles:
    per (head, chunk) q k^T and S v over l(l+1)/2 entries, q C and the k^T
    v update, 2 FLOP per multiply-add.  The ``fma`` route is timed at the
    same shape too, through the C entry point (logged only: the served
    calls take ``wgmma``)."""
    import torch
    b, s, h, d, chunk = XLSTM_MLSTM
    ring = [_mlstm_inputs(XLSTM_MLSTM, torch.bfloat16, device, seed=70 + i)
            for i in range(4)]
    which = mk.route(ring[0][0], chunk, ring[0][1], ring[0][2])
    if which != "wgmma":
        raise AssertionError(f"mlstm_chunk {XLSTM_MLSTM}: route {which}")
    fma_ms = graph_ms(lambda i: _mlstm_fma(mk, ring[i % 4], chunk), 8)
    t = {"ms": graph_ms(lambda i: mk.mlstm_chunk(*ring[i % 4], chunk=chunk),
                        8),
         "plain_ms": graph_ms(lambda i: ref.mlstm_chunked(*ring[i % 4],
                                                          chunk=chunk), 4),
         "wrapper_ms": time_ms(lambda i: mk.mlstm_chunk(*ring[i % 4],
                                                        chunk=chunk), 40),
         "library_ms": None}
    tri = chunk * (chunk + 1) // 2
    flops = 2 * (2 * tri * d + 2 * chunk * d * d) * (s // chunk) * h * b
    nbytes = (2 * 4 * b * s * h * d + 4 * 2 * b * s * h
              + 4 * (b * h * d * d + b * h * d + b * h))
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t["bound_ms"] = max(t_ops, t_bytes)
    t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    log(f"mlstm_chunk {XLSTM_MLSTM} bf16, route {which}: device "
        f"{t['ms']:.6f} ms (plain {t['plain_ms']:.6f}, no library call), "
        f"eager wrapper {t['wrapper_ms']:.6f}, bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB); "
        f"{flops / t['ms'] / 1e9:.1f} TFLOP/s, bound / ms "
        f"{t['bound_ms'] / t['ms']:.4f}; the fma route at the same shape "
        f"{fma_ms:.6f} ms")
    return t


# Phase 19 shapes (E, C, K, N): the JAX package's kernel tests
# (tests/test_kernels.py), ragged C, K and N (C down to 2, K = 1, N = 5),
# then olmoe-1b-7b's expert products at decode (C = 8 slots an expert) and
# at a 2048-token prefill (C = cap = 320): wg/wu (d 2048 -> ff 1024) and wd
# (ff 1024 -> d 2048).
GMM_CASES = (
    (4, 64, 32, 48), (8, 128, 128, 256), (2, 32, 64, 32),
    (3, 13, 40, 24), (3, 2, 40, 24), (2, 2, 7, 5), (5, 1, 1, 3),
    (2, 17, 33, 130),
)
OLMOE_GMM_DECODE = ((64, 8, 2048, 1024), (64, 8, 1024, 2048))
OLMOE_GMM_PREFILL = ((64, 320, 2048, 1024), (64, 320, 1024, 2048))
# The edges of the wgmma route's tiles (bf16, K and N multiples of 8): C
# across the decode tile's 8 rows of x, the prefill tile's 160 (159-161,
# 319-321 around olmoe's cap) and 64-row steps, K and N that are not
# multiples of the 64-deep stages or of the 128- and 256-column tiles
# of w, one expert.
GMM_EDGE_CASES = tuple((2, C, 72, 200) for C in
                       (1, 8, 9, 63, 64, 65, 159, 160, 161, 319, 320,
                        321)) + (
    (3, 65, 72, 200), (2, 320, 1032, 136), (1, 320, 2048, 1024),
    (1, 8, 2048, 1024))
# x and w as views into flat buffers at an offset of `offset` elements:
# 8 (16 bytes: still the wgmma route) and 1 (2 bytes: the mma_sync route).
GMM_VIEW_CASES = (((3, 65, 72, 200), 8), ((4, 8, 64, 136), 8),
                  ((3, 65, 72, 200), 1), ((4, 8, 64, 136), 1))
GMM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
OLMOE_PARAMS = 6_919_096_320
# Each MoE block's three expert products, in prefill and in each of the
# SERVE_GEN - 1 decode steps of a request: 3 x 16 x 32.
OLMOE_GMM_PER_REQUEST = 3 * 16 * SERVE_GEN
MOE_BLOCK_TOL = 2e-2


def _gmm_inputs(case, dtype, device, seed):
    import torch
    E, C, K, N = case
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return (torch.randn((E, C, K), generator=gen, device=device).to(dtype),
            torch.randn((E, K, N), generator=gen, device=device).to(dtype))


def _gmm_view_inputs(case, offset, device, seed):
    """bf16 x and w of ``case`` as contiguous views ``offset`` elements
    into flat buffers."""
    import torch
    E, C, K, N = case
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bx = torch.randn(E * C * K + offset, generator=gen, device=device)
    bw = torch.randn(E * K * N + offset, generator=gen, device=device)
    return (bx.to(torch.bfloat16)[offset:].view(E, C, K),
            bw.to(torch.bfloat16)[offset:].view(E, K, N))


def check_moe_gmm(mg, ref, device) -> float:
    """Phase 19: the kernel against its plain version on the card at every
    shape, in fp32 and bf16 (and the wgmma route's tile edges and views
    in bf16), and bitwise repeatable; each case's route is logged, the
    served bf16 shapes must take the wgmma routes and every bf16 route
    must run.  Returns the largest |kernel - plain| at olmoe's first
    prefill shape (bf16)."""
    import torch
    worst = 0.0
    olmoe = OLMOE_GMM_DECODE + OLMOE_GMM_PREFILL
    routes = set()
    runs = [(dt, case, None) for dt in ("float32", "bfloat16")
            for case in GMM_CASES + olmoe]
    runs += [("bfloat16", case, None) for case in GMM_EDGE_CASES]
    runs += [("bfloat16", case, off) for case, off in GMM_VIEW_CASES]
    for dt, case, offset in runs:
        if offset is None:
            x, w = _gmm_inputs(case, getattr(torch, dt), device,
                               seed=sum(case))
        else:
            x, w = _gmm_view_inputs(case, offset, device, sum(case))
        route = mg.route(x, w)
        routes.add(route)
        got = mg.moe_gmm(x, w)
        again = mg.moe_gmm(x, w)
        want = ref.moe_gmm(x, w)
        torch.cuda.synchronize()
        tag = f"moe_gmm {dt} {case} route {route}" + (
            "" if offset is None else f", views at offset {offset}")
        E, C, K, N = case
        if dt == "bfloat16" and case in olmoe and route != (
                "wgmma_decode" if C <= mg.DECODE_ROWS else "wgmma"):
            raise AssertionError(f"{tag}: a served shape off the wgmma "
                                 f"route")
        if got.dtype != x.dtype or got.shape != (E, C, N):
            raise AssertionError(f"{tag}: result {got.dtype} "
                                 f"{tuple(got.shape)}")
        if not torch.equal(got, again):
            raise AssertionError(f"{tag}: two calls differ")
        tol = GMM_TOL[dt]
        err = _max_abs_diff(got, want)
        if case in olmoe:
            rel = err / float(want.float().abs().max())
            if not rel <= tol:
                raise AssertionError(f"{tag}: max|diff| / max|plain| "
                                     f"{rel:.3g} beyond {tol}")
            if case == OLMOE_GMM_PREFILL[0] and dt == "bfloat16":
                worst = err
            log(f"{tag}: max|diff| / max|plain| {err:.3g} = {rel:.3g} "
                f"(tolerance {tol}), two calls bitwise equal")
            continue
        if not torch.allclose(got.float(), want.float(), atol=tol,
                              rtol=tol):
            raise AssertionError(f"{tag}: max |kernel - plain| {err} "
                                 f"beyond atol = rtol = {tol}")
        log(f"{tag}: max |kernel - plain| {err:.3g} (atol = rtol = "
            f"{tol}), two calls bitwise equal")
    missing = set(mg.ROUTES) - routes
    if missing:
        raise AssertionError(f"moe_gmm: routes {sorted(missing)} never ran")
    return worst


def _moe_inputs(model, toks, **impls):
    """Each MoE block of ``model`` and its input in request 0's prefill
    (on ``impls``), in order, with the prefill logits."""
    from repro_torch.models import layers as L
    seen, hooks = [], []
    for unit in model.units:
        for blk in unit.blocks.values():
            if isinstance(blk, L.MoE):
                hooks.append(blk.register_forward_pre_hook(
                    lambda mod, args: seen.append((mod, args[0].clone()))))
    try:
        logits = _prefill_logits(model, toks, **impls)
    finally:
        for h in hooks:
            h.remove()
    return logits, seen


def compare_moe(arch, cfg, model, kernels, plain, device, stream) -> dict:
    """The plain-version check of a MoE model (phase 20).  The router's
    top-k is discontinuous, so a one-ulp difference in a block's input can
    swap an expert and move that token's output by O(1).  So: request 0's
    prefill runs on both paths; the (layer, token) top-8 sets that differ
    between them are counted; every MoE block is held alone on the plain
    path's input to it (the router then sees identical input: identical
    expert choices and a bitwise-equal aux loss, and y within
    ``MOE_BLOCK_TOL`` of its largest value); then :func:`compare_with_plain`
    holds the whole model, in bf16 if its logit gate holds there, else on
    an fp32 copy of the weights (with request 0's kernel-path stream
    served on that copy)."""
    import torch
    toks = _request0_prompt(cfg, model, device)
    lk, seen_k = _moe_inputs(model, toks)
    lr, seen_r = _moe_inputs(model, toks, **plain)
    flips, n_sets, worst = 0, 0, 0.0
    with torch.inference_mode():
        for (blk, xk), (_, xr) in zip(seen_k, seen_r):
            ek = torch.sort(blk.route(xk)[1], dim=-1).values
            er = torch.sort(blk.route(xr)[1], dim=-1).values
            flips += int((ek != er).any(dim=-1).sum())
            n_sets += ek.shape[0] * ek.shape[1]
            yk, ak = blk(xr)
            yr, ar = blk(xr, impl="ref")
            if not torch.equal(ak, ar):
                raise AssertionError(f"{arch}: a MoE block's router gave "
                                     f"different aux losses on one input")
            worst = max(worst, float((yk.float() - yr.float()).abs().max()
                                     / yr.float().abs().max()))
    n_blocks = len(seen_r)
    del seen_k, seen_r
    if not worst <= MOE_BLOCK_TOL:
        raise AssertionError(f"{arch}: a MoE block alone on the plain path's "
                             f"input differs from its plain version by "
                             f"{worst:.4g} of its largest output")
    scale = float(lr.abs().max())
    rel = float((lk - lr).abs().max()) / scale
    log(f"{arch} (bfloat16), request 0's prefill: {flips} of {n_sets} "
        f"(layer, token) top-{cfg.top_k} expert sets differ between the "
        f"kernel and plain paths; logits max |kernel - plain| = {rel:.4g} of "
        f"max |logit| {scale:.4g}; each of the {n_blocks} MoE blocks alone "
        f"on the plain path's input: identical expert "
        f"choices, kernel within {worst:.4g} of its plain version's largest "
        f"output (tolerance {MOE_BLOCK_TOL})")
    out = {"routing_flips": flips, "routing_sets": n_sets,
           "bf16_logit_rel_diff": rel, "block_alone_rel_err": worst}
    if rel <= SERVE_LOGIT_RTOL:
        out["whole_model_dtype"] = cfg.dtype
        out.update(compare_with_plain(arch, cfg, model, kernels, plain,
                                      device, stream))
        return out
    log(f"{arch}: the bf16 logit gate does not hold ({rel:.4g} > "
        f"{SERVE_LOGIT_RTOL}); the whole model is held on an fp32 copy")
    torch.cuda.reset_peak_memory_stats()
    wide_cfg, wide = _wide_copy(cfg, model, "float32", device)
    wide_stream = _serve_request0(wide_cfg, wide, device)
    out["whole_model_dtype"] = "float32"
    out.update(compare_with_plain(arch, wide_cfg, wide, kernels, plain,
                                  device, wide_stream))
    out["fp32_copy_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"{arch}: fp32 copy peak allocated {out['fp32_copy_peak_gib']:.2f} "
        f"GiB")
    del wide
    return out


def time_moe_gmm(mg, ref, device) -> dict:
    """Phase 21: times per call at olmoe's two prefill and two decode
    shapes, bf16, as in phase 5 (two input sets a shape: the
    weights alone, 268 MB, exceed the 50 MB L2, so every launch reads cold
    data), beside one PyTorch call computing the same function
    (``library_ms``: ``torch.bmm``, bf16 in and out).  The bound counts x
    and w read once and the output written once, and 2 FLOP per
    multiply-add of every expert's every slot (the reference computes the
    zero rows of unfilled slots too).  Returns them by shape."""
    import torch
    out = {}
    for case in OLMOE_GMM_PREFILL + OLMOE_GMM_DECODE:
        E, C, K, N = case
        ring = [_gmm_inputs(case, torch.bfloat16, device, seed=80 + i)
                for i in range(2)]
        t = {"ms": graph_ms(lambda i: mg.moe_gmm(*ring[i % 2]), 8),
             "plain_ms": graph_ms(lambda i: ref.moe_gmm(*ring[i % 2]), 4),
             "library_ms": graph_ms(lambda i: torch.bmm(*ring[i % 2]), 8),
             "wrapper_ms": time_ms(lambda i: mg.moe_gmm(*ring[i % 2]), 40)}
        lib_err = _max_abs_diff(torch.bmm(*ring[0]), mg.moe_gmm(*ring[0]))
        flops = 2 * E * C * K * N
        nbytes = 2 * (E * C * K + E * K * N + E * C * N)
        t_ops = flops / BF16_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t["bound_ms"] = max(t_ops, t_bytes)
        t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        log(f"moe_gmm {case} bf16, route {mg.route(*ring[0])}: device "
            f"{t['ms']:.6f} ms (plain {t['plain_ms']:.6f}, torch.bmm "
            f"{t['library_ms']:.6f}, kernel / bmm "
            f"{t['ms'] / t['library_ms']:.3f}, max |bmm - kernel| "
            f"{lib_err:.3g}), eager wrapper {t['wrapper_ms']:.6f}, bound "
            f"{t['bound_ms']:.6f} ms ({t['bound_by']}: {flops / 1e9:.3f} "
            f"GFLOP, {t_ops:.6f} ms; {nbytes / 1e6:.3f} MB, "
            f"{t_bytes:.6f} ms), bound / ms "
            f"{t['bound_ms'] / t['ms']:.4f}, {flops / t['ms'] / 1e9:.1f} "
            f"TFLOP/s")
        out[case] = t
        del ring
    return out


def freed(arch: str, before: int) -> None:
    """Fail unless the memory a served model held is free again: within 1
    GiB of what was allocated before it was built, with no collection by
    the cyclic garbage collector (nothing but reference counts may hold a
    model once its path returns)."""
    import torch
    torch.cuda.synchronize()
    now = torch.cuda.memory_allocated()
    if now - before > 2**30:
        raise AssertionError(f"{arch}: {(now - before) / 2**30:.2f} GiB still "
                             f"allocated after its path returned")
    log(f"{arch}: freed, {now / 2**30:.2f} GiB allocated")
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.bench import gauss_seidel as gs
    from repro_torch.kernels import build, collective_stages as stages, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import mlstm_chunk as mk
    from repro_torch.kernels import moe_gmm as mg
    device = torch.device("cuda")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    outputs = build.build()
    log(f"build: {time.perf_counter() - t0:.3f} s")
    for name, out in outputs.items():
        log(f"nvcc {name}:\n{out.strip()}")

    max_err = check_gs_stencil(stages, ref, device)
    check_ops_views(device)
    iwait_probe(stages, ref, device)
    per_it, launches = main_path(gs, stages, device)
    t = time_gs_stencil(stages, ref, device)
    log(f"gs_stencil 1024x1024 fp32: device {t['ms']:.6f} ms/call (plain "
        f"{t['plain_ms']:.6f}, copy_ of the block {t['copy_ms']:.6f}), eager "
        f"wrapper {t['wrapper_ms']:.6f} ms/call (plain "
        f"{t['plain_eager_ms']:.6f}), bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}), bound / ms {t['bound_share']:.4f}")
    for version, s in per_it.items():
        log(f"wall {version}: {s:.6f} s/iteration")
    torch.cuda.empty_cache()

    level_a_tensors(device)
    stage_err = check_stage_kernels(stages, ref, device)
    sync_s, stage_launches = level_b_main_path(stages, device)
    stage_t = time_stage_kernels(stages, ref, device)
    for label, s in sync_s.items():
        log(f"wall sync_grads {label}: {s:.6f} s")
    torch.cuda.empty_cache()

    flash_err = check_flash_attention(fa, ref, device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    serve = serving_main_path(
        "granite-3-2b", GRANITE_PARAMS, (40, 2048, 32, 8),
        {"flash_attention": (fa.flash_attention, 40)},
        {"attn_impl": "ref"}, device)
    freed("granite-3-2b", before)
    flash_t = time_flash_attention(fa, ref, device,
                                   (GRANITE_PREFILL, ZAMBA_PREFILL))

    ssd_err = check_mamba2_ssd(ssd, ref, device)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    zserve = serving_main_path(
        "zamba2-2.7b", ZAMBA_PARAMS, (54, 2560, 32, 32),
        {"mamba2_ssd": (ssd.mamba2_ssd, 54),
         "flash_attention": (fa.flash_attention, 9)},
        {"attn_impl": "ref", "ssd_impl": "ref"}, device)
    freed("zamba2-2.7b", before)
    ssd_t = time_mamba2_ssd(ssd, ref, device)

    mlstm_err = check_mlstm_chunk(mk, ref, device)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    xserve = serving_main_path(
        "xlstm-350m", XLSTM_PARAMS, (24, 1024, 4, 4),
        {"mlstm_chunk": (mk.mlstm_chunk, 18)}, {"mlstm_impl": "ref"},
        device, compare=compare_chaotic, routes={"mlstm_chunk": "wgmma"})
    freed("xlstm-350m", before)
    mlstm_t = time_mlstm_chunk(mk, ref, device)

    gmm_err = check_moe_gmm(mg, ref, device)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    oserve = serving_main_path(
        "olmoe-1b-7b", OLMOE_PARAMS, (16, 2048, 16, 16),
        {"moe_gmm": (mg.moe_gmm, OLMOE_GMM_PER_REQUEST),
         "flash_attention": (fa.flash_attention, 16)},
        {"attn_impl": "ref", "moe_impl": "ref"}, device,
        compare=compare_moe)
    freed("olmoe-1b-7b", before)
    gmm_t = time_moe_gmm(mg, ref, device)
    flash_t.update(time_flash_attention(fa, ref, device, (OLMOE_PREFILL,)))
    for arch, run in (("granite-3-2b", serve), ("zamba2-2.7b", zserve),
                      ("xlstm-350m", xserve), ("olmoe-1b-7b", oserve)):
        log(f"serve {arch}, one request alone: prefill "
            f"{run['prefill_ms']:.3f} ms, decode "
            f"{run['decode_ms_per_token']:.3f} ms/token")
        for leg, v in run["legs"].items():
            log(f"serve {arch} {leg}: {v['tokens_per_s']:.3f} tokens/s, p50 "
                f"{v['p50_ms']:.3f} ms, p99 {v['p99_ms']:.3f} ms, wall "
                f"{v['wall_s']:.3f} s, peak allocated {v['peak_gib']:.2f} "
                f"GiB")

    kernels = [{
        "name": "gs_stencil", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gs_stencil.cu",
        "replaces": "src/repro/kernels/collective_stages.py:200",
        "launches": launches, "max_abs_err": max_err, **t,
        "library_ms": None,
        "design": "one launch, last-CTA residual, 16-byte rows",
    }]
    for name, line in (("fused_combine", 82), ("quantize_wire", 135),
                       ("dequantize_wire", 162)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/collective_stages.cu",
            "replaces": f"src/repro/kernels/collective_stages.py:{line}",
            "launches": stage_launches[name],
            "max_abs_err": stage_err[name],
            **stage_t[name]})
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:98",
        "launches": sum(run["launches"]["flash_attention"]
                        for run in (serve, zserve, oserve)),
        "max_abs_err": flash_err, **flash_t[GRANITE_PREFILL],
        "design": "wgmma+tma"})
    kernels.append({
        "name": "mamba2_ssd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd.py:79",
        "launches": zserve["launches"]["mamba2_ssd"], "max_abs_err": ssd_err,
        **ssd_t, "design": "wgmma+tma"})
    kernels.append({
        "name": "mlstm_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk.py:90",
        "launches": xserve["launches"]["mlstm_chunk"],
        "max_abs_err": mlstm_err, **mlstm_t, "design": "wgmma+tma"})
    kernels.append({
        "name": "moe_gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:48",
        "launches": oserve["launches"]["moe_gmm"], "max_abs_err": gmm_err,
        **gmm_t[OLMOE_GMM_PREFILL[0]]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
