"""Gradient-synchronisation schedule benchmark — the port of
``benchmarks/overlap_bench.py`` (Level-B TAMPI adaptation), plus Level-B
gradient sync at full model size on logical ranks.

:func:`bench` is the reference's bench on the port.  It compares the three
gradient-synchronisation schedules — ``fused`` (fork-join analogue),
``bucketed`` (interop analogue) and ``sentinel`` (artificial
serialisation) — on a real train step
(``runtime.steps.build_train_step_manual`` over an ``(8, 1)`` ``("data",
"model")`` logical mesh), then runs the hierarchical two-axis allreduce
against the flat ring and the native psum, the fused-vs-unfused stage legs
(the hand-written stage and stencil kernels on the card), the flat ring lowered with and without the stage tier, the
inter-axis butterfly, the Level-A executors, the polling-vs-continuation
progress leg and the disabled tracer's cost.  Every row carries its
measured seconds, and the legs with a schedule carry the α-β prediction
under the NOMINAL constants below and the linear cost features —
critical-path rounds ``R``, one-port wire bytes ``W``, one-port combine
bytes ``V`` — so ``tools/calibrate.py`` fits α/β/γ from the report
unchanged.  The reference's hard asserts are kept with their thresholds.

The reference counts collectives in StableHLO text; the port reads the
logical mesh's own counters instead, under keys named for what they
count: ``ppermute_calls`` (``coll_calls["ppermute"]`` per rank) stands
for ``collective_permutes``, ``reductions`` (``psum`` calls per rank)
for ``all_reduces``, and ``token_waits`` (sentinel waits per rank) for
``barriers``
(``optimization_barrier``).  Each equals what :func:`expected_counts`
derives, or the bench fails.

The other half of the module (:func:`run_sync`, :func:`profile_sync`) is
the twin of the lowered-stage legs at full size: the gradient tree of
hubert-xlarge (944,611,840 parameters, 13 leaves) synchronised across
``n_ranks`` logical ranks on one device by
:func:`repro_torch.core.overlap.sync_grads` with any schedule, stage tier
and wire dtype.

Entry points default to the CUDA device and raise without it; pass
``device="cpu"`` for the CPU, where every kernel takes its plain version.
On the card::

    PYTHONPATH=src python -m repro_torch.bench.overlap [--smoke]
    PYTHONPATH=src python -m repro_torch.bench.overlap --obs [--smoke]
    PYTHONPATH=src python -m repro_torch.bench.overlap --mode fused

(the whole bench, writing ``BENCH_overlap_torch.json``; the tracer
sentinel alone; one profiled ring ``sync_grads``).  On the CPU:
``bench(smoke=True, device="cpu")``, or ``run_sync("bucketed",
device="cpu", shapes=[("w", (64, 17), torch.float32)],
bucket_bytes=1024)``.

CSV: name,us_per_call,derived
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import pathlib
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import configs, optim
from ..core import lowering, schedule as schedule_ir, simulate, tac
from ..core.collectives import (Collectives, CollectiveHandle,
                                ProgressEngine, _Machine)
from ..core.continuations import ContinuationEngine
from ..core.mesh import LogicalMesh, resolve_device
from ..core.overlap import (DEFAULT_BUCKET_BYTES, _make_buckets,
                            sync_grads, tree_flatten, tree_unflatten)
from ..kernels import collective_stages as stages
from ..kernels import ops as kernel_ops
from ..kernels import ref as kernel_ref

# Nominal host-interconnect model for the predicted times (per-message
# latency, seconds per byte on the wire, combine seconds per byte).
ALPHA, BETA, GAMMA = 5e-6, 1e-9, 2.5e-10
REF_RANKS = 8               # predicted times quoted for an 8-way DP mesh
INTER, INTRA = 2, 4         # the two-axis (pod × data) bench grid


def features(sched: schedule_ir.Schedule, size: float) -> dict:
    """Linear α-β(-γ) cost features of one schedule at one payload size:
    ``cost(α, β, size, γ) ≈ α·rounds + β·wire_bytes + γ·combine_bytes``
    with each term read off the DAG in isolation (the linear form
    ``tools/calibrate.py`` fits)."""
    return {"rounds": sched.cost(1.0, 0.0, 0.0),
            "wire_bytes": sched.cost(0.0, 1.0, size),
            "combine_bytes": sched.cost(0.0, 0.0, size, gamma=1.0)}


def _sum_features(fs) -> dict:
    out = {"rounds": 0.0, "wire_bytes": 0.0, "combine_bytes": 0.0}
    for f in fs:
        for k in out:
            out[k] += f[k]
    return out


def predict(mode: str, leaf_bytes: list, bucket_bytes: int,
            n: int = REF_RANKS) -> dict:
    """α-β predicted seconds for one grad-sync under a given schedule.

    Buckets come from the same greedy bucketing the real step uses
    (``core.overlap._make_buckets`` over the per-leaf wire bytes), each
    bucket's algorithm and segment count from ``schedule.best_schedule``;
    the mode decides how bucket costs compose: one fused node, overlapped
    buckets (max) or sentinel-serialised buckets (sum), and the features
    likewise (the argmax bucket's, or the sum)."""
    total = sum(leaf_bytes)
    if mode == "fused":
        bucket_sizes = [total]
    else:
        buckets = _make_buckets(leaf_bytes, bucket_bytes)
        bucket_sizes = [sum(leaf_bytes[i] for i in b) for b in buckets]
    costs, feats, algs, segs = [], [], set(), set()
    for sz in bucket_sizes:
        sched = schedule_ir.best_schedule("allreduce", n, sz,
                                          alpha=ALPHA, beta=BETA,
                                          gamma=GAMMA)
        costs.append(sched.cost(ALPHA, BETA, sz, gamma=GAMMA))
        feats.append(features(sched, sz))
        algs.add(sched.algorithm)
        segs.add(sched.segments)
    if mode == "sentinel":
        cost, feat = sum(costs), _sum_features(feats)
    else:
        cost = max(costs)
        feat = feats[costs.index(cost)]
    return {"predicted_s": cost, "features": feat,
            "algorithms": sorted(algs),
            "segments": sorted(segs), "n_buckets": len(bucket_sizes),
            "bucket_bytes_max": max(bucket_sizes), "ref_ranks": n}


N_BATCHES = 5       # timing batches per leg; the median batch is reported


def _median(samples) -> float:
    return sorted(samples)[len(samples) // 2]


def _synchronize(device: Optional[torch.device]) -> None:
    """Wait for every stream of ``device`` (all logical ranks' streams);
    nothing on the CPU or for a host leg (``None``)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_call(fn, arg, reps: int,
               device: Optional[torch.device] = None) -> float:
    """Median of ``N_BATCHES`` timed batches of ``reps`` calls each, after
    one untimed warm-up call; each batch ends in a device synchronise
    (the reference's ``jax.block_until_ready``)."""
    fn(arg)
    _synchronize(device)
    samples = []
    for _ in range(N_BATCHES):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(arg)
        _synchronize(device)
        samples.append((time.perf_counter() - t0) / reps)
    return _median(samples)


# hubert-xlarge's widths, copied from the JAX package's configuration
# (src/repro/configs/hubert_xlarge.py): 48 layers of (attention, MLP).
HUBERT_XLARGE = {"d_model": 1280, "n_layers": 48, "d_ff": 5120, "vocab": 504}

KERNELS = ("fused_combine", "quantize_wire", "dequantize_wire")

Shapes = Sequence[Tuple[str, Tuple[int, ...], torch.dtype]]


def hubert_xlarge_grad_shapes() -> List[Tuple[str, Tuple[int, ...],
                                              torch.dtype]]:
    """The 13 gradient leaves of hubert-xlarge as ``(path, shape, dtype)``
    in ``jax.tree_util`` order (the shapes ``jax.eval_shape(model.init)``
    gives): norms in fp32, weights in bf16, layers stacked."""
    d, n, f, v = (HUBERT_XLARGE[k] for k in ("d_model", "n_layers", "d_ff",
                                             "vocab"))
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("final_norm/bias", (d,), f32),
        ("final_norm/scale", (d,), f32),
        *((f"layers/L0_0_attn/{w}", (n, d, d), bf16)
          for w in ("wk", "wo", "wq", "wv")),
        ("layers/L0_0_norm/bias", (n, d), f32),
        ("layers/L0_0_norm/scale", (n, d), f32),
        ("layers/L0_1_mlp/wd", (n, f, d), bf16),
        ("layers/L0_1_mlp/wu", (n, d, f), bf16),
        ("layers/L0_1_norm/bias", (n, d), f32),
        ("layers/L0_1_norm/scale", (n, d), f32),
        ("lm_head", (d, v), bf16),
    ]


def _nest(items: Sequence[Tuple[str, Any]]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in items:
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = value
    return tree


def make_grads(n_ranks: int, seed: int = 0, device=None,
               shapes: Optional[Shapes] = None) -> List[Dict[str, Any]]:
    """One gradient tree per rank, standard-normal values drawn from a
    ``torch.Generator`` seeded with ``seed`` on the device."""
    device = resolve_device(device)
    shapes = hubert_xlarge_grad_shapes() if shapes is None else shapes
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [_nest([(p, torch.randn(s, generator=gen, device=device,
                                   dtype=dt)) for p, s, dt in shapes])
            for _ in range(n_ranks)]


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: no numpy-native bf16
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def grads_from_reference(per_rank_trees: Sequence[Any],
                         device=None) -> List[Any]:
    """The JAX package's per-rank gradient pytrees (numpy leaves) as the
    port's trees of tensors on ``device``, leaf for leaf in the same
    order and dtypes (bf16 bits carried over exactly)."""
    device = resolve_device(device)
    out = []
    for tree in per_rank_trees:
        leaves, treedef = tree_flatten(tree)
        out.append(tree_unflatten(treedef,
                                  [_to_tensor(l, device) for l in leaves]))
    return out


def mesh_for(n_ranks: int, hierarchical: bool, device=None) -> LogicalMesh:
    """``("data",)`` over ``n_ranks``, or ``("pod", "data")`` as
    2 × (n_ranks / 2) for the hierarchical schedule."""
    if hierarchical:
        if n_ranks % 2:
            raise ValueError(f"hierarchical needs an even rank count, got "
                             f"{n_ranks}")
        return LogicalMesh((2, n_ranks // 2), ("pod", "data"), device)
    return LogicalMesh((n_ranks,), ("data",), device)


def expected_counts(mode: str, *, algorithm: str = "ring",
                    segments: int = 1, stage_impl: Optional[str] = "cuda",
                    stage_wire: Optional[str] = None,
                    hierarchical: bool = False, n_ranks: int = 4,
                    shapes: Optional[Shapes] = None,
                    sizes: Optional[Sequence[int]] = None,
                    bucket_bytes: int = DEFAULT_BUCKET_BYTES
                    ) -> Dict[str, Any]:
    """The counts one :func:`run_sync` must show, derived from the
    schedule and the bucketing (fp32 presentation): the reductions,
    ``ppermute`` and ``psum`` calls and sentinel waits per rank, and each
    kernel's launches over all ranks (zero unless ``stage_impl="cuda"`` on
    a CUDA device).  The leaves are ``shapes`` (hubert-xlarge's by
    default) or their element counts ``sizes`` in tree order."""
    if sizes is None:
        shapes = hubert_xlarge_grad_shapes() if shapes is None else shapes
        sizes, _ = tree_flatten(_nest([(p, math.prod(s))
                                       for p, s, _ in shapes]))
    n_red = (1 if mode == "fused"
             else len(_make_buckets([4 * s for s in sizes], bucket_bytes)))
    per = {k: 0 for k in KERNELS}
    pp = psum = 0
    if hierarchical:
        n_i = n_ranks // 2
        pp = lowering.sends_per_rank(schedule_ir.build_hierarchical(n_i, 2))
        per["fused_combine"] = (n_i - 1) + 1
    elif algorithm == "native" or (algorithm == "doubling"
                                   and n_ranks & (n_ranks - 1)):
        psum = 1                    # one fused psum node, no rounds
    elif algorithm == "ring":
        pp = lowering.sends_per_rank(schedule_ir.build(
            "allreduce", "ring", n_ranks, segments=segments))
        rs = (n_ranks - 1) * segments
        per["fused_combine"] = rs
        if stage_wire == "bf16":
            per["fused_combine"] += n_ranks * segments
        elif stage_wire == "int8":
            per["quantize_wire"] = rs + segments
            per["dequantize_wire"] = n_ranks * segments
            pp += 2 * (n_ranks - 1) * segments      # the scales' permutes
    else:
        pp = lowering.sends_per_rank(schedule_ir.build(
            "allreduce", algorithm, n_ranks))
        per["fused_combine"] = pp
    launches = {k: (v * n_red * n_ranks if stage_impl == "cuda" else 0)
                for k, v in per.items()}
    return {"reductions": n_red, "ppermute_per_rank": pp * n_red,
            "psum_per_rank": psum * n_red,
            "token_waits_per_rank": n_red - 1 if mode == "sentinel" else 0,
            "launches": launches}


def _launches(names: Sequence[str] = KERNELS) -> Dict[str, int]:
    return {k: getattr(stages, k).launches for k in names}


def run_sync(mode: str, *, algorithm: str = "ring", segments: int = 1,
             stage_impl: Optional[str] = "cuda",
             stage_wire: Optional[str] = None, hierarchical: bool = False,
             compress: Optional[str] = None, n_ranks: int = 4,
             device=None, seed: int = 0, grads: Optional[List[Any]] = None,
             shapes: Optional[Shapes] = None,
             bucket_bytes: int = DEFAULT_BUCKET_BYTES,
             mesh: Optional[LogicalMesh] = None) -> Dict[str, Any]:
    """One ``sync_grads`` call over ``n_ranks`` logical ranks.

    Returns ``results`` (one reduced tree per rank), ``seconds`` (wall
    time of the call, device work included), ``ppermute_calls``,
    ``psum_calls`` and ``token_waits`` per rank, and each stage kernel's ``launches`` in the
    call.  ``grads`` defaults to :func:`make_grads` of ``shapes``
    (hubert-xlarge by default); pass ``mesh`` to reuse one mesh, and so
    its streams and the allocator's cache, across calls.
    """
    device = resolve_device(device)
    if mesh is None:
        mesh = mesh_for(n_ranks, hierarchical, device)
    if grads is None:
        grads = make_grads(mesh.size, seed, device, shapes)
    axes = tuple(mesh.axis_names)
    mesh.reset_counts()
    before = _launches()
    _synchronize(device)
    t0 = time.perf_counter()
    results = sync_grads(grads, mesh=mesh, axes=axes, mode=mode,
                         bucket_bytes=bucket_bytes, compress=compress,
                         algorithm=None if hierarchical else algorithm,
                         segments=segments, hierarchical=hierarchical,
                         stage_impl=stage_impl, stage_wire=stage_wire)
    _synchronize(device)
    seconds = time.perf_counter() - t0
    after = _launches()
    return {"results": results, "seconds": seconds,
            "ppermute_calls": list(mesh.coll_calls["ppermute"]),
            "psum_calls": list(mesh.coll_calls["psum"]),
            "token_waits": list(mesh.token_waits),
            "launches": {k: after[k] - before[k] for k in KERNELS}}


# ---------------------------------------------------------------------------
# The reference's bench legs over logical ranks
# ---------------------------------------------------------------------------
STAGE_KERNELS = KERNELS + ("gs_stencil",)


def _uniform(counts: Sequence[int], what: str) -> int:
    if len(set(counts)) != 1:
        raise SystemExit(f"overlap bench: {what} differ across ranks: "
                         f"{list(counts)}")
    return counts[0]


def _rank_values(n: int, elems: int, seed: int,
                 device: torch.device) -> List[torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [torch.randn(elems, generator=gen, device=device)
            for _ in range(n)]


def _counted(fn: Callable, arg, device: torch.device,
             mesh: Optional[LogicalMesh] = None) -> Tuple[Any, Dict[str,
                                                                  int]]:
    """One untimed call with ``mesh``'s counters zeroed: its result and
    each stage kernel's launches in it."""
    if mesh is not None:
        mesh.reset_counts()
    before = _launches(STAGE_KERNELS)
    out = fn(arg)
    _synchronize(device)
    after = _launches(STAGE_KERNELS)
    return out, {k: after[k] - before[k] for k in STAGE_KERNELS}


def _mesh_counts(leg: str, mesh: LogicalMesh, exp: Dict[str, Any]
                 ) -> Dict[str, int]:
    """The mesh's counters of the last call, per rank, held against the
    derived ``exp`` (a :func:`expected_counts` result)."""
    got = {"ppermute_calls": _uniform(mesh.coll_calls["ppermute"],
                                      f"{leg} ppermute calls"),
           "reductions": _uniform(mesh.coll_calls["psum"],
                                  f"{leg} reductions"),
           "token_waits": _uniform(mesh.token_waits, f"{leg} token waits")}
    want = {"ppermute_calls": exp["ppermute_per_rank"],
            "reductions": exp["psum_per_rank"],
            "token_waits": exp["token_waits_per_rank"]}
    if got != want:
        raise SystemExit(f"overlap bench: {leg} counted {got}, the "
                         f"schedule derives {want}")
    return got


def bench_hierarchical(reps: int, elems: int, device=None) -> dict:
    """The two-axis leg: hierarchical vs flat ring vs native psum.

    One ``schedule.build_hierarchical`` schedule drives the (INTER ×
    INTRA) lowering over ``("pod", "data")``; the flat ring runs the same
    payload over one 8-rank axis; ``native`` is one psum over both axes.
    Each entry carries the nominal predicted seconds and the linear cost
    features (not for ``native``), and the mesh's counts."""
    device = resolve_device(device)
    n = INTER * INTRA
    mesh2d = LogicalMesh((INTER, INTRA), ("pod", "data"), device)
    mesh1d = LogicalMesh((n,), ("data",), device)
    nbytes = elems * 4
    xs = _rank_values(n, elems, 3, device)
    legs = {
        "hierarchical": (mesh2d, "hierarchical",
                         schedule_ir.build_hierarchical(INTRA, INTER)),
        "flat_ring": (mesh1d, "ring",
                      schedule_ir.build("allreduce", "ring", n)),
        "native": (mesh2d, "native", None),
    }
    report = {"inter": INTER, "intra": INTRA, "payload_bytes": nbytes}
    for name, (mesh, alg, sched) in legs.items():
        def fn(v, mesh=mesh, alg=alg):
            return lowering.allreduce(v, tuple(mesh.axis_names), mesh=mesh,
                                      algorithm=alg)
        entry = {"measured_s": _time_call(fn, xs, reps, device)}
        _counted(fn, xs, device, mesh)
        entry.update(_mesh_counts(name, mesh, expected_counts(
            "fused", algorithm=alg, hierarchical=alg == "hierarchical",
            stage_impl=None, n_ranks=n, sizes=[elems])))
        if sched is not None:
            entry["predicted_s"] = sched.cost(ALPHA, BETA, nbytes,
                                              gamma=GAMMA)
            entry["features"] = features(sched, nbytes)
        report[name] = entry
    return report


# ---------------------------------------------------------------------------
# Fused-stage microbench: the hand-written stage kernels vs unfused passes
# ---------------------------------------------------------------------------
# Analytic HBM traffic of one reduce-scatter combine stage, bytes per
# element: the fused kernel reads the wire payload and the fp32
# accumulator and writes the result once; the unfused path additionally
# materialises the fp32 copy of the cast/dequantised wire payload (one
# write + one read-back).  fp32 has no cast stage, so fused == unfused
# there — the ≤0.6× bytes claim is about the narrow-wire legs.
_ACC_B = 4
_WIRE_B = {"fp32": 4, "bf16": 2, "int8": 1}
STAGE_MAX_FUSED_RATIO = 0.6
# The int8 fused combine against the unfused passes, as max|diff| /
# max|unfused|: the kernel may contract the dequant-add into an FMA (one
# rounding instead of two), as the JAX lowering does (ROADMAP §3).  fp32,
# bf16 and the stencil's block and edges are held bitwise; the stencil's
# residual sums in another order, within the card check's 1e-5.
STAGE_INT8_RTOL = 2e-6
STAGE_RES_RTOL = 1e-5


def stage_hbm_bytes(wire: str, elems: int, fused: bool) -> float:
    per = _WIRE_B[wire] + 2 * _ACC_B          # read got + read acc + write
    if not fused and wire != "fp32":
        per += 2 * _ACC_B                     # fp32 temp: write + read back
    return float(per * elems)


def gs_stage_hbm_bytes(h: int, w: int, fused: bool) -> float:
    # fused: one read of the block + one write of the update (residual
    # and edges accumulate in-register; O(H+W) edge bytes are noise).
    # unfused: the residual pass re-reads BOTH the new and the old block.
    per = 2 * _ACC_B if fused else 4 * _ACC_B
    return float(per * h * w)


def _stage_row(fn, arg, reps: int, hbm: float, variant: str,
               device: torch.device) -> Tuple[dict, Any]:
    out, launches = _counted(fn, arg, device)
    return {"measured_s": _time_call(fn, arg, reps, device),
            "hbm_bytes": hbm,
            "features": {"rounds": 0.0, "wire_bytes": 0.0,
                         "combine_bytes": hbm},
            "overhead_class": f"stage:{variant}",
            "launches": launches}, out


def _expect_launches(row: dict, name: str, kernel: Optional[str],
                     device: torch.device) -> None:
    want = {k: 0 for k in STAGE_KERNELS}
    if kernel is not None and device.type == "cuda":
        want[kernel] = 1
    if row["launches"] != want:
        raise SystemExit(f"overlap bench: {name} launched "
                         f"{row['launches']}, expected {want}")


def bench_stages(smoke: bool = False, device=None) -> dict:
    """Fused vs unfused collective-stage legs.

    Each wire dtype is timed both ways on the same payload (the int8 one
    quantised by ``ops.quantize_stage``, the ``quantize_wire`` kernel on
    the card): ``unfused`` materialises the cast or dequantised payload
    in one pass (for int8 ``ops.dequantize_stage``, the
    ``dequantize_wire`` kernel), then adds; ``fused`` is one
    :func:`repro_torch.kernels.ops.combine_stage` call (the
    ``fused_combine`` kernel).  The Gauss–Seidel
    stencil stage likewise: the update, then a residual pass re-reading
    both blocks, against one ``ops.gs_stencil`` call (the ``gs_stencil``
    kernel).  Rows carry the analytic per-stage HBM bytes as their
    ``combine_bytes`` feature under the ``stage:*`` classes and each row's
    kernel launches; the fused outputs are held against the unfused ones.
    HARD ASSERTS fused bytes ≤ ``STAGE_MAX_FUSED_RATIO`` × unfused on
    every narrow-wire leg and for the stencil."""
    device = resolve_device(device)
    elems = 1 << 18 if smoke else 1 << 20
    reps = 3 if smoke else 10
    acc, got32 = (_rank_values(1, elems, seed, device)[0] for seed in (7, 8))
    report: dict = {"elems": elems, "max_fused_ratio": STAGE_MAX_FUSED_RATIO}

    def wire_payload(wire):
        if wire == "bf16":
            return got32.to(torch.bfloat16), None
        if wire == "int8":          # the quantize_wire kernel on the card
            return kernel_ops.quantize_stage(got32)
        return got32, None

    def unfused(args):
        a, g, s = args
        if s is not None:           # the dequantize_wire kernel on the card
            deq = kernel_ops.dequantize_stage(g, s)
        elif g.dtype != torch.float32:
            deq = g.float()                 # the materialised cast
        else:
            deq = g
        return a + deq

    def fused(args):
        a, g, s = args
        return kernel_ops.combine_stage(a, g, s)

    for wire in ("fp32", "bf16", "int8"):
        g, s = wire_payload(wire)
        outs = {}
        for variant, fn in (("unfused", unfused), ("fused", fused)):
            name = f"combine_{wire}_{variant}"
            report[name], outs[variant] = _stage_row(
                fn, (acc, g, s), reps,
                stage_hbm_bytes(wire, elems, variant == "fused"), variant,
                device)
            _expect_launches(report[name], name, "fused_combine"
                             if variant == "fused" else "dequantize_wire"
                             if wire == "int8" else None, device)
        row = report[f"combine_{wire}_fused"]
        diff = float((outs["fused"] - outs["unfused"]).abs().max())
        row["max_abs_diff"] = diff
        if wire == "int8":
            limit = STAGE_INT8_RTOL * float(outs["unfused"].abs().max())
            if diff > limit:
                raise SystemExit(f"fused int8 combine {diff} from the "
                                 f"unfused passes (max {limit})")
        elif not torch.equal(outs["fused"], outs["unfused"]):
            raise SystemExit(f"fused {wire} combine differs from the "
                             f"unfused passes by {diff}")
        ratio = row["hbm_bytes"] / report[
            f"combine_{wire}_unfused"]["hbm_bytes"]
        row["bytes_ratio"] = ratio
        if wire != "fp32" and ratio > STAGE_MAX_FUSED_RATIO:
            raise SystemExit(
                f"fused {wire} combine stage lost its bytes win: "
                f"{ratio:.2f}x unfused (max {STAGE_MAX_FUSED_RATIO})")

    # Gauss–Seidel stencil stage: update + residual + boundary-pack in
    # one pass vs the update-then-re-read shape.
    H = W = 256 if smoke else 512
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    blk = torch.randn((H, W), generator=gen, device=device)
    edges = tuple(torch.randn((k,), generator=gen, device=device)
                  for k in (W, H, W, H))

    def gs_unfused(args):
        b, (t, l, bt, r) = args
        new, old = kernel_ref.gs_update(b, t, l, bt, r)   # update pass
        res = torch.sum(torch.abs(new - old))   # residual re-reads both
        new = new.to(b.dtype)
        return new, res, (new[0], new[-1], new[:, 0].contiguous(),
                          new[:, -1].contiguous())

    def gs_fused(args):
        b, (t, l, bt, r) = args
        return kernel_ops.gs_stencil(b, t, l, bt, r)

    outs = {}
    for variant, fn in (("unfused", gs_unfused), ("fused", gs_fused)):
        name = f"gs_stencil_{variant}"
        report[name], outs[variant] = _stage_row(
            fn, (blk, edges), reps, gs_stage_hbm_bytes(H, W,
                                                       variant == "fused"),
            variant, device)
        _expect_launches(report[name], name,
                         "gs_stencil" if variant == "fused" else None,
                         device)
    (nf, rf, ef), (nu, ru, eu) = outs["fused"], outs["unfused"]
    if not (torch.equal(nf, nu)
            and all(torch.equal(a, b) for a, b in zip(ef, eu))):
        raise SystemExit("fused stencil block or edges differ from the "
                         "unfused passes")
    rf, ru = float(rf), float(ru)
    if abs(rf - ru) > STAGE_RES_RTOL * abs(ru):
        raise SystemExit(f"fused stencil residual {rf} against the "
                         f"unfused passes' {ru}")
    report["gs_stencil_fused"]["residual_rel_diff"] = abs(rf - ru) / abs(ru)
    gs_ratio = (report["gs_stencil_fused"]["hbm_bytes"]
                / report["gs_stencil_unfused"]["hbm_bytes"])
    report["gs_stencil_fused"]["bytes_ratio"] = gs_ratio
    if gs_ratio > STAGE_MAX_FUSED_RATIO:
        raise SystemExit(f"fused stencil stage lost its bytes win: "
                         f"{gs_ratio:.2f}x unfused")
    return report


def bench_lowered_stages(reps: int, elems: int, device=None) -> dict:
    """The same flat-ring allreduce over 8 logical ranks lowered without
    the stage tier (``unfused``: the plain add), with the kernel tier
    (``fused``) and with the kernel tier and a bf16 wire (``fused_bf16``,
    whose wire-bytes feature is halved).  Each row's ppermute calls and
    kernel launches equal :func:`expected_counts`; the fused ring's
    results equal the unfused ring's bitwise."""
    device = resolve_device(device)
    n = REF_RANKS
    mesh = LogicalMesh((n,), ("data",), device)
    nbytes = elems * 4
    xs = _rank_values(n, elems, 5, device)
    base_feat = features(schedule_ir.build("allreduce", "ring", n), nbytes)
    legs = {
        "unfused": ({}, dict(base_feat)),
        "fused": (dict(stage_impl="cuda"), dict(base_feat)),
        "fused_bf16": (dict(stage_impl="cuda", stage_wire="bf16"),
                       dict(base_feat,
                            wire_bytes=base_feat["wire_bytes"] / 2)),
    }
    report = {"ranks": n, "payload_bytes": nbytes}
    outs = {}
    for name, (kw, feat) in legs.items():
        def fn(v, kw=kw):
            return lowering.allreduce(v, ("data",), mesh=mesh,
                                      algorithm="ring", **kw)
        outs[name], launches = _counted(fn, xs, device, mesh)
        # on the CPU the kernel tier takes the plain versions: no launch
        exp = expected_counts(
            "fused", algorithm="ring", n_ranks=n, sizes=[elems],
            stage_impl="cuda" if kw and device.type == "cuda" else None,
            stage_wire=kw.get("stage_wire"))
        counts = _mesh_counts(f"lowered {name}", mesh, exp)
        want = dict(exp["launches"], gs_stencil=0)
        if launches != want:
            raise SystemExit(f"overlap bench: lowered {name} launched "
                             f"{launches}, expected {want}")
        report[name] = {"measured_s": _time_call(fn, xs, reps, device),
                        **counts, "launches": launches, "features": feat}
    if not all(torch.equal(a, b) for a, b in zip(outs["fused"],
                                                  outs["unfused"])):
        raise SystemExit("lowered ring: the fused stage tier's results "
                         "differ from the unfused ring's")
    return report


def bench_inter(reps: int, elems: int, device=None) -> dict:
    """Inter-axis (pod-level) butterfly legs under the ``inter:butterfly``
    overhead class: ``lowering._butterfly_allreduce`` over the ``pod``
    axis of 2 pods of (2, 4) and 4 pods of (4, 2) logical ranks.  The port's
    butterfly accumulates in place, so each call first copies the inputs
    on the rank streams (the reference's jitted call writes a new
    output)."""
    device = resolve_device(device)
    report: dict = {"payload_bytes": elems * 4}
    for n_pods, shape in ((2, (2, 4)), (4, (4, 2))):
        mesh = LogicalMesh(shape, ("pod", "data"), device)
        rounds = n_pods.bit_length() - 1
        xs = _rank_values(mesh.size, elems, 9, device)

        def fn(v, mesh=mesh, n_pods=n_pods):
            with mesh.region():
                ys = []
                for r, x in enumerate(v):
                    with mesh.on(r):
                        ys.append(x.clone())
                return lowering._butterfly_allreduce(mesh, ys, "pod",
                                                     n_pods)
        nbytes = elems * 4
        report[f"butterfly_{n_pods}pods"] = {
            "measured_s": _time_call(fn, xs, reps, device),
            "features": {"rounds": float(rounds),
                         "wire_bytes": float(rounds * nbytes),
                         "combine_bytes": float(rounds * nbytes)},
            "overhead_class": "inter:butterfly",
        }
    return report


# ---------------------------------------------------------------------------
# Level-A executor microbench: compiled vs interpreted schedule programs
# ---------------------------------------------------------------------------
LEVEL_A_RANKS = 8
LEVEL_A_ALGORITHMS = ("ring", "doubling")
LEVEL_A_ELEMS = (64, 1 << 14)       # float64 payloads: 512 B and 128 KiB
# raw small-payload regression guard: compiled may never be slower than
# the interpreter it replaces (the calibrated ≤0.5× overhead bar lives in
# tools/calibrate.py).
LEVEL_A_MAX_SMALL_RATIO = 0.98
LEVEL_A_TRIALS = 3                  # sweeps; the median ratio's is kept


def serial_features(sched: schedule_ir.Schedule, size: float) -> dict:
    """Linear cost features of one schedule under a SERIAL driver:
    transfers executed, bytes moved and bytes combined, summed over all
    ranks (``Collectives.run_group`` drives every rank's program
    round-robin on one thread)."""
    rounds = wire = combine = 0.0
    for prog in sched.programs:
        for op in prog:
            if isinstance(op, schedule_ir.Send):
                rounds += 1.0
                wire += op.frac * size
            elif isinstance(op, schedule_ir.Combine):
                combine += op.frac * size
    return {"rounds": rounds, "wire_bytes": wire, "combine_bytes": combine}


def _level_a_sweep(reps: int) -> Tuple[dict, float]:
    """One sweep of the executor leg: after one untimed warm pass of every
    configuration, per configuration a fresh runner for each executor
    (its first call compiles and caches the per-rank programs), then
    ``N_BATCHES`` batches of ``reps`` calls, the executors taking turns
    batch by batch (compiled first in even batches, interpreted first in
    odd ones), each row the median of its batches.  Returns the rows by
    executor and the raw small-payload ratio compiled / interpreted."""
    n = LEVEL_A_RANKS
    rows: dict = {"compiled": {}, "interpreted": {}}
    small = {"compiled": 0.0, "interpreted": 0.0}

    def runner(executor, algorithm, elems):
        world = tac.CommWorld(n)
        coll = Collectives(world, executor=executor)
        kw = [{"value": np.arange(elems, dtype=np.float64) + r}
              for r in range(n)]
        return lambda: coll.run_group("allreduce", kw, algorithm=algorithm)

    for algorithm in LEVEL_A_ALGORITHMS:
        for elems in LEVEL_A_ELEMS:
            for executor in small:
                runner(executor, algorithm, elems)()
    for algorithm in LEVEL_A_ALGORITHMS:
        for elems in LEVEL_A_ELEMS:
            sched = schedule_ir.build("allreduce", algorithm, n)
            nbytes = elems * 8
            fns = {e: runner(e, algorithm, elems) for e in small}
            for fn in fns.values():
                fn()
            samples: Dict[str, List[float]] = {e: [] for e in fns}
            for b in range(N_BATCHES):
                for e in (list(fns) if b % 2 == 0 else list(fns)[::-1]):
                    t0 = time.perf_counter()
                    for _ in range(reps):
                        fns[e]()
                    samples[e].append((time.perf_counter() - t0) / reps)
            for executor in fns:
                dt = _median(samples[executor])
                rows[executor][f"{algorithm}_{elems}"] = {
                    "algorithm": algorithm, "payload_bytes": nbytes,
                    "measured_s": dt,
                    "features": serial_features(sched, nbytes),
                    "overhead_class": f"level_a:{executor}",
                }
                if elems == LEVEL_A_ELEMS[0]:
                    small[executor] += dt
    return rows, small["compiled"] / small["interpreted"]


def level_a_rows(smoke: bool = False) -> dict:
    """The executor leg's measurements: compiled per-rank programs vs the
    interpreter, the same host allreduce (8 ranks over a ``CommWorld``,
    numpy float64 payloads) under the serial group driver at two payload
    sizes × two algorithms, rows tagged ``level_a:<executor>``, and the
    raw small-payload ratio (:func:`bench_level_a` gates it).

    The reference times one sweep, all of one executor's batches and then
    the other's.  On a host whose cores are shared, contention comes in
    stretches longer than a block of batches, and such a sweep's ratio
    crosses the 0.98 threshold now and then though its median sits well
    below (the reference's own sweep too).  So the port's sweep takes
    turns batch by batch (:func:`_level_a_sweep`), and it runs
    ``LEVEL_A_TRIALS`` sweeps and reports the one whose ratio is their
    median (``trial_ratios`` lists all); the threshold and the statistic
    of each row are the reference's."""
    reps = 10 if smoke else 30
    trials = sorted((_level_a_sweep(reps) for _ in range(LEVEL_A_TRIALS)),
                    key=lambda t: t[1])
    rows, ratio = trials[len(trials) // 2]
    return {"ranks": LEVEL_A_RANKS, "reps": reps, **rows,
            "small_payload_ratio": ratio,
            "trial_ratios": [t[1] for t in trials]}


def check_level_a(report: dict) -> dict:
    """HARD ASSERT of the Level-A leg: the compiled executor's raw
    small-payload time at most ``LEVEL_A_MAX_SMALL_RATIO`` × the
    interpreter's."""
    ratio = report["small_payload_ratio"]
    if ratio > LEVEL_A_MAX_SMALL_RATIO:
        raise SystemExit(
            f"compiled executor lost its small-payload win: "
            f"compiled/interpreted = {ratio:.2f} "
            f"(max {LEVEL_A_MAX_SMALL_RATIO}); the per-call fast path "
            f"regressed")
    return report


def bench_level_a(smoke: bool = False) -> dict:
    """The executor leg (:func:`level_a_rows`) under its hard assert
    (:func:`check_level_a`)."""
    return check_level_a(level_a_rows(smoke))


# ---------------------------------------------------------------------------
# Progress-path microbench: polling vs continuation notification
# ---------------------------------------------------------------------------
IN_FLIGHT_SWEEP = (8, 16, 32, 64)
PROGRESS_OPS_BUDGET = 20_000    # ~progress ops per timed batch (noise floor)
TEST_S = DISPATCH_S = 1e-6      # nominal per-progress-op model constants


def _progress_setup(backend: str, n: int):
    """Arm ``n`` in-flight event-bound machines on a fresh engine; returns
    ``(handles, drain, counters)``: ``drain()`` completes one handle per
    tick and services the engine once per completion, ``counters()``
    reads the progress-op totals (tests, dispatches)."""
    handles = [tac.EventHandle() for _ in range(n)]

    def gen(h):
        res = yield h
        return res

    if backend == "polling":
        eng = ProgressEngine()
        service, counters = eng.poll, lambda: (eng.stats["tests"], 0)
    else:
        engine = ContinuationEngine()
        eng = ProgressEngine(notify="continuation", continuations=engine)
        service = engine.service
        counters = lambda: (engine.stats["tests"],          # noqa: E731
                            engine.stats["dispatches"])
    for h in handles:
        eng.submit(_Machine(gen(h), CollectiveHandle()))

    def drain():
        for i, h in enumerate(handles):
            h.complete(i)
            service(None)
        if eng.pending:
            raise SystemExit(f"progress bench: {eng.pending} machines "
                             f"stuck under {backend}")
    return handles, drain, counters


def bench_progress(smoke: bool = False) -> dict:
    """Polling vs continuation progress cost over an in-flight sweep, each
    row with its progress ops as the ``rounds`` feature and the nominal
    ``simulate.progress_cost`` prediction.  HARD ASSERTS continuation ops
    per completion flat and polling's linear."""
    budget = 4_000 if smoke else PROGRESS_OPS_BUDGET
    report: dict = {"sweep": list(IN_FLIGHT_SWEEP),
                    "test_s": TEST_S, "dispatch_s": DISPATCH_S}
    per_completion = {}
    for backend in ("polling", "continuation"):
        rows = {}
        for n in IN_FLIGHT_SWEEP:
            _, drain, counters = _progress_setup(backend, n)
            drain()
            tests, dispatches = counters()      # deterministic totals
            ops = tests + dispatches
            reps = max(1, budget // max(ops, 1))
            samples = []
            for _ in range(N_BATCHES):
                # arm outside the clock: measured_s is the progress cost
                drains = [_progress_setup(backend, n)[1]
                          for _ in range(reps)]
                t0 = time.perf_counter()
                for d in drains:
                    d()
                samples.append((time.perf_counter() - t0) / reps)
            # one completion per tick: the mean in-flight count is (n+1)/2
            predicted = simulate.progress_cost(
                backend, in_flight=(n + 1) / 2, ticks=n, completions=n,
                test_s=TEST_S, dispatch_s=DISPATCH_S)
            rows[f"inflight_{n}"] = {
                "in_flight": n, "completions": n, "tests": tests,
                "dispatches": dispatches,
                "ops_per_completion": ops / n,
                "measured_s": _median(samples),
                "predicted_s": predicted,
                "features": {"rounds": float(ops), "wire_bytes": 0.0,
                             "combine_bytes": 0.0},
            }
        report[backend] = rows
        per_completion[backend] = {
            n: rows[f"inflight_{n}"]["ops_per_completion"]
            for n in IN_FLIGHT_SWEEP}
    lo, hi = min(IN_FLIGHT_SWEEP), max(IN_FLIGHT_SWEEP)
    cont, poll = per_completion["continuation"], per_completion["polling"]
    if max(cont.values()) > 2.0 or cont[hi] > 1.5 * cont[lo]:
        raise SystemExit(
            f"continuation progress cost is NOT flat in in-flight ops: "
            f"ops/completion {cont} (expected O(1) dispatches per "
            f"completion)")
    if poll[hi] < 2.0 * poll[lo]:
        raise SystemExit(
            f"polling progress cost unexpectedly flat: ops/completion "
            f"{poll} (the baseline the continuation backend beats)")
    return report


# ---------------------------------------------------------------------------
# Observability sentinel: the disabled tracer must be (near-)free
# ---------------------------------------------------------------------------
OBS_MAX_OVERHEAD = 0.02     # NullTracer guard cost budget: ≤ 2% of hot path
OBS_GUARD_LOOPS = 1_000_000


def obs_rows(smoke: bool = False) -> dict:
    """The ``repro_torch.obs`` sentinel's measurements: the guarded
    emissions of one continuation-backend drain under a real tracer, the
    per-check guard cost with tracing off (an empty loop's time
    subtracted, 0.5 ns floor), and rows ``null`` / ``active`` timing the
    drain untraced and traced; ``overhead_fraction`` is ``emissions ×
    guard_cost / drain_time`` (:func:`bench_obs` gates it).  Fails if the
    instrumentation emitted nothing or tracing stayed on."""
    from .. import obs
    from ..obs import trace as _tr

    n = max(IN_FLIGHT_SWEEP)
    reps = 20 if smoke else 50

    # (1) guarded emissions per drain, counted under a real tracer.
    with obs.tracing() as tr:
        _, drain, counters = _progress_setup("continuation", n)
        drain()
        n_events = len(tr.events())
        tests, dispatches = counters()
    if n_events == 0:
        raise SystemExit("obs sentinel: a traced drain emitted no events "
                         "— the instrumentation went dead")

    # (2) per-check guard cost on the disabled path.
    if _tr.TRACING:
        raise SystemExit("obs sentinel: tracing still on after the traced "
                         "drain")
    hits = 0
    t0 = time.perf_counter()
    for _ in range(OBS_GUARD_LOOPS):
        if _tr.TRACING:
            hits += 1      # pragma: no cover - tracing is off
    t_guarded = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(OBS_GUARD_LOOPS):
        pass
    t_empty = time.perf_counter() - t0
    guard_s = max((t_guarded - t_empty) / OBS_GUARD_LOOPS, 0.5e-9)

    # (3) the drain itself, untraced (NullTracer) and traced.
    def timed(active: bool) -> float:
        samples = []
        for _ in range(N_BATCHES):
            with contextlib.ExitStack() as stack:
                if active:
                    stack.enter_context(obs.tracing())
                drains = [_progress_setup("continuation", n)[1]
                          for _ in range(reps)]
                t0 = time.perf_counter()
                for d in drains:
                    d()
                samples.append((time.perf_counter() - t0) / reps)
        return _median(samples)

    t_null = timed(False)
    t_active = timed(True)
    overhead = n_events * guard_s / max(t_null, 1e-12)
    report = {
        "in_flight": n,
        "events_per_drain": n_events,
        "guard_ns": guard_s * 1e9,
        "overhead_fraction": overhead,
        "max_overhead": OBS_MAX_OVERHEAD,
        "null": {
            "measured_s": t_null,
            "features": {"rounds": float(tests + dispatches),
                         "wire_bytes": 0.0, "combine_bytes": 0.0},
            "overhead_class": "obs:null",
        },
        "active": {
            "measured_s": t_active,
            "events": n_events,
            "features": {"rounds": float(n_events), "wire_bytes": 0.0,
                         "combine_bytes": 0.0},
            "overhead_class": "obs:active",
        },
    }
    if hits:
        raise SystemExit("obs sentinel: a guarded site fired with tracing "
                         "off")
    return report


def check_obs(report: dict) -> dict:
    """HARD ASSERT of the sentinel: tracing off costs at most
    ``OBS_MAX_OVERHEAD`` of the continuation drain."""
    overhead = report["overhead_fraction"]
    if overhead > OBS_MAX_OVERHEAD:
        raise SystemExit(
            f"obs sentinel: NullTracer overhead {overhead * 100:.2f}% of "
            f"the continuation drain exceeds the "
            f"{OBS_MAX_OVERHEAD * 100:.0f}% budget "
            f"({report['events_per_drain']} guarded sites × "
            f"{report['guard_ns']:.1f} ns vs "
            f"{report['null']['measured_s'] * 1e6:.1f} µs hot path) — an "
            f"instrumentation site stopped being guard-only")
    return report


def bench_obs(smoke: bool = False) -> dict:
    """The tracer sentinel (:func:`obs_rows`) under its hard assert
    (:func:`check_obs`): tracing off must cost ≤ 2 % of the drain."""
    return check_obs(obs_rows(smoke))


# ---------------------------------------------------------------------------
# The grad-sync modes on a real train step
# ---------------------------------------------------------------------------
GRAD_SYNC_MODES = ("fused", "bucketed", "sentinel")
# the reference's modes leg: a batch of 8 x 64 over 8 ranks, 64 KiB buckets
MODES_BATCH, MODES_SEQ, MODES_BUCKET_BYTES = 8, 64, 1 << 16
# The modes' agreement after step 1: tests/test_distributed.py's
# test_manual_grad_sync_modes_match holds fp32 parameters to atol 1e-5,
# rtol 1e-4, loss to 1e-5 and grad norm to 1e-4; a bf16 parameter moves
# in steps of 2^-8 of itself, so its rtol is one bf16 ulp.
MODES_PARAM_ATOL = 1e-5
MODES_PARAM_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -8}
MODES_LOSS_ATOL, MODES_GNORM_ATOL = 1e-5, 1e-4


def _state_leaves(state) -> List[torch.Tensor]:
    from ..models import model
    return tree_flatten((model.param_tree(state.params),
                         state.opt.master))[0]


def _ranks_equal(mode: str, replicas) -> None:
    base = _state_leaves(replicas[0])
    for r, rep in enumerate(replicas[1:], 1):
        if not all(torch.equal(a, b)
                   for a, b in zip(base, _state_leaves(rep))):
            raise SystemExit(f"grad sync {mode}: rank {r}'s parameters "
                             f"differ from rank 0's")


def bench_modes(cfg, *, reps: int = 5, device=None) -> dict:
    """The three grad-sync modes through
    ``runtime.steps.build_train_step_manual`` on a ``(REF_RANKS, 1)``
    ``("data", "model")`` logical mesh: each mode trains a fresh state of
    ``cfg`` from seed 0 on one batch of ``MODES_BATCH`` × ``MODES_SEQ``
    with ``MODES_BUCKET_BYTES`` buckets (a warm-up step that also makes
    the replicas, then ``N_BATCHES`` timed batches of ``reps`` steps, the
    median reported).  Each mode reports ``predict(mode,
    leaf_bytes, bucket_bytes)`` over the leaves its own step buckets (the
    port's parameter leaves are per unit, the reference's stacked, so the
    two steps' buckets differ), the leaf count, and the mesh's counts of
    one step.  HARD ASSERTS: reductions and sentinel waits equal
    :func:`expected_counts`, every rank's parameters and fp32 masters
    bitwise equal after the warm-up and the timed steps, and the modes'
    step-1 loss, grad norm and parameters within the reference's bounds
    of ``fused``'s."""
    from ..models import inputs, model
    from ..runtime import steps
    from ..runtime.sharding import ShardingPolicy
    device = resolve_device(device)
    opt_cfg = optim.OptimConfig()
    n_ranks, bucket_bytes = REF_RANKS, MODES_BUCKET_BYTES
    mesh = LogicalMesh((n_ranks, 1), ("data", "model"), device)
    data = inputs.make_batch(cfg, batch=MODES_BATCH, seq=MODES_SEQ, seed=0,
                             device=device)
    report: Dict[str, Any] = {"ranks": n_ranks, "batch": MODES_BATCH,
                              "seq": MODES_SEQ, "bucket_bytes": bucket_bytes,
                              "modes": {}}
    first: Dict[str, Any] = {}
    for mode in GRAD_SYNC_MODES:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        policy = ShardingPolicy(fsdp=False, tp=False, sp=False, remat=None,
                                grad_sync=mode)
        state = steps.init_train_state(cfg, opt_cfg, 0, device=device)
        leaves = tree_flatten(model.param_tree(state.params))[0]
        sizes = [t.numel() for t in leaves]
        leaf_bytes = [4 * s for s in sizes]     # sync_grads' fp32 wire
        report["grad_bytes"] = sum(leaf_bytes)
        report["n_leaves"] = len(leaves)
        step = steps.build_train_step_manual(
            cfg, mesh, policy, opt_cfg, bucket_bytes=bucket_bytes)()
        mesh.reset_counts()
        state, m = step(state, data)            # warm-up: the replicas
        _synchronize(device)
        counts = _mesh_counts(f"grad sync {mode}", mesh, expected_counts(
            mode, algorithm="native", stage_impl=None, n_ranks=n_ranks,
            sizes=sizes, bucket_bytes=bucket_bytes))
        _ranks_equal(mode, step.replicas())
        first[mode] = (float(m["loss"]), float(m["grad_norm"]),
                       [t.detach().cpu() for t in
                        tree_flatten(model.param_tree(state.params))[0]])
        samples = []
        for _ in range(N_BATCHES):
            t0 = time.perf_counter()
            for _ in range(reps):
                state, m = step(state, data)
            _synchronize(device)
            samples.append((time.perf_counter() - t0) / reps)
        _ranks_equal(mode, step.replicas())
        entry = dict(predict(mode, leaf_bytes, bucket_bytes),
                     measured_s=_median(samples), **counts)
        if device.type == "cuda":
            entry["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        report["modes"][mode] = entry
        del state, step, m, leaves
        if device.type == "cuda":
            torch.cuda.empty_cache()
    loss0, gnorm0, params0 = first["fused"]
    for mode in GRAD_SYNC_MODES[1:]:
        loss, gnorm, params = first[mode]
        if abs(loss - loss0) >= MODES_LOSS_ATOL or \
                abs(gnorm - gnorm0) >= MODES_GNORM_ATOL:
            raise SystemExit(f"grad sync {mode}: step-1 loss {loss} / grad "
                             f"norm {gnorm} against fused's {loss0} / "
                             f"{gnorm0}")
        for a, b in zip(params0, params):
            if not torch.allclose(b.float(), a.float(),
                                  atol=MODES_PARAM_ATOL,
                                  rtol=MODES_PARAM_RTOL[a.dtype]):
                raise SystemExit(f"grad sync {mode}: step-1 parameters "
                                 f"beyond the bounds of fused's")
        report["modes"][mode]["bitwise_as_fused"] = all(
            torch.equal(a, b) for a, b in zip(params0, params))
    return report


# ---------------------------------------------------------------------------
# The whole bench
# ---------------------------------------------------------------------------
DEFAULT_JSON = "BENCH_overlap_torch.json"
# the JAX package's reports, which this bench never overwrites
RESERVED_JSON = ("BENCH_overlap.json", "BENCH_baseline.json")


def bench(print_fn=print, smoke: bool = False,
          json_path: str = DEFAULT_JSON, cfg=None, device=None) -> list:
    """The reference's bench on the port: the modes leg on ``cfg``
    (default the reference's: smoke granite in fp32, 8 layers, 2 when
    ``smoke``, a batch of 8 × 64, buckets of 64 KiB, 8 logical ranks),
    then the hierarchical, stage, lowered-stage, inter, Level-A, progress
    and obs legs, the segmented ring's prediction and the gate scope.
    Writes the JSON report to ``json_path`` and prints CSV rows
    ``name,us_per_call,derived``; returns the rows."""
    if pathlib.Path(json_path).name in RESERVED_JSON:
        raise ValueError(f"{json_path} is the JAX package's report; the "
                         f"port writes {DEFAULT_JSON}")
    device = resolve_device(device)
    rows = []
    reps = 2 if smoke else 5
    if cfg is None:
        cfg = configs.smoke("granite_3_2b").scaled(
            dtype="float32", n_layers=2 if smoke else 8)
    elems = 1 << 14 if smoke else 1 << 16
    modes = bench_modes(cfg, reps=reps, device=device)
    report = {"alpha": ALPHA, "beta": BETA, "gamma": GAMMA,
              "device": {"type": device.type,
                         "name": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu")},
              **{k: v for k, v in modes.items() if k != "modes"},
              "modes": modes["modes"]}
    for mode, e in modes["modes"].items():
        rows.append((f"gradsync_{mode}", e["measured_s"] * 1e6,
                     f"reductions={e['reductions']};"
                     f"token_waits={e['token_waits']}"))

    # hierarchical two-axis leg on the (2 × 4) logical grid
    hier = bench_hierarchical(max(reps * 5, 10), elems, device)
    report["hierarchical"] = hier
    for name in ("hierarchical", "flat_ring", "native"):
        e = hier[name]
        rows.append((f"allreduce_{name}", e["measured_s"] * 1e6,
                     f"ppermute_calls={e['ppermute_calls']};"
                     f"reductions={e['reductions']}"))

    # fused-stage legs: per-stage HBM-bytes rows (≤0.6× bytes asserted)
    # and the flat ring lowered with and without the stage tier
    stage_report = bench_stages(smoke, device)
    report["stages"] = stage_report
    for name, e in stage_report.items():
        if isinstance(e, dict) and "measured_s" in e:
            rows.append((f"stage_{name}", e["measured_s"] * 1e6,
                         f"hbm_bytes={e['hbm_bytes']:.0f};"
                         f"class={e['overhead_class']}"))
    lowered_stages = bench_lowered_stages(max(reps * 5, 10), elems, device)
    report["lowered_stages"] = lowered_stages
    for name in ("unfused", "fused", "fused_bf16"):
        e = lowered_stages[name]
        rows.append((f"lowered_ring_{name}", e["measured_s"] * 1e6,
                     f"ppermute_calls={e['ppermute_calls']}"))

    # inter-axis butterfly rows (the inter family's constants)
    inter = bench_inter(max(reps * 5, 10), elems, device)
    report["inter"] = inter
    for name, e in inter.items():
        if isinstance(e, dict) and "measured_s" in e:
            rows.append((f"inter_{name}", e["measured_s"] * 1e6,
                         f"rounds={e['features']['rounds']:.0f}"))

    # compiled vs interpreted Level-A executors (host path)
    level_a = bench_level_a(smoke)
    report["level_a"] = level_a
    for executor in ("compiled", "interpreted"):
        for name, e in level_a[executor].items():
            rows.append((f"level_a_{executor}_{name}",
                         e["measured_s"] * 1e6,
                         f"payload_bytes={e['payload_bytes']};"
                         f"class={e['overhead_class']}"))

    # polling vs continuation notification over an in-flight sweep
    progress = bench_progress(smoke)
    report["progress"] = progress
    for backend in ("polling", "continuation"):
        for n in IN_FLIGHT_SWEEP:
            e = progress[backend][f"inflight_{n}"]
            rows.append((f"progress_{backend}_{n}", e["measured_s"] * 1e6,
                         f"tests={e['tests']};dispatches={e['dispatches']};"
                         f"ops_per_completion={e['ops_per_completion']:.2f}"))

    # the disabled tracer's cost (hard assert) and the drain rows
    obs_report = bench_obs(smoke)
    report["obs"] = obs_report
    for leg in ("null", "active"):
        e = obs_report[leg]
        rows.append((f"obs_{leg}", e["measured_s"] * 1e6,
                     f"rounds={e['features']['rounds']:.0f};"
                     f"class={e['overhead_class']}"))
    rows.append(("obs_overhead",
                 obs_report["overhead_fraction"] * 1e6,
                 f"fraction-ppm;max={OBS_MAX_OVERHEAD}"))

    # segmented vs unsegmented ring under the same model
    grad_bytes = report["grad_bytes"]
    un = schedule_ir.build("allreduce", "ring", REF_RANKS)
    seg = schedule_ir.build("allreduce", "ring", REF_RANKS, segments=4)
    report["segmented_ring"] = {
        "payload_bytes": grad_bytes,
        "unsegmented_s": un.cost(ALPHA, BETA, grad_bytes, gamma=GAMMA),
        "segments4_s": seg.cost(ALPHA, BETA, grad_bytes, gamma=GAMMA),
    }
    # the row namespaces this bench owns (tools/calibrate.py --gate)
    report["gate_scope"] = ["modes", "hierarchical", "stages",
                            "lowered_stages", "inter", "level_a",
                            "progress", "obs"]
    pathlib.Path(json_path).write_text(json.dumps(report, indent=2))
    rows.append(("gradsync_predict_json", 0.0, json_path))
    for r in rows:
        print_fn(f"{r[0]},{r[1]:.1f},{r[2]}")
    return rows


# ---------------------------------------------------------------------------
# Where the time of one sync goes (torch.profiler)
# ---------------------------------------------------------------------------
def _device_intervals(trace_path: str) -> List[Tuple[float, float]]:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset")]


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def profile_sync(mode: str) -> Dict[str, Any]:
    """One warm-up and one profiled ring :func:`run_sync` with the kernel
    tier on 4 ranks at full size on the card: wall seconds, the device's
    busy time (the union of kernel and copy intervals over all streams)
    and so its idle share, the summed device time, and the device
    activities with the most time."""
    from torch.profiler import ProfilerActivity, profile
    device = resolve_device()
    mesh = mesh_for(4, False, device)
    grads = make_grads(mesh.size, 0, device)
    run_sync(mode, device=device, grads=grads, mesh=mesh)   # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = run_sync(mode, device=device, grads=grads, mesh=mesh)
    del run["results"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        intervals = _device_intervals(path)
    busy_us = _union_us(intervals)
    summed_us = sum(b - a for a, b in intervals)
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(dev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    return {"mode": mode, "wall_s": run["seconds"], "device_busy_s": busy_us / 1e6,
            "device_summed_s": summed_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / run["seconds"],
            "launches": run["launches"],
            "top_device_us": {e.key[:60]: [e.self_device_time_total,
                                           e.count] for e in top}}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mode", default=None,
                        choices=("fused", "bucketed", "sentinel"),
                        help="profile one ring sync_grads of hubert-xlarge's "
                             "gradient on the card instead of the bench")
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--obs", action="store_true",
                        help="run only the disabled tracer's sentinel")
    parser.add_argument("--device", default=None,
                        help="the CUDA device unless named (e.g. cpu)")
    args = parser.parse_args(argv)
    if args.obs:
        out = bench_obs(smoke=args.smoke)
        print(f"obs_null,{out['null']['measured_s'] * 1e6:.1f},"
              f"events={out['events_per_drain']}")
        print(f"obs_active,{out['active']['measured_s'] * 1e6:.1f},"
              f"events={out['events_per_drain']}")
        print(f"obs_overhead,{out['overhead_fraction'] * 1e6:.1f},"
              f"fraction-ppm;guard_ns={out['guard_ns']:.1f}")
    elif args.mode is not None:
        if not torch.cuda.is_available():
            raise SystemExit("overlap bench: needs a CUDA device")
        print(json.dumps(profile_sync(args.mode)), flush=True)
    else:
        bench(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
