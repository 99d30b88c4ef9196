"""Level-B gradient sync at full model size on logical ranks.

The port's twin of the lowered-stage legs of ``benchmarks/overlap_bench.py``
(``bench_lowered_stages``, ``bench_hierarchical``): the gradient tree of
hubert-xlarge (944,611,840 parameters, 13 leaves) is synchronised across
``n_ranks`` logical ranks on one device by
:func:`repro_torch.core.overlap.sync_grads` — ``fused``, ``bucketed`` or
``sentinel``, over a ring, a butterfly or the hierarchical two-axis
schedule, with the stage tier and wire dtype of choice.

On the card (``device`` defaults to CUDA and raises without it), where
one ring ``sync_grads`` call with the kernel tier spends its time::

    PYTHONPATH=src python -m repro_torch.bench.overlap --mode fused

``chip_smoke.py`` drives every configuration of this slice through
:func:`run_sync` and checks it.  On the CPU, pass ``device="cpu"`` and a
small tree (``shapes=``), e.g.
``run_sync("bucketed", device="cpu", shapes=[("w", (64, 17),
torch.float32)], bucket_bytes=1024)``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import lowering, schedule as schedule_ir
from ..core.mesh import LogicalMesh, resolve_device
from ..core.overlap import (DEFAULT_BUCKET_BYTES, _make_buckets,
                            sync_grads, tree_flatten, tree_unflatten)
from ..kernels import collective_stages as stages

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
                    bucket_bytes: int = DEFAULT_BUCKET_BYTES
                    ) -> Dict[str, Any]:
    """The counts one :func:`run_sync` must show, derived from the
    schedule and the bucketing (fp32 presentation): ``ppermute`` calls
    and sentinel waits per rank, and each kernel's launches over all
    ranks (zero unless ``stage_impl="cuda"`` on a CUDA device)."""
    shapes = hubert_xlarge_grad_shapes() if shapes is None else shapes
    sizes, _ = tree_flatten(_nest([(p, math.prod(s)) for p, s, _ in shapes]))
    n_red = (1 if mode == "fused"
             else len(_make_buckets([4 * s for s in sizes], bucket_bytes)))
    per = {k: 0 for k in KERNELS}
    if hierarchical:
        n_i = n_ranks // 2
        sched = schedule_ir.build_hierarchical(n_i, 2)
        per["fused_combine"] = (n_i - 1) + 1
    elif algorithm == "ring":
        sched = schedule_ir.build("allreduce", "ring", n_ranks,
                                  segments=segments)
        rs = (n_ranks - 1) * segments
        per["fused_combine"] = rs
        if stage_wire == "bf16":
            per["fused_combine"] += n_ranks * segments
        elif stage_wire == "int8":
            per["quantize_wire"] = rs + segments
            per["dequantize_wire"] = n_ranks * segments
    else:
        sched = schedule_ir.build("allreduce", algorithm, n_ranks)
        per["fused_combine"] = lowering.sends_per_rank(sched)
    pp = lowering.sends_per_rank(sched)
    if stage_wire == "int8":
        pp += 2 * (n_ranks - 1) * segments      # the scales' permutes
    launches = {k: (v * n_red * n_ranks if stage_impl == "cuda" else 0)
                for k, v in per.items()}
    return {"reductions": n_red, "ppermute_per_rank": pp * n_red,
            "token_waits_per_rank": n_red - 1 if mode == "sentinel" else 0,
            "launches": launches}


def _launches() -> Dict[str, int]:
    return {k: getattr(stages, k).launches for k in KERNELS}


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
    time of the call, device work included), ``ppermute_calls`` and
    ``token_waits`` per rank, and each stage kernel's ``launches`` in the
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
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    results = sync_grads(grads, mesh=mesh, axes=axes, mode=mode,
                         bucket_bytes=bucket_bytes, compress=compress,
                         algorithm=None if hierarchical else algorithm,
                         segments=segments, hierarchical=hierarchical,
                         stage_impl=stage_impl, stage_wire=stage_wire)
    sync()
    seconds = time.perf_counter() - t0
    after = _launches()
    return {"results": results, "seconds": seconds,
            "ppermute_calls": list(mesh.ppermute_calls),
            "token_waits": list(mesh.token_waits),
            "launches": {k: after[k] - before[k] for k in KERNELS}}


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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mode", default="fused",
                        choices=("fused", "bucketed", "sentinel"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("overlap bench: needs a CUDA device")
    print(json.dumps(profile_sync(args.mode)), flush=True)


if __name__ == "__main__":
    main()
