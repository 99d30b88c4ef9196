"""Where one training step's time goes on the card.

Builds ``--arch`` at full width and depth with random weights (seed 0) and
a fresh AdamW state, takes one untimed step of ``--batch`` x ``--seq``
tokens from the synthetic stream (warm-up: the allocator's growth,
cuBLAS's handles), then:

* one step through ``runtime.steps.build_train_step`` (auto mode, no
  remat) under ``torch.profiler``: wall ms, device busy ms (kernels' and
  copies' self time: one stream, so they do not overlap) and idle share,
  device ms by kind (the attention kernel, matrix products, elementwise
  passes, reductions, copies, the rest) and the activities with the most
  device time;
* one more step split into its phases by CUDA events (forward and
  loss, backward, optimizer update).

Run on a CUDA device::

    PYTHONPATH=src python -m repro_torch.bench.profile_train \\
        [--arch granite-3-2b] [--batch 1] [--seq 4096]
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import configs, optim
from ..core.overlap import tree_flatten, tree_unflatten
from ..data import SyntheticLMData, to_device
from ..launch.mesh import local_mesh
from ..models import model as model_lib
from ..runtime import steps
from ..runtime.sharding import ShardingPolicy
from .profile_serve import _phase


def _phases_ms(state, batch, cfg, opt_cfg) -> dict:
    """One step, its forward (with the loss), backward and optimizer
    update each timed by CUDA events on the current stream."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    steps._clear_grads(state.params)
    ev[0].record()
    total, _ = steps._loss_fn(state.params, batch, cfg, None)
    ev[1].record()
    total.backward()
    ev[2].record()
    leaves, treedef = tree_flatten(model_lib.param_tree(state.params))
    grads = tree_unflatten(treedef, [p.grad for p in leaves])
    steps._apply_update(opt_cfg, grads, state)
    ev[3].record()
    ev[3].synchronize()
    names = ("forward_ms", "backward_ms", "optimizer_ms")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def profile_step(arch: str, batch: int, seq: int) -> dict:
    cfg = configs.get(arch)
    opt_cfg = optim.OptimConfig()
    state = steps.init_train_state(cfg, opt_cfg, 0, device="cuda")
    fn, _ = steps.build_train_step(cfg, local_mesh(device="cuda"),
                                   ShardingPolicy(remat=None), opt_cfg)
    data = SyntheticLMData(cfg, batch=batch, seq=seq, seed=0)
    state, _ = fn(state, to_device(data.batch_at(0), "cuda"))
    b = to_device(data.batch_at(1), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = fn(state, b)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    out = {"arch": arch, "batch": batch, "seq": seq,
           "device": torch.cuda.get_device_name(0),
           "params": model_lib.param_count(state.params),
           "step": _phase(prof, wall_s, 1),
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    out["phases"] = _phases_ms(state, b, cfg, opt_cfg)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arch", default="granite-3-2b")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--seq", type=int, default=4096)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    print(json.dumps(profile_step(args.arch, args.batch, args.seq),
                     indent=1), flush=True)


if __name__ == "__main__":
    main()
