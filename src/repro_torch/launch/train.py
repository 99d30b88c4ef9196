"""End-to-end training driver — the port of ``repro/launch/train.py``.

Wires together every substrate: config registry, synthetic data with
async prefetch (host task runtime), the train step (auto mode: on one
rank, or with ``--mesh NxM`` sharded over N x M logical ranks by the rule
table, FSDP over the data axis and TP/SP/EP over the model axis; or manual
data parallelism with an explicit grad-sync schedule), asynchronous
checkpointing bound to external events, preemption handling, and
step-granular restart.  Checkpoints are written in the reference's layout
(a sharded state is gathered first), so either package restores the
other's, onto any mesh.  Weights are random, from ``--seed``.  It runs on
the CUDA device unless ``--device`` names another.  Each log line gives
loss, lr and grad norm, as the reference's does, then seconds per step,
tokens per second, the peak of allocated device memory and the train
state's GiB on each rank::

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --scale full --steps 3 --batch 1 --seq 4096 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --scale smoke --steps 20 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch olmoe-1b-7b --scale smoke --steps 5 --grad-sync bucketed \\
      --mesh 4x1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --scale smoke --steps 5 --batch 8 --seq 64 --mesh 2x2
"""

from __future__ import annotations

import argparse
import signal
import sys
import time
from typing import Any, Dict, Optional

import torch

from .. import checkpoint as ckpt
from .. import configs, optim
from ..core.mesh import resolve_device
from ..data import Prefetcher, SyntheticLMData, to_device
from ..models import model
from ..runtime import steps
from ..core.overlap import tree_flatten
from ..runtime.sharding import ShardingPolicy, placed_bytes
from . import mesh as meshlib


def parse_mesh(spec: Optional[str], device=None):
    if not spec:
        return meshlib.local_mesh(device=device)
    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("data", "model")[:len(dims)] if len(dims) <= 2 else \
        ("pod", "data", "model")
    return meshlib.make_mesh(dims, axes, device)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="granite-3-2b")
    p.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--mesh", default=None, help="e.g. 4x1 (data x model)")
    p.add_argument("--grad-sync", default="auto",
                   choices=["auto", "fused", "bucketed", "sentinel"])
    p.add_argument("--remat", default=None, choices=[None, "full", "dots"])
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    return p


def run(argv=None) -> Dict[str, Any]:
    """Train as the CLI does; returns what it logged: ``log`` (one dict a
    log line: step, loss, lr, grad_norm, s_per_step, tokens_per_s,
    peak_gib), ``n_params``, ``device``, ``steps`` and ``state_gib`` (the
    train state's GiB on each rank)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    cfg = configs.smoke(args.arch) if args.scale == "smoke" \
        else configs.get(args.arch)
    if args.dtype:
        cfg = cfg.scaled(dtype=args.dtype)
    opt_cfg = optim.OptimConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                                total_steps=args.steps)
    mesh = parse_mesh(args.mesh, device)
    print(f"[train] arch={cfg.name} scale={args.scale} mesh={mesh.shape}"
          f" ranks={mesh.size} device={device}")

    manual = args.grad_sync != "auto"
    policy = ShardingPolicy(
        fsdp=not manual, tp=not manual, sp=not manual, remat=args.remat,
        grad_sync=args.grad_sync)

    sharded = not manual and mesh.size > 1
    if manual:
        step_fn = steps.build_train_step_manual(cfg, mesh, policy,
                                                opt_cfg)(None, None)
    else:
        step_fn, shardings = steps.build_train_step(cfg, mesh, policy,
                                                    opt_cfg, donate=False)
    state = steps.init_train_state(
        cfg, opt_cfg, args.seed, device=device,
        shardings=shardings if sharded else None)
    n_params = model.param_count(steps.abstract_params(cfg))
    print(f"[train] params: {n_params/1e6:.2f}M")

    data = SyntheticLMData(cfg, batch=args.batch, seq=args.seq,
                           seed=args.seed)
    start_step = 0
    saver = None
    if args.ckpt_dir:
        saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            aref = steps.abstract_reference_state(cfg)
            ref_state, start_step = ckpt.restore_checkpoint(
                args.ckpt_dir, aref, shardings=steps.state_shardings(
                    mesh, aref, policy) if sharded else None)
            state = steps.state_from_reference(cfg, ref_state,
                                               device=device)
            print(f"[train] restored checkpoint at step {start_step}")
    state_gib = [b / 2**30 for b in _state_bytes(state, mesh, sharded)]
    print(f"[train] train state per rank: "
          f"{', '.join(f'{g:.4g}' for g in state_gib)} GiB")

    prefetch = Prefetcher(data, start_step=start_step,
                          device_put_fn=lambda b: to_device(b, device))
    previous = None
    if saver is not None:
        previous = signal.getsignal(signal.SIGTERM)
        ckpt.install_preemption_handler(
            lambda: (saver.save(steps.state_to_reference(state), cur_step),
                     saver.wait_all()))

    tokens = args.batch * args.seq
    log = []
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = t_last = time.perf_counter()
    n_last = cur_step = start_step
    try:
        for cur_step in range(start_step, args.steps):
            batch = prefetch.get(cur_step)
            state, metrics = step_fn(state, batch)
            if (cur_step + 1) % args.log_every == 0 \
                    or cur_step == start_step:
                loss = float(metrics["loss"])
                gnorm = float(metrics["grad_norm"])
                if cuda:
                    torch.cuda.synchronize(device)
                now = time.perf_counter()
                per = (now - t_last) / (cur_step + 1 - n_last)
                t_last, n_last = now, cur_step + 1
                peak = (torch.cuda.max_memory_allocated(device) / 2**30
                        if cuda else None)
                log.append({"step": cur_step + 1, "loss": loss,
                            "lr": metrics["lr"], "grad_norm": gnorm,
                            "s_per_step": per,
                            "tokens_per_s": tokens / per, "peak_gib": peak})
                mem = f", peak {peak:.2f} GiB allocated" if cuda else ""
                print(f"[train] step {cur_step + 1}/{args.steps} "
                      f"loss={loss:.4f} lr={metrics['lr']:.2e} "
                      f"gnorm={gnorm:.3f} ({now - t0:.1f}s; "
                      f"{per:.3f} s/step, {tokens / per:.1f} tokens/s"
                      f"{mem}; state {max(state_gib):.4g} GiB a rank)")
            if saver is not None and (cur_step + 1) % args.ckpt_every == 0:
                saver.save(steps.state_to_reference(state),
                           cur_step + 1)  # async — does not block
        if cuda:
            torch.cuda.synchronize(device)
        if saver is not None:
            saver.save(steps.state_to_reference(state), args.steps)
    finally:
        prefetch.close()
        if saver is not None:
            saver.close()
            signal.signal(signal.SIGTERM, previous)

    losses = [e["loss"] for e in log]
    if len(losses) >= 2 and losses[-1] >= losses[0]:
        print("[train] WARNING: loss did not improve "
              f"({losses[0]:.4f} -> {losses[-1]:.4f}) — short runs on the "
              "synthetic stream are noisy")
    elif losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"log": log, "n_params": n_params, "device": str(device),
            "steps": args.steps - start_step, "state_gib": state_gib}


def _state_bytes(state, mesh, sharded: bool):
    """The train state's bytes on each rank: its blocks when sharded,
    else a whole replica on every rank."""
    if sharded:
        return placed_bytes((state.params, state.opt), mesh)
    leaves = list(state.params.parameters()) + [
        t for t in tree_flatten((state.opt.m, state.opt.v,
                                 state.opt.master))[0]]
    return [sum(t.numel() * t.element_size() for t in leaves)] * mesh.size


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
