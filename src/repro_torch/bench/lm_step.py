"""LM train/decode step timings at smoke size for all 10 archs — the port
of ``benchmarks/lm_step.py``.

A regression harness for the substrate: per arch, one train step
(``runtime.steps.build_train_step`` on ``launch.mesh.local_mesh(model=1)``,
a batch of 2 × 64, 3 steps timed after a warm-up) and, for causal archs,
one decode step (``runtime.steps.build_decode_step``, 10 steps timed after
a warm-up from a zeroed cache), with tokens/s derived.  Every timed loop
ends in a device synchronise.

On the card some train rows are not run, decided up front from the
config and printed as ``train_step_<arch>,0.0,not_run=<reason>``:

* ``no_backward_kernel`` — a block whose kernel has no backward (Mamba2,
  mLSTM, MoE: ``kernels.ops`` refuses grad for CUDA inputs);
* ``no_kernel_head_dim_<d>`` — attention of a head dim the
  ``flash_attention`` kernel does not take (deepseek-coder-33b's smoke
  size has 8).

Never a caught exception and never the plain version on the card.  On
the CPU every row runs (the kernels take their plain versions there)::

    PYTHONPATH=src python -m repro_torch.bench.lm_step [--device cpu]

CSV: name,us_per_call,derived
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from .. import configs, optim
from ..core.mesh import resolve_device
from ..kernels import flash_attention as _flash
from ..launch.mesh import local_mesh
from ..models import inputs, model
from ..models.config import ATTN, MAMBA2, MLSTM, MOE, SHARED_ATTN, SWA
from ..runtime import steps
from ..runtime.sharding import ShardingPolicy

B, S = 2, 64
TRAIN_STEPS, DECODE_STEPS = 3, 10
NO_BACKWARD_KERNEL = (MAMBA2, MLSTM, MOE)


def train_not_run(cfg, device: torch.device) -> Optional[str]:
    """Why ``cfg``'s train step cannot run through the kernels on
    ``device``, or ``None`` when it can (always on the CPU)."""
    if device.type != "cuda":
        return None
    kinds = {k for layer in cfg.pattern for k in layer}
    if kinds & set(NO_BACKWARD_KERNEL):
        return "no_backward_kernel"
    if kinds & {ATTN, SWA, SHARED_ATTN} and \
            cfg.head_dim not in _flash.HEAD_DIMS:
        return f"no_kernel_head_dim_{cfg.head_dim}"
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(print_fn=print, archs=None, device=None) -> list:
    """The train and decode rows of ``archs`` (all ten by default);
    returns them as ``(name, us_per_call, derived)``."""
    device = resolve_device(device)
    rows = []
    archs = archs or list(configs.ARCHS)
    opt_cfg = optim.OptimConfig()
    mesh = local_mesh(model=1, device=device)
    policy = ShardingPolicy(fsdp=False, tp=False, sp=False, remat=None)
    for arch in archs:
        cfg = configs.smoke(arch)
        state = steps.init_train_state(cfg, opt_cfg, 0, device=device)
        reason = train_not_run(cfg, device)
        if reason is not None:
            rows.append((f"train_step_{arch}", 0.0, f"not_run={reason}"))
        else:
            batch = inputs.make_batch(cfg, batch=B, seq=S, seed=0,
                                      device=device)
            step, _ = steps.build_train_step(cfg, mesh, policy, opt_cfg,
                                             donate=False)
            state, m = step(state, batch)           # warm-up
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                state, m = step(state, batch)
            _sync(device)
            dt = (time.perf_counter() - t0) / TRAIN_STEPS
            rows.append((f"train_step_{arch}", dt * 1e6,
                         f"tok_per_s={B * S / dt:.0f}"))

        if cfg.causal:
            params = state.params
            cache = model.init_cache(cfg, B, S, device=device)
            dec_batch = {"tokens": torch.zeros((B, 1), dtype=torch.long,
                                               device=device)}
            dec, _ = steps.build_decode_step(cfg, mesh, policy, batch=B,
                                             cache_len=S, donate=False)
            logits, cache = dec(params, cache, dec_batch, 0)    # warm-up
            _sync(device)
            t0 = time.perf_counter()
            for i in range(DECODE_STEPS):
                logits, cache = dec(params, cache, dec_batch, i + 1)
            _sync(device)
            dt = (time.perf_counter() - t0) / DECODE_STEPS
            rows.append((f"decode_step_{arch}", dt * 1e6,
                         f"tok_per_s={B / dt:.0f}"))
        del state
    for r in rows:
        print_fn(f"{r[0]},{r[1]:.1f},{r[2]}")
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="the CUDA device unless named (e.g. cpu)")
    args = p.parse_args(argv)
    bench(device=args.device)


if __name__ == "__main__":
    main()
