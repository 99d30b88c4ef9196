#!/usr/bin/env python
"""Times the PyTorch port's sharded decode step on logical ranks of one
card and reads what it moves, as ``chip_smoke.py``'s phases S3 and S4
serve: an arch at full width and depth, random bf16 weights from seed 0,
one request of 2048 prompt tokens on (1, 2) ``data`` x ``model`` ranks
under ``ShardingPolicy()``, then greedy decode steps.  After one untimed
decode step, each of ``--steps`` steps is timed alone (the card
synchronised around it) and the mesh's counters give the all-gather
operand bytes a step over the ranks, the FSDP weight gathers among them;
the card's peak over a step and its rise above the step's start are read
too.  The last line is one JSON object with every arch's numbers.

Usage (on a machine with a CUDA card)::

    PYTHONPATH=src python3 tools/torch_sharded_decode.py \\
        [--arch olmoe-1b-7b] [--arch zamba2-2.7b] [--steps 8]

It measures whichever ``repro_torch`` is first on ``PYTHONPATH``, so that
two trees of the package are compared by running it once with each.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

PROMPT = 2048
ARCHS = ("olmoe-1b-7b", "zamba2-2.7b", "xlstm-350m")


def measure(arch: str, n_steps: int) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.runtime import sharding, steps
    from repro_torch.runtime.sharding import ShardingPolicy
    cfg = configs.get(arch)
    pol = ShardingPolicy()
    mesh = make_mesh((1, 2), ("data", "model"), "cuda")
    net = model.init(cfg, 0, "cuda")
    params = steps.place_params(net, sharding.param_shardings(mesh, net,
                                                              pol))
    del net
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (1, PROMPT), generator=gen,
                         device="cuda")
    length = PROMPT + n_steps + 1
    prefill = steps.build_prefill_step(cfg, mesh, pol)
    decode, template = steps.build_decode_step(cfg, mesh, pol, batch=1,
                                               cache_len=length)
    logits, cache = prefill(params, {"tokens": toks})
    cache = sharding.place(model.pad_cache(cfg, sharding.gather(cache),
                                           length),
                           sharding.cache_shardings(mesh, template, pol))
    ms, rise, peak = [], 0, 0
    for i in range(n_steps + 1):
        nxt = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        if i == 1:
            mesh.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, {"tokens": nxt}, PROMPT + i)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
            top = torch.cuda.max_memory_allocated()
            peak, rise = max(peak, top), max(rise, top - start)
    fsdp = mesh.coll_tag_bytes.get(("all_gather", "fsdp"), [0])
    out = {"decode_ms": ms, "decode_ms_median": statistics.median(ms),
           "all_gather_bytes": sum(mesh.coll_bytes["all_gather"]) / n_steps,
           "fsdp_all_gather_bytes": sum(fsdp) / n_steps,
           "logits_shape": list(logits.shape),
           "peak_gib": peak / 2**30, "rise_mib": rise / 2**20}
    print(f"{arch} on (1, 2): decode {out['decode_ms_median']:.3f} ms a step "
          f"(median of {n_steps}); all-gather operand bytes a step "
          f"{out['all_gather_bytes']:.0f}, FSDP "
          f"{out['fsdp_all_gather_bytes']:.0f}; "
          f"card peak {out['peak_gib']:.3f} GiB, a step's rise "
          f"{out['rise_mib']:.1f} MiB", flush=True)
    del params, cache, logits, prefill, decode
    torch.cuda.empty_cache()
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", action="append")
    p.add_argument("--steps", type=int, default=8)
    args = p.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    out = {a: measure(a, args.steps) for a in args.arch or ARCHS}
    print(json.dumps({"card": smi, "archs": out}))


if __name__ == "__main__":
    main()
