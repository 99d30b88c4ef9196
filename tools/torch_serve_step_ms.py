#!/usr/bin/env python
"""Times one request alone through the PyTorch port's serving adapter, step
by step, as ``chip_smoke.py``'s serving phases do: an arch at full width
and depth, random bf16 weights from seed 0, a prompt of 2048 tokens and
16 generated tokens, on the card.  Each request's prefill ms and its mean
decode ms a token are printed, after an untimed warm-up request; the last
line is one JSON object with every arch's numbers.

Usage (on a machine with a CUDA card)::

    PYTHONPATH=src python3 tools/torch_serve_step_ms.py \\
        [--arch zamba2-2.7b] [--arch xlstm-350m] [--repeats 3]

It times whichever ``repro_torch`` is first on ``PYTHONPATH``, so that two
trees of the package are compared by running it once with each.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

PROMPT, GEN = 2048, 16


def time_arch(arch: str, repeats: int) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.models import model as port_model
    from repro_torch.serving import Request
    from repro_torch.serving.lm import LMAdapter
    cfg = configs.get(arch)
    net = port_model.init(cfg, seed=0, device="cuda")
    adapter = LMAdapter(cfg, net, prompt_len=PROMPT, gen_len=GEN,
                        device="cuda")
    adapter.warmup()
    prefill, decode = [], []
    for i in range(repeats):
        req = Request(rid=-2 - i, prompt=12345 + i, gen_len=GEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle, state = adapter.prefill(req)
        handle.wait()
        t1 = time.perf_counter()
        for step in range(1, GEN):
            handle, state = adapter.decode(req, state, step)
            handle.wait()
        t2 = time.perf_counter()
        del state
        prefill.append((t1 - t0) * 1e3)
        decode.append((t2 - t1) * 1e3 / (GEN - 1))
        print(f"{arch} request {i}: prefill {prefill[-1]:.3f} ms, decode "
              f"{decode[-1]:.3f} ms/token", flush=True)
    del adapter, net
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill, "decode_ms_per_token": decode}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; repro_torch from {repro_torch.__file__}")
    out = {arch: time_arch(arch, args.repeats)
           for arch in args.arch or ["zamba2-2.7b"]}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
