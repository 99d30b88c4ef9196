"""Readings of the control and of planted faults, against which a cell's
limits are set (not run by the benchmark's own runs).

    python3 port_bench/controls.py --workload granite-3-2b.train-4k \\
        --seeds 11 12 13

For each seed, at the cell's own sizes, the plain reference is put in the
program's place and compared with the fp32 reference by the cell's own
numbers:

* ``train_loop``: the control computes every product on fp8-rounded
  operands (the precision below the configuration's bf16); the fault
  ``half_batch`` computes the loss over the first half of each batch's
  positions.  One JSON line a seed and kind with the three numbers.
* ``serve_open_loop``: at every position of ``--prompts`` of the cell's
  prompts, the token the fp8 control puts first, and the fp32
  reference's best logit less its logit of that token; one JSON line a
  seed with the widest gap and the share of positions whose token
  differs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _run(cell, seed, device):
    from port_bench import harness, tracing
    return harness.Run(cell=cell, seed=seed, seconds=0.0, trace=False,
                       device=device, started=time.perf_counter(),
                       tracer=tracing.Tracer(False))


def train_readings(cell, seed, device):
    from port_bench.traffic import train_loop as tl
    run = _run(cell, seed, device)
    specs = run.reference().param_specs(cell.port)
    p = cell.params
    data = tl.TokenBatches(seed, p["batch"], p["seq"], cell.port["vocab"])
    want = tl.reference_run(run, specs, data)
    out = []
    for kind, kw in (("control_fp8", dict(precision="fp8")),
                     ("half_batch", dict(rows=slice(0, p["seq"] // 2)))):
        got = tl.reference_run(run, specs, data, **kw)
        out.append(dict(kind=kind, seed=seed, **tl.compare(got, want),
                        losses=got["losses"], ref_losses=want["losses"]))
    return out


@torch.no_grad()
def serve_readings(cell, seed, device, prompts_n):
    from port_bench import harness, weights
    from port_bench.reference import plain
    from port_bench.traffic import serve_open_loop as so
    run = _run(cell, seed, device)
    ref = run.reference()
    c, p = cell.port, cell.params
    seconds = harness.load_json(cell.bench.parent / "BENCHMARK.json")[
        "run_seconds"]
    n = len(so.arrivals(p["rate"], seconds, seed))
    prompts = weights.tokens(seed, 0, (n + p["slots"], p["prompt_len"]),
                             c["vocab"], device)
    plain.strict_fp32()
    W = {k: v.float() for k, v in weights.draw(
        ref.param_specs(c), seed, device, getattr(torch, c["dtype"])).items()}
    fp8 = plain.Matmul("fp8")
    worst, flips, total = 0.0, 0, 0
    for rid in so.sample({i: 0 for i in range(n)}, prompts_n, seed):
        toks = prompts[rid:rid + 1]
        want = ref.forward(W, toks, c)[0]
        pick = ref.forward(W, toks, c, fp8)[0].argmax(-1)
        gap = want.max(-1).values - want.gather(-1, pick[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        flips += int((pick != want.argmax(-1)).sum())
        total += pick.numel()
        del want, pick, gap
    return [dict(kind="control_fp8", seed=seed, token_gap=worst,
                 flipped=flips / total, positions=total)]


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from port_bench import harness
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--prompts", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload, ROOT)
    device = torch.device(args.device)
    for seed in args.seeds:
        t = time.perf_counter()
        if cell.kind == "train_loop":
            rows = train_readings(cell, seed, device)
        else:
            rows = serve_readings(cell, seed, device, args.prompts)
        for r in rows:
            r["s"] = time.perf_counter() - t
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
