"""A sweep of offered rates over a serving cell, to find the highest rate
the program sustains (the knee) once; the cell's file then fixes its rate.
Not run by the benchmark's own runs.

    python3 port_bench/sweep.py --workload zamba2-2.7b.serve-score-4k \\
        --rates 2 4 6 8 --seconds 20 --seed 5

One process: the model is loaded and warmed up once, then each rate runs
the cell's traffic for ``--seconds``.  One JSON line a rate: the p50 and
p95 time to first token, the requests still waiting for their prefill at
the close, the seconds the engine took to drain after it, and the
requests served a second over the whole run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from port_bench import harness, weights
    from port_bench.traffic import serve_open_loop as so
    from repro_torch.models import model
    from repro_torch.serving.lm import LMAdapter
    from repro_torch.serving.request import Request
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload, ROOT)
    dev, _, _ = harness.device_info(cell.chips)
    prm = cell.params
    cfg = harness.port_config(cell)
    specs = cell.reference().param_specs(cell.port)
    n_max = max(len(so.arrivals(r, args.seconds, args.seed))
                for r in args.rates) + prm["slots"]
    prompts = weights.tokens(args.seed, 0, (n_max, prm["prompt_len"]),
                             cfg.vocab, dev)
    net = model.Model(cfg, dev)
    weights.load_into(net, weights.draw(specs, args.seed, dev,
                                        cfg.activation_dtype))
    adapter = LMAdapter(cfg, net, prompt_len=prm["prompt_len"],
                        gen_len=prm["gen_len"], device=dev,
                        prompt_tokens=lambda r: prompts[r.prompt:
                                                        r.prompt + 1])
    so.serve(adapter, prm,
              [Request(rid=i, prompt=i, gen_len=prm["gen_len"])
               for i in range(prm["slots"])])
    for rate in args.rates:
        due = so.arrivals(rate, args.seconds, args.seed)
        reqs = [Request(rid=i, prompt=i, gen_len=prm["gen_len"],
                        arrival_s=float(t)) for i, t in enumerate(due)]
        t0 = time.perf_counter()
        engine = so.serve(adapter, prm, reqs)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        first = {r.rid: r for r in engine.metrics.records if r.step == 0}
        ttft = [first[q.rid].t_emit - q.arrival_s for q in reqs
                if q.rid in first]
        late = sum(1 for q in reqs if q.rid in first
                   and first[q.rid].t_submit > args.seconds)
        print(json.dumps({
            "rate": rate, "requests": len(reqs), "served": len(ttft),
            "ttft_p50_ms": 1e3 * so.percentile(ttft, 50),
            "ttft_p95_ms": 1e3 * so.percentile(ttft, 95),
            "waiting_at_close": late,
            "drain_s": wall - args.seconds,
            "served_per_s": len(ttft) / wall}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
