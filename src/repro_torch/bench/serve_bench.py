"""Serving benchmark: event-bound vs blocking-sentinel completion — the
port of ``benchmarks/serve_bench.py``.

Drives :class:`repro_torch.serving.ServingEngine` over a synthetic
multi-tenant trace — Poisson arrivals, two priority tenants, mixed
generation lengths — once per completion leg, on the same trace and the
same adapter (:class:`repro_torch.serving.SyntheticAdapter`: each device
micro-step sleeps ``dev_ms`` on a device-queue thread and computes on the
card, host detokenisation is real GIL-releasing work).  The structural
claim under test is the paper's: the blocking-sentinel leg parks one
runtime worker inside every device wait, so at most ``workers`` requests
make progress whatever the admitted slots, while the event-bound leg
(``tac.iwait`` → continuation engine) frees the worker at dispatch and
every in-flight chain advances at device latency.

Hard acceptance (exits non-zero on violation):

* the two legs emit bit-identical token streams;
* event-bound tokens/s >= blocking tokens/s;
* event-bound p99 latency <= blocking p99 latency.

Writes ``BENCH_serve_torch.json`` (never the JAX package's
``BENCH_serve.json``) with the calibration rows ``serve.event`` /
``serve.blocking`` (``measured_s``, linear cost features, ``overhead_class
"serve:<leg>"``) and ``gate_scope: ["serve"]``.  Features (per leg, both
legs identical): ``rounds`` = device micro-steps, ``wire_bytes`` =
device-occupancy proxy (micro-steps × device latency in µs),
``combine_bytes`` = host detok bytes (micro-steps × hash rounds × 64 KiB).

The adapter's computation runs on the CUDA device unless ``device`` names
another (and raises without one)::

    PYTHONPATH=src python -m repro_torch.bench.serve_bench [--smoke]
    PYTHONPATH=src python -m repro_torch.bench.serve_bench --trace T.json

CSV: name,us_per_call,derived
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

from ..core.mesh import resolve_device
from ..serving import Request, ServingEngine, SyntheticAdapter, token_at

HOST_BUF_BYTES = 64 * 1024
DEFAULT_JSON = "BENCH_serve_torch.json"


def make_trace(n: int, *, seed: int, rate_per_s: float,
               gen_choices) -> list:
    """Poisson multi-tenant trace: two priority classes, mixed lengths
    (numpy draws, so the reference's trace exactly)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for i in range(n):
        t += rng.exponential(1.0 / rate_per_s)
        reqs.append(Request(
            rid=i, prompt=100 + 17 * i,
            gen_len=int(rng.choice(gen_choices)),
            priority=int(rng.random() < 0.25),   # 25% batch tenant
            arrival_s=t))
    return reqs


def run_leg(leg: str, trace, adapter, *, slots: int, workers: int):
    """One engine run of ``trace`` (fresh requests) on completion leg
    ``leg``; exits non-zero unless every stream is ``token_at``'s."""
    engine = ServingEngine(adapter, slots=slots, completion=leg,
                           num_workers=workers)
    reqs = [Request(rid=r.rid, prompt=r.prompt, gen_len=r.gen_len,
                    priority=r.priority, arrival_s=r.arrival_s)
            for r in trace]
    report = engine.run(reqs)
    for r in reqs:
        want = [token_at(r.prompt, s) for s in range(r.gen_len)]
        if report.outputs[r.rid] != want:
            raise SystemExit(
                f"serve_bench: token parity violation on the {leg} leg, "
                f"request {r.rid}: got {report.outputs[r.rid]}, "
                f"want {want}")
    return report


def bench(*, smoke: bool = False, seed: int = 0,
          json_path: str = DEFAULT_JSON, print_fn=print,
          device=None) -> dict:
    """Both legs over one trace (64 requests, 24 when ``smoke``; 16 slots,
    4 workers, 30 ms device steps, 8 host hash rounds), each after an
    untimed warm pass; writes the JSON report and enforces the three
    gates."""
    if pathlib.Path(json_path).name == "BENCH_serve.json":
        raise ValueError(f"{json_path} is the JAX package's report; the "
                         f"port writes {DEFAULT_JSON}")
    device = resolve_device(device)
    n, gen_choices = (24, (4, 8, 12)) if smoke else (64, (8, 16, 24))
    slots, workers = 16, 4
    dev_ms, host_rounds = 30.0, 8
    trace = make_trace(n, seed=seed, rate_per_s=400.0,
                       gen_choices=gen_choices)
    total_steps = sum(r.gen_len for r in trace)
    features = {
        "rounds": float(total_steps),
        "wire_bytes": float(total_steps) * dev_ms * 1e3,
        "combine_bytes": float(total_steps) * host_rounds
                         * HOST_BUF_BYTES,
    }

    adapter = SyntheticAdapter(dev_ms=dev_ms, host_rounds=host_rounds,
                               streams=slots, device=device)
    adapter.warmup()
    report = {"requests": n, "slots": slots, "workers": workers,
              "dev_ms": dev_ms, "host_rounds": host_rounds,
              "device": str(device), "serve": {}}
    legs = {}
    try:
        for leg in ("event", "blocking"):
            # untimed warm pass: thread pools, runtime, code paths
            run_leg(leg, make_trace(4, seed=seed + 1, rate_per_s=1e6,
                                    gen_choices=(2,)),
                    adapter, slots=slots, workers=workers)
            rep = run_leg(leg, trace, adapter, slots=slots,
                          workers=workers)
            legs[leg] = rep
            report["serve"][leg] = {
                "measured_s": rep.wall_s,
                "features": features,
                "overhead_class": f"serve:{leg}",
                "tokens": rep.tokens,
                "tokens_per_s": rep.tokens_per_s,
                "p50_ms": rep.p50_ms,
                "p99_ms": rep.p99_ms,
            }
            print_fn(f"serve_{leg},"
                     f"{rep.wall_s / max(rep.tokens, 1) * 1e6:.1f},"
                     f"tok_s={rep.tokens_per_s:.0f};p50={rep.p50_ms:.1f};"
                     f"p99={rep.p99_ms:.1f}")
    finally:
        adapter.close()

    ev, bl = legs["event"], legs["blocking"]
    if ev.outputs != bl.outputs:
        raise SystemExit("serve_bench: the two legs' token streams differ")
    report["speedup_tokens_per_s"] = ev.tokens_per_s / bl.tokens_per_s
    report["p99_ratio"] = ev.p99_ms / bl.p99_ms
    report["gate_scope"] = ["serve"]
    pathlib.Path(json_path).write_text(json.dumps(report, indent=2))
    print_fn(f"serve_report_json,0.0,{json_path}")
    print_fn(f"serve_speedup,{report['speedup_tokens_per_s']:.2f},"
             f"p99_ratio={report['p99_ratio']:.2f}")

    if ev.tokens_per_s < bl.tokens_per_s:
        raise SystemExit(
            f"serve_bench: event-bound leg slower than blocking sentinel "
            f"({ev.tokens_per_s:.0f} vs {bl.tokens_per_s:.0f} tok/s) — "
            f"the task-aware completion path regressed")
    if ev.p99_ms > bl.p99_ms:
        raise SystemExit(
            f"serve_bench: event-bound p99 above blocking sentinel "
            f"({ev.p99_ms:.1f} vs {bl.p99_ms:.1f} ms) — the task-aware "
            f"completion path regressed")
    return report


def run_traced(trace_path: str, *, seed: int = 0, print_fn=print,
               device=None) -> float:
    """One event-bound serve run under the tracer: exports the serving
    micro-step timeline (device_step / detok spans, token instants, handle
    in-flight windows) as Perfetto JSON to ``trace_path`` and exits
    non-zero if it violates ``repro_torch.obs.SPAN_SCHEMA`` or holds no
    device_step span.  Returns the run's tokens/s."""
    from .. import obs

    device = resolve_device(device)
    trace = make_trace(16, seed=seed, rate_per_s=400.0,
                       gen_choices=(4, 8))
    adapter = SyntheticAdapter(dev_ms=10.0, host_rounds=4, streams=16,
                               device=device)
    adapter.warmup()
    try:
        with obs.tracing(capacity=1 << 18) as tr:
            rep = run_leg("event", trace, adapter, slots=16, workers=4)
            events = tr.events()
    finally:
        adapter.close()
    counts = obs.summarize(events)["counts"]
    doc = obs.export_trace(trace_path, events=events, extra={
        "benchmark": "serve_bench", "completion": "event",
        "tokens": rep.tokens, "tokens_per_s": rep.tokens_per_s,
        "p99_ms": rep.p99_ms, "device": str(device),
    })
    obs.assert_valid_trace(doc)
    if not counts.get("serving/device_step[X]"):
        raise SystemExit("serve_bench --trace: no device_step spans "
                         "recorded")
    print_fn(f"serve_trace_events,{len(events)},file={trace_path};"
             f"tokens={rep.tokens}")
    return rep.tokens_per_s


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", default=DEFAULT_JSON)
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="run one traced event-bound leg and write Perfetto "
                        "JSON here (skips the comparison bench)")
    p.add_argument("--device", default=None,
                   help="the CUDA device unless named (e.g. cpu)")
    args = p.parse_args(argv)
    if args.trace:
        run_traced(args.trace, seed=args.seed, device=args.device)
        return 0
    bench(smoke=args.smoke, seed=args.seed, json_path=args.json,
          device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
