"""Traffic kind ``serve_open_loop``: requests offered to the program's
``ServingEngine`` over ``LMAdapter`` at a fixed rate, an open loop.

Arrivals: ``rate`` × ``--seconds`` requests, at a rate above what the
program sustains, so that it works at capacity through the window.  Their gaps are the
quantiles (i + 1/2) / n of the exponential distribution, so every seed
offers the same set of gaps, shuffled by the seed (a Poisson stream with
its sampling noise taken out), scaled so that the last request is due at
the window's close.  Each request has its own prompt of ``prompt_len``
token ids, uniform over the vocabulary, made on the device from the seed,
and asks for ``gen_len`` tokens.

Set-up builds the model with the benchmark's weights, the adapter and the
engine, and warms up by serving ``slots`` requests at once.  The window
is one ``ServingEngine.run`` over the requests; it drains the requests
still queued or in flight at the close.  ``prompt_tokens_per_s`` is the
prompt tokens of every request over the time from the window's start to
the last first token (``TokenRecord.t_emit``, on the engine's clock); a
request's time to first token runs from when it was due to that
emission.
Afterwards, with the program freed, the plain reference runs in fp32 over
``check_requests`` of the finished requests, drawn from the seed, and the
number compared is the widest gap by which a served token's logit lies
below the reference's best at its position.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import harness, weights
from port_bench.reference import plain


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s) of ``round(rate * seconds)`` requests: the exponential
    distribution's quantiles as gaps, shuffled by ``seed``, scaled to end
    at ``seconds``."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 11]))
    gaps = gaps[rng.permutation(n)]
    t = np.cumsum(gaps)
    return t * (seconds / t[-1])


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between the closest ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def serve(adapter, p, requests):
    """One ``ServingEngine.run`` of ``requests``; returns the engine."""
    from repro_torch.serving.engine import ServingEngine
    engine = ServingEngine(adapter, slots=p["slots"],
                           completion=p["completion"],
                           num_workers=p["workers"])
    engine.run(requests)
    return engine


def run(run: harness.Run) -> None:
    from repro_torch.models import model
    from repro_torch.serving.lm import LMAdapter
    from repro_torch.serving.request import Request
    p, dev = run.cell.params, run.device
    cfg = harness.port_config(run.cell)
    ref = run.reference()
    specs = ref.param_specs(run.cell.port)
    due = arrivals(p["rate"], run.seconds, run.seed)
    n, S = len(due), p["prompt_len"]
    prompts = weights.tokens(run.seed, 0, (n + p["slots"], S), cfg.vocab, dev)
    net = model.Model(cfg, dev)
    weights.load_into(net, weights.draw(specs, run.seed, dev,
                                        cfg.activation_dtype))
    adapter = LMAdapter(cfg, net, prompt_len=S, gen_len=p["gen_len"],
                        device=dev,
                        prompt_tokens=lambda req: prompts[req.prompt:
                                                          req.prompt + 1])
    # warm-up: as many requests at once as there are slots, on prompts
    # the window does not use
    warm = [Request(rid=i, prompt=n + i, gen_len=p["gen_len"])
            for i in range(p["slots"])]
    serve(adapter, p, warm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    requests = [Request(rid=i, prompt=i, gen_len=p["gen_len"],
                        arrival_s=float(t)) for i, t in enumerate(due)]
    with run.tracer.window():
        t0 = time.perf_counter()
        engine = serve(adapter, p, requests)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
    if dev.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(dev)
    first = {r.rid: r for r in engine.metrics.records if r.step == 0}
    done = [q for q in requests if q.rid in first
            and len(q.tokens) == q.gen_len]
    ttft = [first[q.rid].t_emit - q.arrival_s for q in done]
    queue = [first[q.rid].t_submit - q.arrival_s for q in done]
    prefill = [first[q.rid].t_emit - first[q.rid].t_submit for q in done]
    run.attempted, run.failed = n, n - len(done)
    run.metrics["setup_s"] = t0 - run.started
    if done:
        last = max(first[q.rid].t_emit for q in done)
        run.metrics["prompt_tokens_per_s"] = S * len(done) / last
    run.record.update(ttft_s=ttft, queue_s=queue, prefill_s=prefill,
                      window_s=t1 - t0, prompt_len=S, requests=len(done))
    if run.trace:
        run.summary = run.tracer.summary()
        run.tracer = None
    served = {q.rid: int(q.tokens[0][1]) for q in done}
    del engine, adapter, net, requests, warm, done
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gap = widest_gap(run, specs, prompts, served)
    run.check("token_gap", gap, run.cell.limits["token_gap"])
    run.correct = run.failed == 0 and gap <= run.cell.limits["token_gap"]


def sample(served: Dict[int, int], k: int, seed: int) -> List[int]:
    """``k`` of the finished requests' ids, drawn from the seed."""
    rids = sorted(served)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 13]))
    return sorted(rng.choice(rids, size=min(k, len(rids)),
                             replace=False).tolist())


def widest_gap(run: harness.Run, specs, prompts: torch.Tensor,
               served: Dict[int, int]) -> float:
    """The reference's best logit less its logit of the served token, at
    the last prompt position, widest over the checked requests."""
    if not served:
        return float("inf")
    c = run.cell.port
    plain.strict_fp32()
    W = {k: v.float() for k, v in weights.draw(
        specs, run.seed, run.device, getattr(torch, c["dtype"])).items()}
    ref = run.reference()
    worst = 0.0
    with torch.no_grad():
        for rid in sample(served, run.cell.params["check_requests"],
                          run.seed):
            logits = ref.forward(W, prompts[rid:rid + 1], c,
                                 last_only=True)[0, -1]
            worst = max(worst, float(logits.max() - logits[served[rid]]))
    del W
    gc.collect()
    return worst
