"""The port's serving bench (``repro_torch.bench.serve_bench``) against
the JAX package's ``benchmarks/serve_bench.py``.

``make_trace`` draws with numpy, so the port's trace is the reference's
request for request.  ``bench(smoke=True, device="cpu")`` holds its three
gates (bit-identical streams, event tokens/s ≥ blocking, event p99 ≤
blocking): the structural gap — 16 admitted slots against 4 runtime
workers, 30 ms device steps — gives the event leg a few times the
blocking leg's tokens/s.  ``run_traced`` writes a Perfetto document that
``obs.SPAN_SCHEMA`` accepts.
"""

import dataclasses
import json

import pytest

from benchmarks import serve_bench as jax_serve
from repro_torch import obs
from repro_torch.bench import serve_bench


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_trace_equals_the_reference(seed):
    for n, choices in ((24, (4, 8, 12)), (64, (8, 16, 24))):
        want = jax_serve.make_trace(n, seed=seed, rate_per_s=400.0,
                                    gen_choices=choices)
        got = serve_bench.make_trace(n, seed=seed, rate_per_s=400.0,
                                     gen_choices=choices)
        assert [(r.rid, r.prompt, r.gen_len, r.priority, r.arrival_s)
                for r in got] == \
            [(r.rid, r.prompt, r.gen_len, r.priority, r.arrival_s)
             for r in want]


def test_smoke_bench_holds_its_gates(tmp_path):
    path = tmp_path / "BENCH_serve_torch.json"
    lines = []
    report = serve_bench.bench(smoke=True, json_path=str(path),
                               print_fn=lines.append, device="cpu")
    assert json.loads(path.read_text()) == json.loads(json.dumps(report))
    assert [ln.split(",")[0] for ln in lines] == \
        ["serve_event", "serve_blocking", "serve_report_json",
         "serve_speedup"]
    ev, bl = report["serve"]["event"], report["serve"]["blocking"]
    assert ev["tokens"] == bl["tokens"] == sum(
        r.gen_len for r in serve_bench.make_trace(
            24, seed=0, rate_per_s=400.0, gen_choices=(4, 8, 12)))
    assert report["speedup_tokens_per_s"] >= 1.0
    assert report["p99_ratio"] <= 1.0
    assert ev["features"] == bl["features"]
    assert report["gate_scope"] == ["serve"]
    assert (report["requests"], report["slots"], report["workers"]) == \
        (24, 16, 4)


def test_traced_leg_is_a_valid_trace(tmp_path):
    path = tmp_path / "serve_trace.json"
    lines = []
    tps = serve_bench.run_traced(str(path), print_fn=lines.append,
                                 device="cpu")
    doc = json.loads(path.read_text())
    obs.assert_valid_trace(doc)
    assert tps > 0 and lines[0].startswith("serve_trace_events,")
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "device_step" in names


def test_bench_never_writes_the_reference_report(tmp_path):
    with pytest.raises(ValueError, match="JAX package"):
        serve_bench.bench(json_path=str(tmp_path / "BENCH_serve.json"),
                          device="cpu")


def test_request_fields_are_the_references():
    assert [f.name for f in dataclasses.fields(
        serve_bench.make_trace(1, seed=0, rate_per_s=1.0,
                               gen_choices=(1,))[0])][:5] == \
        ["rid", "prompt", "gen_len", "priority", "arrival_s"]
