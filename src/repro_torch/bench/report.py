"""The §Dry-run and §Roofline tables from dry-run JSON records — the port
of ``benchmarks/report.py``.

  PYTHONPATH=src python -m repro_torch.bench.report \\
      results/dryrun_torch.json > /tmp/tables.md

With ``--trace``, the arguments are trace-event JSON files instead
(``repro_torch.obs.export_trace`` artifacts, e.g. the ``--trace`` legs of
``bench.gauss_seidel`` / ``bench.ifsker`` / ``bench.serve_bench``) and
the output is the per-rank straggler and overlap tables derived from the
spans:

  PYTHONPATH=src python -m repro_torch.bench.report --trace trace-gs.json
"""

from __future__ import annotations

import json
import sys

from .roofline import analyze, HBM_BW, LINK_BW, PEAK_FLOPS


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def dryrun_table(records):
    out = ["| arch | shape | mesh | compile s | HBM GiB/dev | GFLOP/dev "
           "| coll GiB wire/dev | coll ops |",
           "|---|---|---|---|---|---|---|---|"]
    for r in records:
        if not r.get("ok"):
            out.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh','?')} "
                       f"| FAILED | — | — | — | — |")
            continue
        c = r["collectives"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compile_s']:.1f} "
            f"| {fmt_bytes(r['memory']['peak_device_bytes'])} "
            f"| {r['cost']['flops'] / 1e9:.0f} "
            f"| {c['total_wire_bytes'] / 2**30:.2f} "
            f"| {int(sum(c['counts'].values()))} |")
    return "\n".join(out)


def roofline_table(records):
    out = ["| arch | shape | t_compute s | t_mem adj s | t_mem raw s "
           "| t_collective s | dominant | useful | frac | fits HBM |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        a = analyze(r)
        if a is None:
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — "
                       f"| FAILED | — | — | — |")
            continue
        out.append(
            f"| {a['arch']} | {a['shape']} | {a['t_compute_s']:.3f} "
            f"| {a['t_memory_s']:.3f} | {a['t_memory_raw_s']:.3f} "
            f"| {a['t_collective_s']:.3f} "
            f"| **{a['dominant']}** | {a['useful_ratio']:.2f} "
            f"| {a['roofline_fraction']:.3f} "
            f"| {'yes' if a['fits_hbm'] else 'NO'} |")
    return "\n".join(out)


def collective_mix(records):
    out = ["| arch | shape | all-reduce | all-gather | reduce-scatter "
           "| all-to-all | permute |", "|---|---|---|---|---|---|---|"]
    for r in records:
        if not r.get("ok"):
            continue
        w = r["collectives"]["wire_bytes"]
        out.append(f"| {r['arch']} | {r['shape']} | "
                   + " | ".join(f"{w.get(k, 0) / 2**30:.2f}"
                                for k in ("all-reduce", "all-gather",
                                          "reduce-scatter", "all-to-all",
                                          "collective-permute")) + " |")
    return "\n".join(out)


def straggler_table(events):
    """Per-rank slowdown table from task run spans (``repro_torch.obs``
    traces).

    ``score`` is each rank's busy time over the median rank's — the
    per-rank straggler signal ``executor._straggler_service`` acts on,
    recomputed offline from the exported spans.
    """
    from ..obs import analysis

    scores = analysis.straggler_scores(events)
    overlap = analysis.per_rank_overlap(events)
    out = ["| rank | tasks | busy s | slowdown ×median | overlap |",
           "|---|---|---|---|---|"]
    for rank in sorted(scores):
        s = scores[rank]
        out.append(f"| {rank} | {s['tasks']} | {s['busy']:.4f} "
                   f"| {s['score']:.2f} "
                   f"| {overlap.get(rank, 0.0):.3f} |")
    return "\n".join(out)


def trace_report(paths, print_fn=print):
    """The ``--trace`` mode: straggler/overlap tables per trace file."""
    from ..obs import analysis, trace as trace_mod

    for path in paths:
        with open(path) as f:
            doc = json.load(f)
        problems = trace_mod.validate_trace(doc)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        summary = analysis.summarize(events)
        print_fn(f"\n### Trace: {path} ({summary['events']} events, "
                 f"{len(problems)} schema problems)\n")
        print_fn(f"overall overlap fraction: "
                 f"{summary['overlap_fraction']:.3f}\n")
        print_fn("#### Per-rank stragglers\n")
        print_fn(straggler_table(events))
        if problems:
            print_fn("\n#### Schema problems\n")
            for p in problems[:20]:
                print_fn(f"- {p}")


def main(argv=None, print_fn=print):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "--trace":
        trace_report(argv[1:], print_fn)
        return
    for path in argv:
        with open(path) as f:
            records = json.load(f)
        print_fn(f"\n### Records: {path} "
                 f"({sum(1 for r in records if r.get('ok'))}/{len(records)}"
                 f" ok)\n")
        print_fn("#### Dry-run\n")
        print_fn(dryrun_table(records))
        print_fn(f"\n#### Roofline (H100 SXM: {PEAK_FLOPS / 1e12:.0f} TF "
                 f"bf16, {HBM_BW / 1e9:.0f} GB/s HBM, "
                 f"{LINK_BW / 1e9:.0f} GB/s link)\n")
        print_fn(roofline_table(records))
        print_fn("\n#### Collective wire-bytes mix (GiB/dev)\n")
        print_fn(collective_mix(records))


if __name__ == "__main__":
    main()
