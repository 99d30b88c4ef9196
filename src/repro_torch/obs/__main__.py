"""Trace-file validation + summary CLI:
``python -m repro_torch.obs out.json``.

Validates each given trace file against
:data:`repro_torch.obs.SPAN_SCHEMA` (exit 1 on any violation) and
prints event counts, per-rank overlap fractions, and straggler scores.
"""

from __future__ import annotations

import json
import sys

from .analysis import summarize
from .trace import validate_trace


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else list(argv)
    if not paths:
        print("usage: python -m repro_torch.obs TRACE.json "
              "[TRACE.json ...]", file=sys.stderr)
        return 2
    status = 0
    for path in paths:
        with open(path) as fh:
            doc = json.load(fh)
        errors = validate_trace(doc)
        events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        summary = summarize(events)
        print(f"== {path}: {summary['events']} events, "
              f"ranks={summary['ranks']}, "
              f"wall={summary['wall_us'] / 1e3:.2f} ms")
        for key, n in summary["counts"].items():
            print(f"   {key:40s} {n}")
        print(f"   overlap fraction (all ranks): "
              f"{summary['overlap_fraction']:.3f}")
        for r, f in summary["per_rank_overlap"].items():
            print(f"   overlap[rank {r}] = {f:.3f}")
        for r, s in summary["straggler_scores"].items():
            print(f"   straggler[rank {r}]: busy={s['busy']:.4f}s "
                  f"tasks={int(s['tasks'])} score={s['score']:.2f}")
        if isinstance(doc, dict) and doc.get("otherData"):
            print(f"   otherData: {json.dumps(doc['otherData'])[:400]}")
        if errors:
            status = 1
            print(f"   INVALID: {len(errors)} schema violations",
                  file=sys.stderr)
            for err in errors[:10]:
                print(f"     {err}", file=sys.stderr)
        else:
            print("   schema: OK")
    return status


if __name__ == "__main__":
    sys.exit(main())
