"""Benchmark aggregator — the port of ``benchmarks/run.py``: one section
per paper table or figure.

  gauss_seidel — paper §7.1 Figs. 9-13 (5 versions, scaling, granularity)
  ifsker       — paper §7.2 Fig. 14
  overlap      — Level-B grad-sync schedules (beyond-paper)
  lm_step      — per-arch substrate regression timings
  roofline     — §Roofline terms from the dry-run records (if present:
                 ``results/dryrun_torch.json``, written by
                 ``repro_torch.launch.dryrun --all --out ...``)

Prints ``name,us_per_call,derived`` CSV lines.  A section that fails
prints its traceback and ``<name>,0.0,FAILED``, the other sections still
run, and the run exits 1.  Every section runs on the CUDA device unless
``--device`` names another::

    PYTHONPATH=src python -m repro_torch.bench.run [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import traceback

from ..core.mesh import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="the CUDA device unless named (e.g. cpu)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    from . import gauss_seidel, ifsker, lm_step, overlap, roofline
    print("name,us_per_call,derived")
    failures = 0
    for mod in (gauss_seidel, ifsker, overlap, lm_step, roofline):
        name = mod.__name__.split(".")[-1]
        print(f"# --- {name} ---", flush=True)
        try:
            mod.bench(device=device)
        except (Exception, SystemExit):  # noqa: BLE001 - report, go on
            failures += 1
            traceback.print_exc()
            print(f"{name},0.0,FAILED", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
