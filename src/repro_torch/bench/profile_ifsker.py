"""Where IFSKer's time goes on the card.

Runs :func:`repro_torch.bench.ifsker.run_real` once per version at the
``chip_smoke.py`` size (the IFS O1280 grid: 6,599,680 points, 128 float64
fields, 4 logical ranks, 4 workers), after an unprofiled warm-up run with 4
fields on the same grid (so cuFFT's plans for this length exist), under
``torch.profiler`` and prints, per version: the steps' wall seconds, the
device busy time of the steps (the CUDA kernels' and copies' self time,
without the set-up's host-to-device copy of the initial fields) and so the
device's idle share, and the device activities and host operators with the
most time.  Run on a CUDA device::

    PYTHONPATH=src python -m repro_torch.bench.profile_ifsker [--steps N]
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.profiler import ProfilerActivity, profile

from . import ifsker
from .profile_gs import _device_us, _iteration_activity

GRID, FIELDS, RANKS = 6_599_680, 128, 4


def profile_version(version: str, steps: int) -> dict:
    kw = dict(n_ranks=RANKS, workers=RANKS, n_grid=GRID, steps=steps,
              seed=0, device="cuda")
    ifsker.run_real(version, **dict(kw, n_fields=RANKS, steps=1))  # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, stats = ifsker.run_real(version, n_fields=FIELDS, **kw)
    events = prof.key_averages()
    device = [e for e in events if _iteration_activity(e)]
    busy_us = sum(_device_us(e) for e in device)
    wall_s = stats["seconds"]
    top_dev = sorted(device, key=_device_us, reverse=True)[:6]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:8]
    return {
        "version": version, "steps": steps,
        "wall_s_per_step": wall_s / steps,
        "device_busy_s_per_step": busy_us / 1e6 / steps,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall_s
                              if busy_us else None),
        # name -> [total µs, calls]
        "top_device_us": {e.key[:60]: [_device_us(e), e.count]
                          for e in top_dev},
        "top_host_self_us": {e.key: [e.self_cpu_time_total, e.count]
                             for e in top_cpu},
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_ifsker: needs a CUDA device")
    for version in ifsker.VERSIONS:
        print(json.dumps(profile_version(version, args.steps)), flush=True)


if __name__ == "__main__":
    main()
