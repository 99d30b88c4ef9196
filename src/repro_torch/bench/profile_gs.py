"""Where the Gauss–Seidel main path's time goes on the card.

Runs :func:`repro_torch.bench.gauss_seidel.run_real` once per version at the
``chip_smoke.py`` size (16384 x 16384 fp32 in 1024 x 1024 blocks, 4 logical
ranks, ``block_impl="cuda"``), after an unprofiled warm-up run of the same
size (so the allocator's cache already holds every generation), under
``torch.profiler`` and prints, per version: the iterations' wall seconds,
the device busy time of the iterations (the CUDA kernels' and copies' self
time, without the set-up's host-to-device copy of the initial grid — the
iterations copy nothing from the host) and so the device's idle share,
and the device activities and host operators with the most time.  Run on
a CUDA device::

    PYTHONPATH=src python -m repro_torch.bench.profile_gs [--iters N]
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.profiler import ProfilerActivity, profile

from . import gauss_seidel as gs


def _device_us(event) -> float:
    return float(event.self_device_time_total)


def _iteration_activity(event) -> bool:
    """A device activity (kernel or copy) of the iterations: host operators
    are skipped (their device time repeats their kernels'), and so are the
    set-up's host-to-device copy of the initial grid and the profiler's
    own buffer requests."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not event.key.startswith(("Memcpy HtoD",
                                          "Activity Buffer")))


def profile_version(version: str, iters: int) -> dict:
    kw = dict(n_ranks=4, workers=4, nby=8, nbx=8, bs=1024, iters=iters,
              seed=0, block_impl="cuda", device="cuda")
    gs.run_real(version, **kw)                          # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, stats = gs.run_real(version, **kw)
    events = prof.key_averages()
    device = [e for e in events if _iteration_activity(e)]
    busy_us = sum(_device_us(e) for e in device)
    wall_s = stats["seconds"]
    top_dev = sorted(device, key=_device_us, reverse=True)[:5]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:8]
    return {
        "version": version, "iters": iters,
        "wall_s_per_iter": wall_s / iters,
        "device_busy_s_per_iter": busy_us / 1e6 / iters,
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
    parser.add_argument("--iters", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gs: needs a CUDA device")
    for version in gs.VERSIONS:
        print(json.dumps(profile_version(version, args.iters)), flush=True)


if __name__ == "__main__":
    main()
