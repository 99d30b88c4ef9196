"""Where one serving request's time goes on the card.

Builds ``--arch`` at full width and depth with random weights (seed 0),
serves one untimed warm-up request through :class:`repro_torch.serving.lm
.LMAdapter`, then runs one request of ``--prompt-len`` tokens and
``--gen`` generated tokens under ``torch.profiler``: first its prefill,
then its decode steps, each phase waited on before the next.  Prints, per
phase: the wall milliseconds (per token for decode), the device busy time
(the CUDA kernels' and copies' self time — one request runs on one
stream, so they do not overlap) and so the device's idle share, the
number of device activities per step, the device time by kind (the
hand-written kernels, matrix products, elementwise passes, reductions,
copies, the rest), the activities with the most device time, and the
host milliseconds spent inside each kind of block's forward (the sLSTM
blocks' Python loop against the rest; the MoE blocks' routing, dispatch
and expert products as a class of their own).  Run on a CUDA device::

    PYTHONPATH=src python -m repro_torch.bench.profile_serve \\
        [--arch zamba2-2.7b|granite-3-2b|xlstm-350m|olmoe-1b-7b] \\
        [--prompt-len 2048] [--gen 32]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile

from .. import configs
from ..models import model as model_lib
from ..serving import Request
from ..serving.lm import LMAdapter

# device activity kinds, by a substring of the kernel's name
KINDS = (("moe_gmm", "moe_gmm_"), ("mamba2_ssd", "mamba2_ssd_kernel"),
         ("mlstm_chunk", "mlstm_chunk_kernel"),
         ("flash_attention", "flash_attention_kernel"),
         ("matmul", "nvjet"), ("matmul", "gemm"), ("matmul", "sm90_xmma"),
         ("matmul", "cutlass"), ("elementwise", "elementwise_kernel"),
         ("reduction", "reduce_kernel"))


def _kind(name: str) -> str:
    for kind, key in KINDS:
        if key in name:
            return kind
    return "copy" if name.startswith("Memcpy") else "other"


def _phase(prof, wall_s: float, steps: int) -> Dict[str, object]:
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.key.startswith("Activity Buffer")]
    busy_us = sum(float(e.self_device_time_total) for e in device)
    by_kind: Dict[str, float] = {}
    for e in device:
        k = _kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + float(e.self_device_time_total)
    top = sorted(device, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {
        "wall_ms_per_step": wall_s * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "device_activities_per_step": sum(e.count for e in device) / steps,
        "device_ms_by_kind_per_step": {k: v / 1e3 / steps
                                       for k, v in sorted(by_kind.items())},
        # name -> [total ms, calls]
        "top_device_ms": {e.key[:70]: [float(e.self_device_time_total) / 1e3,
                                       e.count] for e in top},
    }


class BlockHostTime:
    """Host seconds inside each block class's ``forward`` (forward hooks on
    every block of the units), per class name; ``reset`` zeroes them."""

    def __init__(self, model: torch.nn.Module) -> None:
        self.seconds: Dict[str, float] = {}
        self._start: Dict[int, float] = {}
        for unit in model.units:
            for block in unit.blocks.values():
                block.register_forward_pre_hook(self._enter)
                block.register_forward_hook(self._leave)

    def _enter(self, module, args) -> None:
        self._start[id(module)] = time.perf_counter()

    def _leave(self, module, args, out) -> None:
        name = type(module).__name__
        self.seconds[name] = self.seconds.get(name, 0.0) + (
            time.perf_counter() - self._start.pop(id(module)))

    def reset(self) -> None:
        self.seconds.clear()

    def ms(self, steps: int) -> Dict[str, float]:
        return {k: v * 1e3 / steps for k, v in sorted(self.seconds.items())}


def profile_request(arch: str, prompt_len: int, gen: int) -> dict:
    cfg = configs.get(arch)
    model = model_lib.init(cfg, seed=0, device="cuda")
    blocks = BlockHostTime(model)
    adapter = LMAdapter(cfg, model, prompt_len=prompt_len, gen_len=gen,
                        device="cuda")
    adapter.warmup()
    req = Request(rid=0, prompt=1000, gen_len=gen)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    blocks.reset()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        handle, state = adapter.prefill(req)
        handle.wait()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    out = {"arch": arch, "prompt_len": prompt_len, "gen": gen,
           "device": torch.cuda.get_device_name(0),
           "prefill": _phase(prof, prefill_s, 1)}
    out["prefill"]["host_ms_in_blocks_per_step"] = blocks.ms(1)
    blocks.reset()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for step in range(1, gen):
            handle, state = adapter.decode(req, state, step)
            handle.wait()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    out["decode"] = _phase(prof, decode_s, gen - 1)
    out["decode"]["host_ms_in_blocks_per_step"] = blocks.ms(gen - 1)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arch", default="zamba2-2.7b")
    parser.add_argument("--prompt-len", type=int, default=2048)
    parser.add_argument("--gen", type=int, default=32)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")
    print(json.dumps(profile_request(args.arch, args.prompt_len, args.gen),
                     indent=1), flush=True)


if __name__ == "__main__":
    main()
