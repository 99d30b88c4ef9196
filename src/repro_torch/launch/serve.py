"""Serving CLI: continuous batching on the task runtime — the port of
``repro/launch/serve.py``.

Thin front-end over :class:`repro_torch.serving.engine.ServingEngine` with
the real model path (:class:`repro_torch.serving.lm.LMAdapter`):
``--batch`` requests are admitted through the engine's queue and decoded
greedily, each prefill/decode micro-step and host detokenisation a runtime
task, with device completion bound through the AsyncHandle protocol
(``--completion event``) or synchronised in-task (``--completion
blocking``, the sentinel baseline).  Weights are random, from ``--seed``.
It runs on the CUDA device unless ``--device`` names another::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --scale full --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --scale smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --scale smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \\
      --scale smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --scale smoke --device cpu
"""

from __future__ import annotations

import argparse
import sys

from .. import configs
from ..models import model
from ..serving import Request, ServingEngine
from ..serving.lm import LMAdapter


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="granite-3-2b")
    p.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    p.add_argument("--batch", type=int, default=4,
                   help="number of requests to serve")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--slots", type=int, default=4,
                   help="max in-flight requests (continuous batching)")
    p.add_argument("--completion", default="event",
                   choices=["event", "blocking"])
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--attn-impl", default=None, choices=["cuda", "ref"],
                   help="prefill attention: the Hopper kernel (default) "
                        "or its plain version")
    p.add_argument("--ssd-impl", default=None, choices=["cuda", "ref"],
                   help="prefill SSD scan of Mamba2 blocks: the Hopper "
                        "kernel (default) or its plain version")
    p.add_argument("--mlstm-impl", default=None, choices=["cuda", "ref"],
                   help="prefill scan of mLSTM blocks: the Hopper kernel "
                        "(default) or its plain version")
    p.add_argument("--moe-impl", default=None, choices=["cuda", "ref"],
                   help="expert products of MoE blocks, prefill and "
                        "decode: the Hopper kernel (default) or its plain "
                        "version")
    args = p.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.scale == "smoke" \
        else configs.get(args.arch)
    if not cfg.causal:
        print(f"[serve] {cfg.name} is encoder-only: no decode step")
        return 0
    params = model.init(cfg, args.seed, args.device)

    adapter = LMAdapter(cfg, params, prompt_len=args.prompt_len,
                        gen_len=args.gen, device=args.device,
                        attn_impl=args.attn_impl, ssd_impl=args.ssd_impl,
                        mlstm_impl=args.mlstm_impl,
                        moe_impl=args.moe_impl)
    adapter.warmup()

    engine = ServingEngine(adapter, slots=args.slots,
                           completion=args.completion,
                           num_workers=args.workers)
    requests = [Request(rid=i, prompt=args.seed * 1000 + i,
                        gen_len=args.gen) for i in range(args.batch)]
    report = engine.run(requests)

    print(f"[serve] arch={cfg.name} requests={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} slots={args.slots} "
          f"completion={args.completion} device={adapter.device}")
    print(f"[serve] {report.summary()}")
    sample = report.outputs[0][:16]
    print(f"[serve] sample continuation (req 0): {sample}")
    short = [r.rid for r in requests if len(report.outputs[r.rid]) != args.gen]
    if short:
        raise RuntimeError(f"requests {short} emitted fewer than {args.gen} "
                           f"tokens")
    return 0


if __name__ == "__main__":
    sys.exit(main())
