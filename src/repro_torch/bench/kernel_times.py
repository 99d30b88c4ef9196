"""Device time of every hand-written kernel at its main-path shape.

Runs the timing phases of ``chip_smoke.py`` (5, 9, 12, 15, 18 and 21:
CUDA-graph replay on cold data) from the checkout whose root is given
and prints one line, ``TIMES <root> <json>``, of device ms per call by
kernel and shape (and, for ``gs_stencil``, the eager wrapper's ms per
call and, where the checkout's phase 5 times it, ``copy_`` of the same
blocks).  With ``--main-path`` it first runs phase 4, the Gauss–Seidel
main path, and adds its wall seconds per iteration by version.  Two
checkouts compare on one card when one command runs them in turns
(parent, change, change, parent), each in a process of its own that
imports the package from ``<root>/src`` -- so run the file, not the
module (``-m`` would import this checkout's package first)::

    python3 src/repro_torch/bench/kernel_times.py <root> [--main-path]
"""

from __future__ import annotations

import json
import sys


def main(root: str, main_path: bool = False) -> dict:
    sys.path.insert(0, root + "/src")
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import collective_stages as stages
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import mlstm_chunk as mk
    from repro_torch.kernels import moe_gmm as mg
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    build.build()
    device = torch.device("cuda")
    out = {}
    if main_path:
        from repro_torch.bench import gauss_seidel as gs
        per_it, _ = cs.main_path(gs, stages, device)
        out.update({f"gs s/iteration {v}": s for v, s in per_it.items()})
        torch.cuda.empty_cache()
    t = cs.time_gs_stencil(stages, ref, device)
    out["gs_stencil"] = t["ms"]
    out.update({f"gs_stencil {k}": t[k] for k in ("wrapper_ms", "copy_ms")
                if k in t})
    t = cs.time_stage_kernels(stages, ref, device)
    for name in ("fused_combine", "quantize_wire", "dequantize_wire"):
        out[name] = t[name]["ms"]
    t = cs.time_flash_attention(fa, ref, device, (
        cs.GRANITE_PREFILL, cs.ZAMBA_PREFILL, cs.OLMOE_PREFILL))
    out.update({f"flash_attention {k}": v["ms"] for k, v in t.items()})
    out["mamba2_ssd"] = cs.time_mamba2_ssd(ssd, ref, device)["ms"]
    out["mlstm_chunk"] = cs.time_mlstm_chunk(mk, ref, device)["ms"]
    t = cs.time_moe_gmm(mg, ref, device)
    out.update({f"moe_gmm {k}": v["ms"] for k, v in t.items()})
    print("TIMES", root, json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--main-path"]
    main(args[0] if args else ".", "--main-path" in sys.argv[1:])
