"""Roofline analysis over dry-run records — the port of
``benchmarks/roofline.py``.

Reads the JSON written by ``repro_torch.launch.dryrun`` (or by the
reference's ``repro.launch.dryrun``: the records share their keys) and
derives, per (arch × shape × mesh) cell, the three roofline terms on an
NVIDIA H100 SXM:

  compute   = FLOPs_per_device / PEAK_FLOPS          (989 TFLOP/s bf16 dense)
  memory    = bytes_per_device / HBM_BW              (3.35 TB/s)
  collective= wire_bytes_per_device / LINK_BW        (450 GB/s NVLink 4)

plus MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for training and
2·N·D for inference steps, the useful-compute ratio
MODEL_FLOPS / (FLOPs × n_devices), the dominant term, and the achieved
roofline fraction  model_time_bound / max(term)s.

The constants are the H100 SXM data sheet's (NVIDIA, "H100 Tensor Core
GPU" datasheet): 989 TFLOP/s dense bf16 Tensor Core, 3.35 TB/s HBM3, and
900 GB/s of NVLink 4 per GPU in both directions together, 450 GB/s each
way.  ``LINK_BW`` describes the production mesh, not one card: on one
card the logical ranks' collectives are copies within HBM, so the link
term models the 256- or 512-GPU mesh the records describe.  Such a mesh
spans nodes of 8 GPUs, whose InfiniBand links are slower than NVLink, so
the collective term is a lower bound.

CSV: name,us_per_call,derived   (us_per_call = dominant term in µs)
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, Optional

PEAK_FLOPS = 989e12      # bf16 dense, H100 SXM data sheet
HBM_BW = 3.35e12         # bytes/s, H100 SXM HBM3, data sheet
LINK_BW = 450e9          # bytes/s, NVLink 4 per GPU per direction
HBM_BYTES = 80 * 2**30   # H100 SXM: 80 GB of HBM3

# ---------------------------------------------------------------------------
# Fused collective-stage roofline (the hand-written stage kernels)
# ---------------------------------------------------------------------------
# Per-element HBM bytes of one reduce-scatter combine stage (fp32
# accumulator, the wire dtype on the received chunk) and of the fused
# Gauss–Seidel stencil stage.  The fused kernels read each operand and
# write the result ONCE; the unfused shape additionally materialises the
# fp32 cast/dequant intermediate (combine) or re-reads the block for the
# residual pass (stencil).  Every narrow-wire fused stage must come in at
# ≤ STAGE_MAX_FUSED_RATIO × the unfused bytes.
STAGE_MAX_FUSED_RATIO = 0.6
_ACC_B = 4
_WIRE_B = {"fp32": 4, "bf16": 2, "int8": 1}


def stage_bytes_per_elem(wire: str, fused: bool) -> int:
    per = _WIRE_B[wire] + 2 * _ACC_B          # read got + read acc + write
    if not fused and wire != "fp32":
        per += 2 * _ACC_B                     # fp32 temp: write + read back
    return per


def gs_stage_bytes_per_elem(fused: bool) -> int:
    return 2 * _ACC_B if fused else 4 * _ACC_B


def stage_rows(elems: int = 1 << 20):
    """Fused-vs-unfused stage roofline rows (always emitted — they are
    analytic, needing no dry-run record) + the hard bytes-ratio assert."""
    rows = []
    for wire in ("fp32", "bf16", "int8"):
        per_f = stage_bytes_per_elem(wire, True)
        per_u = stage_bytes_per_elem(wire, False)
        ratio = per_f / per_u
        assert wire == "fp32" or ratio <= STAGE_MAX_FUSED_RATIO, \
            (wire, ratio)
        t_f = per_f * elems / HBM_BW
        t_u = per_u * elems / HBM_BW
        rows.append((f"roofline_stage_combine_{wire}", t_f * 1e6,
                     f"fused_bytes={per_f * elems};"
                     f"unfused_bytes={per_u * elems};"
                     f"ratio={ratio:.3f};unfused_us={t_u * 1e6:.1f}"))
    per_f, per_u = gs_stage_bytes_per_elem(True), gs_stage_bytes_per_elem(
        False)
    ratio = per_f / per_u
    assert ratio <= STAGE_MAX_FUSED_RATIO, ratio
    rows.append(("roofline_stage_gs_stencil", per_f * elems / HBM_BW * 1e6,
                 f"fused_bytes={per_f * elems};"
                 f"unfused_bytes={per_u * elems};ratio={ratio:.3f};"
                 f"unfused_us={per_u * elems / HBM_BW * 1e6:.1f}"))
    return rows


def analyze(rec: Dict) -> Optional[Dict]:
    if not rec.get("ok"):
        return None
    n_dev = rec["n_devices"]
    flops_dev = rec["cost"]["flops"]
    bytes_dev = rec["cost"]["bytes_accessed"]
    vmem_dev = rec["cost"].get("vmem_resident_bytes", 0.0)
    wire_dev = rec["collectives"]["total_wire_bytes"]

    t_compute = flops_dev / PEAK_FLOPS
    # a reference record's bytes tagged VMEM-resident stay on chip in its
    # TPU kernels; the port's records have none
    t_memory = (bytes_dev - vmem_dev) / HBM_BW
    t_memory_raw = bytes_dev / HBM_BW
    t_coll = wire_dev / LINK_BW

    # useful model flops for this step
    mult = 6 if rec["kind"] == "train" else 2
    n_params = rec["active_params"]
    model_flops = mult * n_params * rec["tokens"]
    t_model = model_flops / (n_dev * PEAK_FLOPS)

    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_memory_raw_s": t_memory_raw,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": model_flops,
        "useful_ratio": model_flops / max(flops_dev * n_dev, 1.0),
        "roofline_fraction": t_model / max(bound, 1e-12),
        "hbm_gib": rec["memory"]["peak_device_bytes"] / 2**30,
        "fits_hbm": rec["memory"]["peak_device_bytes"] < HBM_BYTES,
    }


def bench(print_fn=print, path: str = "results/dryrun_torch.json",
          device=None):
    """The ``roofline`` section of ``bench.run``: the analytic stage rows,
    then one row per record of ``path`` when it exists.  ``device`` is
    accepted for ``bench.run``'s call: nothing here runs on a device."""
    rows = stage_rows()
    if not os.path.exists(path):
        for r in rows:
            print_fn(f"{r[0]},{r[1]:.1f},{r[2]}")
        print_fn(f"roofline,0.0,skipped (no {path}; run "
                 f"repro_torch.launch.dryrun --all --out {path})")
        return rows
    with open(path) as f:
        records = json.load(f)
    for rec in records:
        a = analyze(rec)
        if a is None:
            rows.append((f"roofline_{rec['arch']}_{rec['shape']}"
                         f"_{rec.get('mesh', '?')}", 0.0, "FAILED"))
            continue
        name = f"roofline_{a['arch']}_{a['shape']}_{a['mesh']}"
        dom_us = {"compute": a["t_compute_s"], "memory": a["t_memory_s"],
                  "collective": a["t_collective_s"]}[a["dominant"]] * 1e6
        rows.append((name, dom_us,
                     f"dominant={a['dominant']}"
                     f";frac={a['roofline_fraction']:.3f}"
                     f";useful={a['useful_ratio']:.2f}"
                     f";hbm={a['hbm_gib']:.1f}GiB"))
    for r in rows:
        print_fn(f"{r[0]},{r[1]:.1f},{r[2]}")
    return rows


if __name__ == "__main__":
    bench(path=sys.argv[1] if len(sys.argv) > 1 else
          "results/dryrun_torch.json")
