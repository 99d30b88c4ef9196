"""A checkout of the benchmark at toy sizes, for the CPU tests: a copy of
``port_bench/`` with the program linked beside it, and cells of the same
kinds on configurations of the same families cut to a few channels."""

from __future__ import annotations

import copy
import json
import os
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "port_bench"

TINY_PORT = {
    "granite-3-2b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=128),
    "zamba2-2.7b": dict(n_layers=6, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=128, vocab=128, ssm_state=16, ssm_chunk=16),
}
# At these sizes a sound bf16 run's change of the masters reads up to
# ~2.2e-3 (5.8e-4 at the cell's size), the fp8 control's ~7e-3.
TINY_LIMITS = {"train_loop": {"change_gap": 5e-3}}
TINY_PARAMS = {
    "train_loop": dict(seq=32, batch=2),
    "serve_open_loop": dict(prompt_len=32, rate=20.0, check_requests=4),
}

SPEC = REPO / "BENCHMARK.json"


def make_root(tmp: Path, cells=None, spec_path: Path = SPEC) -> Path:
    """A checkout under ``tmp`` whose cells are those of ``spec_path`` (or
    ``cells``) at toy sizes."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    (root / "src").mkdir()
    os.symlink(REPO / "src" / "repro_torch", root / "src" / "repro_torch")
    spec = json.loads(spec_path.read_text())
    for name, cut in TINY_PORT.items():
        path = root / "port_bench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["port"].update(cut)
        path.write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        path = root / "port_bench" / "workloads" / f"{w['name']}.json"
        wl = json.loads(path.read_text())
        wl["params"].update(TINY_PARAMS[wl["kind"]])
        wl["limits"].update(TINY_LIMITS.get(wl["kind"], {}))
        path.write_text(json.dumps(wl))
    if cells is not None:
        spec = copy.deepcopy(spec)
        spec["workloads"] = cells
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
