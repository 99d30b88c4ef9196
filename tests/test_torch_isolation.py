"""``repro_torch`` stands alone: it imports neither ``jax`` nor anything of
the JAX package ``repro``, and its entry points default to CUDA and raise
on a host without it (the Gauss–Seidel and Level-B benches, the serving
CLI, ``LMAdapter``, the training CLI, the overlap, serving and LM-step
benches and their aggregator).  Both checks run in a fresh interpreter."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, importlib.abc, json, pkgutil, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro", "benchmarks"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
runpy.run_path(sys.argv[1], run_name="chip_smoke_imported")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"))

# the entry point with no device on a host without CUDA
import torch
from repro_torch.bench import gauss_seidel as gs
try:
    gs.run_real("pure", n_ranks=1, nby=1, nbx=1, bs=4, iters=1)
    no_device = "ran"
except RuntimeError as e:
    no_device = "raised: " + str(e)
from repro_torch.bench import overlap
try:
    overlap.run_sync("fused", shapes=[("w", (8,), torch.float32)])
    no_device_sync = "ran"
except RuntimeError as e:
    no_device_sync = "raised: " + str(e)
from repro_torch.launch import serve
try:
    serve.main(["--scale", "smoke", "--batch", "1", "--gen", "2"])
    no_device_serve = "ran"
except RuntimeError as e:
    no_device_serve = "raised: " + str(e)
from repro_torch import configs
from repro_torch.models import model as port_model
from repro_torch.serving.lm import LMAdapter
cfg = configs.smoke("granite-3-2b")
try:
    LMAdapter(cfg, port_model.init(cfg, device="cpu"), prompt_len=4,
              gen_len=2)
    no_device_lm = "ran"
except RuntimeError as e:
    no_device_lm = "raised: " + str(e)
from repro_torch.launch import train
try:
    train.main(["--scale", "smoke", "--steps", "1", "--batch", "1",
                "--seq", "8"])
    no_device_train = "ran"
except RuntimeError as e:
    no_device_train = "raised: " + str(e)
from repro_torch.bench import lm_step, run as bench_run, serve_bench
late = {}
for key, call in (
        ("no_device_overlap_bench", lambda: overlap.bench(smoke=True)),
        ("no_device_serve_bench", lambda: serve_bench.bench(smoke=True)),
        ("no_device_serve_trace",
         lambda: serve_bench.run_traced("unused.json")),
        ("no_device_lm_step", lambda: lm_step.bench(archs=["granite-3-2b"])),
        ("no_device_run", lambda: bench_run.main([]))):
    try:
        call()
        late[key] = "ran"
    except RuntimeError as e:
        late[key] = "raised: " + str(e)
print(json.dumps({**late, "modules": mods, "bad": bad, "cuda": torch.cuda
                  .is_available(), "no_device": no_device,
                  "no_device_sync": no_device_sync,
                  "no_device_serve": no_device_serve,
                  "no_device_lm": no_device_lm,
                  "no_device_train": no_device_train}))
"""


@pytest.fixture(scope="module")
def isolated():
    """One fresh interpreter with ``jax``/``repro`` imports blocked and no
    visible CUDA device; its report as a dict."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, str(ROOT / "chip_smoke.py")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_reference_package(isolated):
    out = isolated
    assert out["bad"] == []
    for mod in ("repro_torch.core.tac", "repro_torch.core.collectives",
                "repro_torch.kernels.collective_stages",
                "repro_torch.kernels.build",
                "repro_torch.bench.gauss_seidel", "repro_torch.obs.trace",
                "repro_torch.core.mesh", "repro_torch.core.lowering",
                "repro_torch.core.overlap", "repro_torch.core.pipeline",
                "repro_torch.bench.overlap", "repro_torch.core.resilience",
                "repro_torch.kernels.flash_attention",
                "repro_torch.kernels.mamba2_ssd",
                "repro_torch.kernels.mlstm_chunk",
                "repro_torch.kernels.moe_gmm",
                "repro_torch.bench.profile_serve",
                "repro_torch.models.model", "repro_torch.models.layers",
                "repro_torch.configs.granite_3_2b",
                "repro_torch.configs.zamba2_2p7b",
                "repro_torch.configs.xlstm_350m",
                "repro_torch.configs.olmoe_1b_7b",
                "repro_torch.serving.engine", "repro_torch.serving.lm",
                "repro_torch.serving.synthetic", "repro_torch.launch.serve",
                "repro_torch.optim", "repro_torch.data",
                "repro_torch.runtime.steps", "repro_torch.runtime.sharding",
                "repro_torch.runtime.spmd", "repro_torch.checkpoint",
                "repro_torch.launch.train", "repro_torch.launch.mesh",
                "repro_torch.bench.serve_bench", "repro_torch.bench.lm_step",
                "repro_torch.bench.run", "repro_torch.launch.dryrun",
                "repro_torch.analysis.op_cost", "repro_torch.bench.roofline",
                "repro_torch.bench.report"):
        assert mod in out["modules"]


def test_entry_point_without_device_raises_on_cuda_less_host(isolated):
    assert isolated["cuda"] is False
    for key in ("no_device", "no_device_sync", "no_device_serve",
                "no_device_lm", "no_device_train",
                "no_device_overlap_bench", "no_device_serve_bench",
                "no_device_serve_trace", "no_device_lm_step",
                "no_device_run"):
        assert isolated[key].startswith("raised:")
        assert "device='cpu'" in isolated[key]
