"""``run.py``'s refusals: no card, no program in the checkout, JAX or the
JAX package loaded; and the reference's independence of the program."""

import ast
import os
import subprocess
import sys
import types

import pytest
import torch

from port_bench import harness
from port_bench.tests import tiny

RUN = [sys.executable, str(tiny.BENCH / "run.py"), "--workload",
       "granite-3-2b.train-4k", "--seed", "1", "--seconds", "1"]


def _no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_run_fails_without_a_card():
    out = subprocess.run(RUN, capture_output=True, text=True, timeout=300,
                         env=_no_card_env(), cwd=tiny.REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_run_fails_where_only_the_benchmark_is(tmp_path):
    root = tiny.make_root(tmp_path)
    os.unlink(root / "src" / "repro_torch")
    cmd = [sys.executable, str(root / "port_bench" / "run.py")] + RUN[2:]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=_no_card_env(), cwd=root)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_with_jax_loaded_fails(tmp_path, monkeypatch):
    root = tiny.make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.BenchError, match="jax"):
        harness.execute(RUN[2:], root=root, device=torch.device("cpu"))


def test_a_reader_that_loads_jax_fails_the_run(tmp_path):
    """The import check runs after the per-layer readers: one that loads
    a module named ``jax`` leaves no result."""
    root = tiny.make_root(tmp_path)
    (root / "port_bench" / "metrics" / "mfu.train.py").write_text(
        "import sys, types\n\n\ndef read(run):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n"
        "    return 1.0\n")
    assert "jax" not in sys.modules
    try:
        with pytest.raises(harness.BenchError, match="jax"):
            harness.execute(RUN[2:] + ["--trace", "1"], root=root,
                            device=torch.device("cpu"))
    finally:
        sys.modules.pop("jax", None)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("x"))
    assert "repro_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro" in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (tiny.BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_harness_imports_no_jax():
    for path in tiny.BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"repro", "jax", "jaxlib", "flax"}, path


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_trace_sees_device_time(cuda_device):
    from port_bench import tracing
    t = tracing.Tracer(True)
    x = torch.randn(4096, 4096, device=cuda_device)
    with t.window():
        for _ in range(10):
            x = x @ x.T / 64
        torch.cuda.synchronize()
    s = t.summary()
    assert 0 < s.busy_s <= s.window_s
    assert sum(n for n, _ in s.ops.values()) >= 10
