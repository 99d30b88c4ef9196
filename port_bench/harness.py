"""The benchmark's entry: finds a cell's files by the names in
``BENCHMARK.json``, checks for the card, runs the cell's traffic kind, the
per-layer readers of a traced run, then the import check, and prints the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own under ``port_bench/``, found by name:

* ``configs/<config>.json``: the published sizes and the ``port`` section
  (the program's configuration fields) and ``reference`` (a module of
  ``reference/``);
* ``workloads/<cell>.json``: ``kind`` (a module of ``traffic/``), its
  parameters and the cell's ``limits``;
* ``metrics/<metric>.py``: ``read(run)`` of one per-layer metric, None
  where it finds nothing to read;
* ``kernels/<kernel>.py``: a kernel's operations and bytes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROGRAM = "repro_torch"


class BenchError(RuntimeError):
    """A run that cannot give a result; the message says why."""


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (from
    ``/proc``, so the interpreter's own start-up counts; the import time
    of this module where ``/proc`` is not there)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


def load_json(path: Path) -> Any:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise BenchError(f"{path} is missing") from None


def load_module(kind: str, name: str, bench: Path = BENCH):
    """``bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"{kind} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{kind}.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files."""
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]          # configs/<config>.json
    workload: Dict[str, Any]        # workloads/<cell>.json
    end_to_end: List[Dict]          # the metrics this cell reports
    per_layer: List[Dict]
    bench: Path

    @property
    def kind(self) -> str:
        return self.workload["kind"]

    @property
    def params(self) -> Dict[str, Any]:
        return self.workload["params"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]

    @property
    def port(self) -> Dict[str, Any]:
        return self.config["port"]

    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(
            f"port_bench.reference.{self.config['reference']}")


def _in_cell(metric: Dict, cell: str, reports: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reports


def find_cell(name: str, root: Path) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"BENCHMARK.json has no workload {name!r}")
    bench = root / "port_bench"
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reports = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"]
                 if _in_cell(m, name, reports)]
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"],
                config=load_json(bench / "configs" / f"{entry['config']}.json"),
                workload=load_json(bench / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, bench=bench)


def port_config(cell: Cell):
    """The program's ``ModelConfig`` built from the configuration file."""
    from repro_torch.models.config import ModelConfig
    fields = dict(cell.port)
    fields["pattern"] = tuple(tuple(layer) for layer in fields["pattern"])
    return ModelConfig(**fields)


def device_info(chips: int):
    """(device, name, count) of the card, or BenchError without one."""
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark runs only on the "
                         "card and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0), torch.cuda.get_device_name(0), chips


@dataclasses.dataclass
class Run:
    """What one run hands its readers and the result line."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float                  # process start, perf_counter clock
    tracer: Any = None              # tracing.Tracer
    summary: Any = None             # tracing.Summary of a traced run
    record: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    attempted: int = 0
    failed: int = 0
    correct: bool = False
    memory_peak: int = 0

    def check(self, name: str, value: float, limit: float) -> None:
        """One compared number beside its limit."""
        self.checks[name] = {"value": value, "limit": limit}

    def kernel(self, name: str):
        return load_module("kernels", name, self.cell.bench)

    def reference(self):
        return self.cell.reference()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def _per_layer(run: Run) -> Dict[str, Dict]:
    out = {}
    for m in run.cell.per_layer:
        value = load_module("metrics", m["name"], run.cell.bench).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(argv: Optional[List[str]] = None, *, root: Optional[Path] = None,
            device=None) -> Dict[str, Any]:
    """One run; returns the result line as a dict.  ``device`` given (a
    test's CPU run) skips the look for a card."""
    import argparse
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(root) if root is not None else BENCH.parent
    if not (root / "src" / PROGRAM).is_dir():
        raise BenchError(f"the program ({root / 'src' / PROGRAM}) is not "
                         f"in this checkout")
    cell = find_cell(args.workload, root)
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    kind, count = "cpu", 1
    if device is None:
        device, kind, count = device_info(cell.chips)
    from . import tracing
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=device, started=started,
              tracer=tracing.Tracer(bool(args.trace)))
    load_module("traffic", cell.kind, cell.bench).run(run)
    names = {m["name"] for m in cell.end_to_end}
    result: Dict[str, Any] = {
        "correct": run.correct, "attempted": run.attempted,
        "failed": run.failed}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": count, "memory_peak_bytes": run.memory_peak}
    if run.trace:
        result["metrics"] = _per_layer(run)
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
        result["device"] = dev
        result["breakdown"] = {"device_ops": run.summary.top_ops(),
                               "idle_gaps": run.summary.top_gaps()}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in run.metrics.items() if k in names}
        result["device"] = dev
    result["checks"] = run.checks
    # last, once the readers have run too: whatever they loaded counts
    found = forbidden_modules()
    if found:
        raise BenchError(f"modules loaded in this process: {found}")
    return result


def main(argv: Optional[List[str]] = None) -> int:
    try:
        result = execute(argv)
    except BenchError as exc:
        print(f"port_bench: {exc}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
