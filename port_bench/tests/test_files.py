"""The benchmark's files: BENCHMARK.json's shape, every cell and
configuration loadable with the traffic kind and readers it names, and a
cell that exists only as new files runs."""

import importlib
import json
import re

import pytest
import torch

from port_bench import harness
from port_bench.tests import tiny

SPEC = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["port_bench"]
    assert SPEC["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    c = harness.find_cell(cell, tiny.REPO)
    assert (c.bench / "configs" / f"{c.config_name}.json").is_file()
    assert (c.bench / "traffic" / f"{c.kind}.py").is_file()
    assert c.workload["why"] and c.limits
    reports = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reports and len(reports) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reports
        assert callable(harness.load_module("metrics", m["name"]).read)


CONFIGS = SPEC["configs"]


@pytest.mark.parametrize("config", [c["name"] for c in CONFIGS])
def test_config_files(config):
    entry = next(c for c in CONFIGS if c["name"] == config)
    cfg = json.loads((tiny.REPO / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert all(k in cfg for k in cfg["reduced"])
    assert all(not re.search(r"size|_dim|_rank|head|expand|state", k)
               for k in cfg["reduced"])
    ref = importlib.import_module(f"port_bench.reference.{cfg['reference']}")
    specs = ref.param_specs(cfg["port"])
    assert len({s[0] for s in specs}) == len(specs)


def test_a_new_cell_is_only_new_files(tmp_path):
    """A configuration, a workload and a per-layer metric added as new
    files and new BENCHMARK.json entries, nothing edited, run."""
    root = tiny.make_root(tmp_path)
    bench = root / "port_bench"
    cfg = json.loads((bench / "configs" / "granite-3-2b.json").read_text())
    cfg["port"].update(name="wide-granite", d_model=96, d_ff=192)
    # a new configuration served: granite has no Mamba2 block, so the
    # SSD reader finds nothing to read and is left out of the line
    (bench / "configs" / "wide-granite.json").write_text(json.dumps(cfg))
    wl = json.loads((bench / "workloads"
                     / "zamba2-2.7b.serve-score-4k.json").read_text())
    wl["params"].update(prompt_len=16, rate=10.0)
    (bench / "workloads" / "wide-granite.extra.json").write_text(
        json.dumps(wl))
    (bench / "metrics" / "requests.extra.py").write_text(
        "def read(run):\n    return float(run.record['requests'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="wide-granite",
                                file="port_bench/configs/wide-granite.json"))
    spec["workloads"].append({"name": "wide-granite.extra",
                              "config": "wide-granite", "traffic": "extra",
                              "chips": 1, "why": "a test's cell"})
    spec["per_layer"].append({"name": "requests.extra", "unit": "1",
                              "better": "higher", "source": "program_counter",
                              "layer": "serving engine",
                              "moves": "prompt_tokens_per_s",
                              "workloads": ["wide-granite.extra"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and m["name"] == "prompt_tokens_per_s":
            m["workloads"].append("wide-granite.extra")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = harness.execute(["--workload", "wide-granite.extra", "--seed",
                           "5", "--seconds", "1", "--trace", "1"],
                          root=root, device=torch.device("cpu"))
    assert out["correct"] and out["failed"] == 0
    assert out["metrics"]["requests.extra"]["value"] == out["attempted"]
    assert "mamba2_ssd_roofline.serve" not in out["metrics"]
