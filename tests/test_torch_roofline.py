"""The port's roofline and report twins (``repro_torch.bench.roofline``,
``repro_torch.bench.report``) and ``bench.run``'s ``roofline`` section,
against the JAX package's ``benchmarks/roofline.py`` and
``benchmarks/report.py``.

* ``stage_rows``: the reference's byte counts and ratios; only the time
  column differs, by the card's HBM rate in place of v5e's.
* ``analyze`` of a record by hand arithmetic with the H100 constants.
* ``report.main`` of a port record (a smoke cell's dry run) writes the
  dry-run, roofline and collective tables; ``--trace`` the straggler
  table, whose text equals ``benchmarks.report.straggler_table``'s for
  the same simulated trace (``tests/test_obs.py``'s).
* ``bench.run``'s ``roofline`` section (the other sections stubbed) with
  and without a record file.
"""

import json

import pytest

from benchmarks import report as ref_report
from benchmarks import roofline as ref_roofline
from repro_torch.core import simulate
from repro_torch.core.simulate import COMPUTE, SimTask, Simulator
from repro_torch import configs
from repro_torch.bench import roofline, report, run
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ShapeConfig
from repro_torch.runtime.sharding import ShardingPolicy


def _rows(rows):
    return {name: dict(kv.split("=") for kv in derived.split(";"))
            for name, _, derived in rows}


def test_stage_rows_match_reference():
    mine, ref = _rows(roofline.stage_rows()), _rows(ref_roofline.stage_rows())
    assert mine.keys() == ref.keys()
    for name in mine:
        for k in ("fused_bytes", "unfused_bytes", "ratio"):
            assert mine[name][k] == ref[name][k], (name, k)
    us = {name: t for name, t, _ in roofline.stage_rows()}
    for name, t, derived in ref_roofline.stage_rows():
        assert us[name] == pytest.approx(t * ref_roofline.HBM_BW
                                         / roofline.HBM_BW)


def test_constants_are_the_cards():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert roofline.HBM_BYTES == 80 * 2**30


def _record(**over):
    rec = {"arch": "a", "shape": "train_4k", "mesh": "16x16", "ok": True,
           "n_devices": 256, "kind": "train", "active_params": 2_000_000,
           "tokens": 1 << 20,
           "cost": {"flops": 3.0e15, "bytes_accessed": 6.7e12,
                    "vmem_resident_bytes": 0.0},
           "collectives": {"total_wire_bytes": 9.0e10},
           "memory": {"peak_device_bytes": 20 * 2**30}}
    rec.update(over)
    return rec


def test_analyze_by_hand():
    a = roofline.analyze(_record())
    assert a["t_compute_s"] == pytest.approx(3.0e15 / 989e12)
    assert a["t_memory_s"] == pytest.approx(6.7e12 / 3.35e12)
    assert a["t_memory_raw_s"] == a["t_memory_s"]
    assert a["t_collective_s"] == pytest.approx(9.0e10 / 450e9)
    assert a["dominant"] == "compute"
    model_flops = 6 * 2_000_000 * (1 << 20)
    assert a["model_flops"] == model_flops
    assert a["useful_ratio"] == pytest.approx(model_flops / (3.0e15 * 256))
    assert a["roofline_fraction"] == pytest.approx(
        model_flops / (256 * 989e12) / (3.0e15 / 989e12))
    assert a["fits_hbm"] and a["hbm_gib"] == pytest.approx(20.0)
    big = roofline.analyze(_record(
        kind="prefill", memory={"peak_device_bytes": 81 * 2**30},
        collectives={"total_wire_bytes": 1e13}))
    assert big["dominant"] == "collective" and not big["fits_hbm"]
    assert big["model_flops"] == 2 * 2_000_000 * (1 << 20)
    assert roofline.analyze({"ok": False}) is None


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Two smoke cells' dry-run records and a failed one, as a file."""
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    recs = [dryrun.run_cell(configs.smoke(a), ShapeConfig(k + "_s", 64, 8, k),
                            multi_pod=False, policy=ShardingPolicy(),
                            mesh=mesh)
            for a, k in (("granite-3-2b", "train"), ("olmoe-1b-7b",
                                                     "prefill"))]
    recs.append({"arch": "x", "shape": "y", "mesh": "16x16", "ok": False})
    path = tmp_path_factory.mktemp("dry") / "dryrun_torch.json"
    path.write_text(json.dumps(recs))
    return path


def test_record_keys_match_reference(records):
    """The reference's record keys (``repro/launch/dryrun.py``
    ``run_cell``), so either package's tables read either's records."""
    rec = json.loads(records.read_text())[0]
    assert {"arch", "shape", "params", "active_params", "kind", "tokens",
            "seq_len", "global_batch", "mesh", "n_devices", "lower_s",
            "compile_s", "analyze_s", "memory", "cost", "collectives",
            "ok"} <= set(rec)
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "peak_device_bytes"} <= set(rec["memory"])
    assert {"flops", "bytes_accessed", "vmem_resident_bytes", "xla_flops",
            "xla_bytes"} <= set(rec["cost"])
    assert {"bytes", "wire_bytes", "counts", "total_bytes",
            "total_wire_bytes"} <= set(rec["collectives"])
    batch = 2 * (8 // 2) * 64 * 4       # a rank's int32 tokens and labels
    # the state is updated in place; the step count and the batch are not
    assert rec["memory"]["alias_bytes"] == \
        rec["memory"]["argument_bytes"] - 4 - batch
    for r in json.loads(records.read_text())[:2]:
        assert ref_roofline.analyze(r).keys() == roofline.analyze(r).keys()


def test_report_writes_three_tables(records):
    lines = []
    report.main([str(records)], print_fn=lines.append)
    text = "\n".join(lines)
    for head in ("#### Dry-run", "#### Roofline (H100 SXM: 989 TF bf16, "
                 "3350 GB/s HBM, 450 GB/s link)",
                 "#### Collective wire-bytes mix"):
        assert head in text
    assert "(2/3 ok)" in text
    assert "| granite-3-2b | train_s | 2x2 |" in text
    assert "| x | y | 16x16 | FAILED |" in text
    ref = ref_report.roofline_table(json.loads(records.read_text()))
    assert len(ref.splitlines()) == len(
        report.roofline_table(json.loads(records.read_text())).splitlines())


def _straggler_tasks():
    """``tests/test_obs.py``'s: rank 0 three times slower than the rest
    (the port's simulator, whose traces equal the reference's)."""
    tasks = []
    for r in range(4):
        for k in range(2):
            tasks.append(SimTask(len(tasks), r, 0.5 * (3.0 if r == 0
                                                       else 1.0),
                                 kind=COMPUTE, name=f"w[{r},{k}]"))
    return tasks


def test_straggler_table_matches_reference(tmp_path):
    tasks = _straggler_tasks()
    Simulator(4, 1).run(tasks)
    events = simulate.trace_events(tasks)
    assert report.straggler_table(events) == \
        ref_report.straggler_table(events)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    lines = []
    report.main(["--trace", str(path)], print_fn=lines.append)
    assert ref_report.straggler_table(events) in "\n".join(lines)


def test_run_roofline_section(records, tmp_path, monkeypatch, capsys):
    from repro_torch.bench import gauss_seidel, ifsker, lm_step, overlap
    for mod in (gauss_seidel, ifsker, overlap, lm_step):
        monkeypatch.setattr(mod, "bench", lambda device=None, **_: None)
    monkeypatch.chdir(tmp_path)
    assert run.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "roofline_stage_gs_stencil" in out
    assert "skipped (no results/dryrun_torch.json" in out
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "dryrun_torch.json").write_text(
        records.read_text())
    assert run.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "roofline_granite-3-2b_train_s_2x2," in out
    assert "roofline_x_y_16x16,0.0,FAILED" in out
