"""The port's trace CLI (``python -m repro_torch.obs``) against the JAX
package's (``python -m repro.obs``), and the traced Gauss–Seidel legs on
the CPU.

* Exit codes: 0 for a valid trace, 1 on a schema violation, 2 without a
  file; the printed summary equals the reference CLI's on the same files.
* The traced legs: the exported document is schema-valid and the
  interop-blk leg recorded task pause spans.  Which leg overlaps more is a
  matter of host timing, so no ordering is asserted here (the card run
  checks it through ``run_traced``'s own exit).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.obs import __main__ as jax_cli
from repro_torch import obs
from repro_torch.bench import gauss_seidel as gs
from repro_torch.core import simulate
from repro_torch.obs import __main__ as cli


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """A valid simulator trace and a copy with one schema violation."""
    d = tmp_path_factory.mktemp("traces")
    a = simulate.SimTask(0, 0, 0.2, kind=simulate.COMPUTE, name="compute")
    b = simulate.SimTask(1, 0, 0.0, kind=simulate.COMM_EVENTS,
                         event_deps=[(0, 0.3)], name="comm")
    c = simulate.SimTask(2, 1, 0.1, kind=simulate.COMM_PAUSED,
                         event_deps=[(0, 0.2)], name="wait")
    simulate.Simulator(2, 2, resume_overhead=0.01).run([a, b, c])
    good = d / "good.json"
    obs.export_trace(str(good), events=simulate.trace_events([a, b, c]),
                     extra={"benchmark": "oracle"})
    doc = json.loads(good.read_text())
    doc["traceEvents"][0]["ph"] = "Q"
    bad = d / "bad.json"
    bad.write_text(json.dumps(doc))
    return str(good), str(bad)


@pytest.mark.parametrize("which,status", [("good", 0), ("bad", 1)])
def test_cli_status_and_summary_equal_reference(traces, capsys, which,
                                                status):
    path = dict(zip(("good", "bad"), traces))[which]
    assert cli.main([path]) == status
    got = capsys.readouterr()
    assert jax_cli.main([path]) == status
    want = capsys.readouterr()
    assert got.out == want.out
    assert ("schema: OK" in got.out) == (status == 0)
    assert ("INVALID" in got.err) == (status == 1)


def test_cli_without_a_file_is_a_usage_error(capsys):
    assert cli.main([]) == 2
    assert "usage: python -m repro_torch.obs" in capsys.readouterr().err


def test_cli_as_a_module(traces):
    """``python -m repro_torch.obs`` exits with main()'s status."""
    good, bad = traces
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, (src, os.environ.get("PYTHONPATH")))))
    for path, status in ((good, 0), (bad, 1)):
        r = subprocess.run([sys.executable, "-m", "repro_torch.obs", path],
                           capture_output=True, text=True, timeout=120,
                           env=env)
        assert r.returncode == status, r.stderr


def test_gauss_seidel_traced_legs_on_the_cpu(tmp_path):
    path = tmp_path / "gs.json"
    events, overlaps, pauses = gs.trace_legs(str(path), smoke=True,
                                             device="cpu")
    doc = json.loads(path.read_text())
    assert obs.validate_trace(doc) == []
    assert set(doc["otherData"]["legs"]) == set(gs.TRACED_LEGS)
    assert pauses > 0
    assert all(0.0 <= f <= 1.0 for f in overlaps.values())
    assert cli.main([str(path)]) == 0
