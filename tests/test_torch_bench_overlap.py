"""The port's overlap bench (``repro_torch.bench.overlap``) against the
JAX package's ``benchmarks/overlap_bench.py``.

1. **The α-β model** — ``features``, ``serial_features``, ``predict``,
   the stage bytes and the bench's constants are ``==`` the reference's on
   fixed inputs, and the progress leg's test and dispatch counts per
   in-flight size too.  The reference values come from one subprocess:
   ``overlap_bench`` sets ``XLA_FLAGS`` when imported, which must not leak
   into this process (``tests/test_distributed.py``'s pattern).
2. **The bench on the CPU** — ``bench(smoke=True, device="cpu")`` runs
   every leg, prints the reference's row names, and its counts equal the
   derived ones; ``tools/calibrate.py`` fits the report unchanged and
   ``--apply`` writes ``predicted_calibrated_s``.  Two of the reference's
   hard asserts compare raw wall times of host code (the Level-A
   small-payload ratio, the disabled tracer's share), which a test run's
   own load moves past their thresholds, so here they are held on fixed
   reports at their thresholds, and the smoke run measures those legs
   without them; ``chip_smoke.py`` B1 runs the whole bench with every
   assert.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.bench import overlap
from repro_torch.core import schedule as S
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
LEAVES = [4096, 8, 300_000, 65_536, 1 << 20, 17, 4 << 20, 123_456, 2048]
SCHEDS = [("ring", 8, 1), ("ring", 8, 4), ("doubling", 8, 1),
          ("ring", 5, 1), ("doubling", 4, 1), ("ring", 2, 2)]
SIZES = [512.0, 65_536.0, float(1 << 24)]
BUCKETS = [1 << 16, 4 << 20]
CONSTANTS = ("ALPHA", "BETA", "GAMMA", "REF_RANKS", "INTER", "INTRA",
             "N_BATCHES", "STAGE_MAX_FUSED_RATIO", "LEVEL_A_RANKS",
             "LEVEL_A_ALGORITHMS", "LEVEL_A_ELEMS", "LEVEL_A_MAX_SMALL_RATIO",
             "IN_FLIGHT_SWEEP", "PROGRESS_OPS_BUDGET", "TEST_S",
             "DISPATCH_S", "OBS_MAX_OVERHEAD", "OBS_GUARD_LOOPS")

# Run by the reference's module and by this one: the same calls on the
# same inputs, ``ob`` the bench module, ``S`` its schedule IR.
PROBE = """
def probe(ob, S):
    out = {"constants": {k: getattr(ob, k) for k in CONSTANTS}}
    out["features"] = [ob.features(S.build("allreduce", a, n, segments=g), z)
                       for a, n, g in SCHEDS for z in SIZES]
    out["features_hier"] = [ob.features(S.build_hierarchical(4, 2), z)
                            for z in SIZES]
    out["serial"] = [ob.serial_features(S.build("allreduce", a, n), z)
                     for a, n, _ in SCHEDS for z in SIZES]
    out["predict"] = {f"{m}_{b}_{n}": ob.predict(m, LEAVES, b, n)
                      for m in ("fused", "bucketed", "sentinel")
                      for b in BUCKETS for n in (8, 4)}
    out["stage"] = {f"{w}_{f}": ob.stage_hbm_bytes(w, 1 << 18, f)
                    for w in ("fp32", "bf16", "int8") for f in (False, True)}
    out["gs"] = {str(f): ob.gs_stage_hbm_bytes(256, 512, f)
                 for f in (False, True)}
    out["progress"] = {}
    for backend in ("polling", "continuation"):
        for n in ob.IN_FLIGHT_SWEEP:
            _, drain, counters = ob._progress_setup(backend, n)
            drain()
            out["progress"][f"{backend}_{n}"] = list(counters())
    return out
"""


def _port_probe() -> dict:
    scope = dict(CONSTANTS=CONSTANTS, SCHEDS=SCHEDS, SIZES=SIZES,
                 LEAVES=LEAVES, BUCKETS=BUCKETS)
    exec(PROBE, scope)
    return json.loads(json.dumps(scope["probe"](overlap, S)))


@pytest.fixture(scope="module")
def reference() -> dict:
    code = "\n".join([
        "import json, sys",
        f"sys.path.insert(0, {str(ROOT)!r})",
        "from benchmarks import overlap_bench as ob",
        "from repro.core import schedule as S",
        f"CONSTANTS, SCHEDS, SIZES = {CONSTANTS!r}, {SCHEDS!r}, {SIZES!r}",
        f"LEAVES, BUCKETS = {LEAVES!r}, {BUCKETS!r}",
        PROBE,
        "print(json.dumps(probe(ob, S)))"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("part", ["constants", "features", "features_hier",
                                  "serial", "predict", "stage", "gs",
                                  "progress"])
def test_model_equals_the_reference(reference, part):
    assert _port_probe()[part] == reference[part]


@pytest.fixture(scope="module")
def smoke_report(tmp_path_factory):
    path = tmp_path_factory.mktemp("overlap") / "BENCH_overlap_torch.json"
    lines = []
    with pytest.MonkeyPatch.context() as mp:    # the wall-time gates: below
        mp.setattr(overlap, "bench_level_a", overlap.level_a_rows)
        mp.setattr(overlap, "bench_obs", overlap.obs_rows)
        rows = overlap.bench(print_fn=lines.append, smoke=True,
                             json_path=str(path), device="cpu")
    return rows, lines, path, json.loads(path.read_text())


def test_wall_time_gates_at_their_thresholds(monkeypatch):
    """``bench_level_a`` and ``bench_obs`` fail exactly beyond the
    reference's thresholds (0.98 and 2 %), on reports with fixed
    numbers."""
    def level_a(ratio):
        return lambda smoke=False: {"small_payload_ratio": ratio}

    def obs(fraction):
        return lambda smoke=False: {
            "overhead_fraction": fraction, "events_per_drain": 320,
            "guard_ns": 1.0, "null": {"measured_s": 1e-3}}

    for ratio, ok in ((0.5, True), (0.98, True), (0.9801, False),
                      (1.3, False)):
        monkeypatch.setattr(overlap, "level_a_rows", level_a(ratio))
        if ok:
            assert overlap.bench_level_a(True)["small_payload_ratio"] == ratio
        else:
            with pytest.raises(SystemExit, match="small-payload win"):
                overlap.bench_level_a(True)
    for fraction, ok in ((0.001, True), (0.02, True), (0.0201, False)):
        monkeypatch.setattr(overlap, "obs_rows", obs(fraction))
        if ok:
            assert overlap.bench_obs(True)["overhead_fraction"] == fraction
        else:
            with pytest.raises(SystemExit, match="guard-only"):
                overlap.bench_obs(True)


def _reference_row_names(consts: dict) -> list:
    """The reference's CSV rows, in its order (``overlap_bench.bench``)."""
    names = [f"gradsync_{m}" for m in ("fused", "bucketed", "sentinel")]
    names += [f"allreduce_{n}" for n in ("hierarchical", "flat_ring",
                                         "native")]
    names += [f"stage_combine_{w}_{v}" for w in ("fp32", "bf16", "int8")
              for v in ("unfused", "fused")]
    names += ["stage_gs_stencil_unfused", "stage_gs_stencil_fused"]
    names += [f"lowered_ring_{n}" for n in ("unfused", "fused",
                                            "fused_bf16")]
    names += ["inter_butterfly_2pods", "inter_butterfly_4pods"]
    names += [f"level_a_{x}_{a}_{e}" for x in ("compiled", "interpreted")
              for a in consts["LEVEL_A_ALGORITHMS"]
              for e in consts["LEVEL_A_ELEMS"]]
    names += [f"progress_{b}_{n}" for b in ("polling", "continuation")
              for n in consts["IN_FLIGHT_SWEEP"]]
    return names + ["obs_null", "obs_active", "obs_overhead",
                    "gradsync_predict_json"]


def test_bench_prints_the_reference_rows(reference, smoke_report):
    rows, lines, path, _ = smoke_report
    assert [r[0] for r in rows] == \
        _reference_row_names(reference["constants"])
    assert [ln.split(",")[0] for ln in lines] == [r[0] for r in rows]
    assert rows[-1] == ("gradsync_predict_json", 0.0, str(path))


def test_bench_counts_equal_the_derived_ones(smoke_report):
    *_, report = smoke_report
    assert report["device"] == {"type": "cpu", "name": "cpu"}
    assert report["gate_scope"] == ["modes", "hierarchical", "stages",
                                    "lowered_stages", "inter", "level_a",
                                    "progress", "obs"]
    modes = report["modes"]
    n_buckets = modes["bucketed"]["n_buckets"]
    assert n_buckets > 1 and modes["fused"]["n_buckets"] == 1
    assert modes["sentinel"]["n_buckets"] == n_buckets
    for mode, e in modes.items():
        red = 1 if mode == "fused" else n_buckets
        assert (e["reductions"], e["ppermute_calls"], e["token_waits"]) == \
            (red, 0, red - 1 if mode == "sentinel" else 0), mode
        assert e["ref_ranks"] == 8 and e["measured_s"] > 0
    assert modes["bucketed"]["bitwise_as_fused"]
    hier = report["hierarchical"]
    assert (hier["native"]["reductions"],
            hier["native"]["ppermute_calls"]) == (1, 0)
    assert hier["flat_ring"]["ppermute_calls"] == 14
    assert hier["hierarchical"]["ppermute_calls"] == \
        overlap.expected_counts("fused", hierarchical=True, n_ranks=8,
                                sizes=[1])["ppermute_per_rank"]
    for name, e in report["stages"].items():
        if isinstance(e, dict) and "launches" in e:
            assert not any(e["launches"].values()), name    # plain on CPU
    assert report["stages"]["combine_fp32_fused"]["max_abs_diff"] == 0.0
    assert report["stages"]["combine_bf16_fused"]["bytes_ratio"] <= 0.6
    level_a, obs = report["level_a"], report["obs"]
    assert level_a["small_payload_ratio"] > 0
    assert sorted(level_a["compiled"]) == sorted(level_a["interpreted"]) \
        == ["doubling_16384", "doubling_64", "ring_16384", "ring_64"]
    assert obs["events_per_drain"] > 0 and obs["overhead_fraction"] > 0


def test_calibrate_fits_the_port_report(smoke_report, tmp_path):
    *_, path, _ = smoke_report
    bench = tmp_path / "BENCH_overlap_torch.json"
    bench.write_text(path.read_text())
    out = tmp_path / "cal.json"
    r = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "calibrate.py"), "--bench",
         str(bench), "--out", str(out), "--apply"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    cal = json.loads(out.read_text())
    # every row with features: 3 modes, 2 of the two-axis legs (native
    # has no schedule), 8 stage, 3 lowered, 2 inter, 8 Level-A, 8
    # progress and 2 obs rows
    assert cal["n_rows"] == 36
    applied = json.loads(bench.read_text())
    assert "calibration" in applied
    for mode in ("fused", "bucketed", "sentinel"):
        assert applied["modes"][mode]["predicted_calibrated_s"] >= 0.0
    assert "predicted_calibrated_s" in applied["level_a"]["compiled"][
        "ring_64"]
    assert not (tmp_path / "CALIBRATION.json").exists()


def test_bench_never_writes_the_reference_reports(tmp_path):
    for name in ("BENCH_overlap.json", "BENCH_baseline.json"):
        with pytest.raises(ValueError, match="JAX package"):
            overlap.bench(json_path=str(tmp_path / name), device="cpu")


def test_expected_counts_of_the_native_psum():
    exp = overlap.expected_counts("bucketed", algorithm="native",
                                  stage_impl=None, n_ranks=8,
                                  sizes=[1 << 14, 1 << 14, 3], bucket_bytes=1)
    assert (exp["reductions"], exp["psum_per_rank"],
            exp["ppermute_per_rank"], exp["token_waits_per_rank"]) == \
        (3, 3, 0, 0)
    exp = overlap.expected_counts("sentinel", algorithm="native",
                                  n_ranks=8, sizes=[10, 10],
                                  bucket_bytes=1)
    assert exp["token_waits_per_rank"] == 1
    assert not any(exp["launches"].values())


def test_run_reports_a_failing_section_and_exits_1(monkeypatch, capsys):
    """``bench/run.py`` runs every section with the device it was given,
    prints ``<name>,0.0,FAILED`` for one that raises (a hard assert's
    ``SystemExit`` too) and exits 1."""
    from repro_torch.bench import gauss_seidel, ifsker, lm_step, run
    seen = []

    def ok(name):
        return lambda device=None, **_: seen.append((name, str(device)))

    def fails(device=None, **_):
        raise SystemExit("a hard assert")

    monkeypatch.setattr(gauss_seidel, "bench", ok("gauss_seidel"))
    monkeypatch.setattr(ifsker, "bench", fails)
    monkeypatch.setattr(overlap, "bench", ok("overlap"))
    monkeypatch.setattr(lm_step, "bench", ok("lm_step"))
    assert run.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "ifsker,0.0,FAILED" in out
    assert out.splitlines()[0] == "name,us_per_call,derived"
    assert seen == [("gauss_seidel", "cpu"), ("overlap", "cpu"),
                    ("lm_step", "cpu")]
    monkeypatch.setattr(ifsker, "bench", ok("ifsker"))
    assert run.main(["--device", "cpu"]) == 0
