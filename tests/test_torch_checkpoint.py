"""The port's checkpoint module (``repro_torch.checkpoint``) against the JAX
package's ``repro.checkpoint``, on the CPU.

* The same on-disk format: a checkpoint written by either package restores
  in the other bitwise (float64, float32, bfloat16 as its uint16 bits,
  int64 scalars; nested dicts and lists), and both write the same manifest.
* ``tests/test_checkpoint.py``'s unit cases through the port: round trip,
  ``latest_step``, shape mismatch, the asynchronous save's dependency
  release and slot GC, restore after an injected rank death.
* The snapshot: a later in-place write does not reach the file.
* ``tests/test_e2e_parity.py``'s Gauss–Seidel elastic parities through the
  port (on the unfused float64 path its grids are also bitwise the
  reference's).  The reference's killed run goes in a subprocess that is
  started again, in a fresh directory, if it has not ended within
  ``ELASTIC_TIMEOUT`` seconds: the reference's runtime keeps two revoke
  races that can park its ``taskwait`` forever after an injected death
  (ROADMAP section 3; the port's ``core/tac.py`` fixed them), which would
  otherwise stop the whole test session (``tests/torch_elastic_guard.py``).
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro_torch import checkpoint as ckpt
from repro_torch.bench import gauss_seidel as gs
from repro_torch.core import tac
from torch_elastic_guard import reference_run_elastic

NOTIFY = ("polling", "continuation")


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _port_state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, dtype=torch.float64, generator=g),
            "layers": [{"k": torch.randn(5, generator=g),
                        "b": torch.randn(2, 3, generator=g)
                        .to(torch.bfloat16)},
                       {"k": torch.randn(5, generator=g), "b": None}],
            "opt": {"m": np.ones(5), "step": np.int64(3)}}


def _template():
    return {"w": np.empty((3, 4)),
            "layers": [{"k": np.empty(5), "b": np.empty((2, 3))},
                       {"k": np.empty(5)}],
            "opt": {"m": np.empty(5), "step": np.int64(0)}}


def test_round_trip_and_manifest(tmp_path):
    state = _port_state()
    d = str(tmp_path / "ck")
    path = ckpt.save_checkpoint(d, state, step=4)
    assert path.endswith("step_0000000004") and os.path.isdir(path)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 4
    assert [e["path"] for e in manifest["entries"]] == [
        "layers/0/b", "layers/0/k", "layers/1/k", "opt/m", "opt/step", "w"]
    assert manifest["entries"][0]["dtype"] == "bfloat16"
    restored, step = ckpt.restore_checkpoint(d, _template())
    assert step == 4
    assert isinstance(restored["w"], np.ndarray)
    np.testing.assert_array_equal(restored["w"], state["w"].numpy())
    b = restored["layers"][0]["b"]
    assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
    assert torch.equal(b, state["layers"][0]["b"])
    assert int(restored["opt"]["step"]) == 3
    on_dev, _ = ckpt.restore_checkpoint(d, _template(), device="cpu")
    assert isinstance(on_dev["w"], torch.Tensor)
    assert torch.equal(on_dev["w"], state["w"])
    assert torch.equal(on_dev["layers"][1]["k"], state["layers"][1]["k"])


def test_checkpoints_cross_packages_bitwise(tmp_path):
    import ml_dtypes
    state = _port_state()
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    ckpt.save_checkpoint(d_port, state, step=7)
    # the port's checkpoint restored by the JAX package
    got, step = jax_ckpt.restore_checkpoint(d_port, _template())
    assert step == 7
    np.testing.assert_array_equal(got["w"], state["w"].numpy())
    np.testing.assert_array_equal(got["layers"][1]["k"],
                                  state["layers"][1]["k"].numpy())
    assert got["layers"][0]["b"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got["layers"][0]["b"].view(np.uint16),
                                  _bf16_bits(state["layers"][0]["b"]))
    # the JAX package's checkpoint restored by the port
    jstate = {"w": state["w"].numpy(),
              "layers": [{"k": state["layers"][0]["k"].numpy(),
                          "b": _bf16_bits(state["layers"][0]["b"])
                          .view(ml_dtypes.bfloat16)},
                         {"k": state["layers"][1]["k"].numpy()}],
              "opt": {"m": np.ones(5), "step": np.int64(3)}}
    jax_ckpt.save_checkpoint(d_jax, jstate, step=7)
    back, step = ckpt.restore_checkpoint(d_jax, _template(),
                                         device="cpu")
    assert step == 7
    assert torch.equal(back["w"], state["w"])
    assert torch.equal(back["layers"][0]["b"], state["layers"][0]["b"])
    assert int(back["opt"]["step"]) == 3
    for name in ("port", "jax"):
        with open(tmp_path / name / "step_0000000007" / "manifest.json") as f:
            if name == "port":
                want = json.load(f)
            else:
                assert json.load(f) == want


def test_latest_step_and_explicit_step(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    for s in (1, 5, 3):
        ckpt.save_checkpoint(d, {"x": torch.full((2,), float(s))}, step=s)
    assert ckpt.latest_step(d) == 5
    r5, s5 = ckpt.restore_checkpoint(d, {"x": torch.empty(2)})
    assert s5 == 5 and r5["x"][0] == 5.0
    r3, s3 = ckpt.restore_checkpoint(d, {"x": torch.empty(2)}, step=3)
    assert s3 == 3 and r3["x"][0] == 3.0
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "nope"), {"x": np.empty(2)})


def test_restore_rejects_shape_mismatch(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, {"x": torch.zeros((2, 2))}, step=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(d, {"x": np.empty(3)})


def test_async_save_dependency_release(tmp_path, monkeypatch):
    """``save`` returns immediately; the EventHandle completes when the
    writer task has published the file; consecutive saves serialise
    through the checkpoint-dir region (steps publish in order)."""
    d = str(tmp_path / "ck")
    cp = ckpt.AsyncCheckpointer(d, keep=2)
    gate = threading.Event()
    orig_write = ckpt._write
    published = []

    def slow_write(base, host_state, step):
        gate.wait(timeout=30)           # hold the first save open
        path = orig_write(base, host_state, step)
        published.append(step)
        return path

    monkeypatch.setattr(ckpt, "_write", slow_write)
    try:
        h1 = cp.save({"x": torch.zeros(4)}, step=1)
        h2 = cp.save({"x": torch.ones(4)}, step=2)
        assert not h1.test() and not h2.test()   # save() did not block
        gate.set()
        assert h1.wait().endswith("step_0000000001")
        assert h2.wait().endswith("step_0000000002")
        assert published == [1, 2]      # inout region serialised them
    finally:
        gate.set()
        cp.close()
    assert cp.runtime.polling.num_services == 0


def test_async_save_snapshots_at_call_time(tmp_path):
    d = str(tmp_path / "ck")
    cp = ckpt.AsyncCheckpointer(d)
    x, arr = torch.arange(6.0), np.arange(3.0)
    cp.save({"x": x, "a": arr}, step=1)
    x.add_(100.0)       # in-place writes after save() must not reach it
    arr += 100.0
    cp.close()
    got, _ = ckpt.restore_checkpoint(d, {"x": torch.empty(6),
                                         "a": np.empty(3)})
    assert torch.equal(got["x"], torch.arange(6.0))
    np.testing.assert_array_equal(got["a"], np.arange(3.0))


def test_async_save_gc_keeps_latest(tmp_path):
    d = str(tmp_path / "ck")
    cp = ckpt.AsyncCheckpointer(d, keep=2)
    for s in range(1, 5):
        cp.save({"x": torch.full((3,), float(s))}, step=s)
    cp.close()
    assert ckpt.latest_step(d) == 4
    kept = sorted(int(n.split("_")[1]) for n in os.listdir(d)
                  if n.startswith("step_"))
    assert kept == [3, 4]


@pytest.mark.faults
def test_restore_after_injected_failure(tmp_path):
    """Checkpoint per step, a FaultInjector kills a rank mid-collective,
    survivors shrink and the resumed state comes from the LAST COMPLETED
    step, not the torn one."""
    from repro_torch.core import Collectives
    from repro_torch.core.resilience import FaultInjector, recover

    d = str(tmp_path / "ck")
    tac.init(tac.TASK_MULTIPLE)
    world = tac.CommWorld(4)
    coll = Collectives(world)
    inj = FaultInjector(world)
    state = torch.arange(8.0, dtype=torch.float64)
    ckpt.save_checkpoint(d, {"state": state}, step=0)

    def step_all(coll, state, n, key):
        out = coll.run_group(
            "allreduce", [{"value": state / n} for _ in range(n)], key=key)
        return out[0]

    state = step_all(coll, state, 4, "s1")
    ckpt.save_checkpoint(d, {"state": state}, step=1)
    inj.arm(2, after_ops=1)
    with pytest.raises(tac.RankFailedError):
        step_all(coll, state, 4, "s2")        # torn step: never published
    assert ckpt.latest_step(d) == 1           # no partial checkpoint
    g = recover(world)
    restored, step = ckpt.restore_checkpoint(
        d, {"state": torch.empty(8, dtype=torch.float64)})
    assert step == 1 and torch.equal(restored["state"], state)
    final = step_all(Collectives(g), restored["state"], 3, "s2r")
    np.testing.assert_allclose(final.numpy(), restored["state"].numpy(),
                               rtol=1e-12)


@pytest.mark.faults
@pytest.mark.parametrize("notify", NOTIFY)
def test_gauss_seidel_elastic_resume_matches_shrunken_reference(tmp_path,
                                                                notify):
    """The killed run's tail equals a CLEAN run at the shrunken size seeded
    from the same checkpoint step; on the float64 path both are bitwise
    the reference's killed run."""
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(bs=4, iters=4, seed=7, notify=notify, device="cpu")
    healed, info = gs.run_elastic(da, n_ranks=4, nby=3, nbx=3,
                                  kill_iter=3, kill_rank=1, **kw)
    assert info["recoveries"], info
    rec = info["recoveries"][0]
    assert rec["survivors"] == 3 and rec["resumed_step"] == 2
    assert info["decomposition"] == (3, 2, 6)   # re-shaped (3,1) grid
    state, step = ckpt.restore_checkpoint(
        da, {"grid": torch.empty(6 * 4, 6 * 4, dtype=torch.float64)},
        step=rec["resumed_step"])
    ckpt.save_checkpoint(db, state, step=step)
    clean, ic = gs.run_elastic(db, n_ranks=3, nby=2, nbx=6, **kw)
    assert not ic["recoveries"]
    assert torch.equal(healed, clean)
    want, winfo = reference_run_elastic("gauss_seidel",
                                        str(tmp_path / "jax"), n_ranks=4,
                                        nby=3, nbx=3, kill_iter=3,
                                        kill_rank=1, bs=4, iters=4, seed=7,
                                        notify=notify)
    np.testing.assert_array_equal(healed.numpy(), want)
    assert winfo["recoveries"] == info["recoveries"]
    for it, v in winfo["residuals"].items():
        assert abs(info["residuals"][it] - v) < 1e-9


@pytest.mark.faults
def test_gauss_seidel_elastic_backend_parity(tmp_path):
    """The killed + resumed trajectory itself is backend-invariant."""
    outs = {}
    for nb in NOTIFY:
        out, info = gs.run_elastic(str(tmp_path / nb), n_ranks=4, nby=3,
                                   nbx=3, bs=4, iters=3, kill_iter=2,
                                   kill_rank=2, seed=5, notify=nb,
                                   device="cpu")
        assert info["recoveries"]
        outs[nb] = out
    assert torch.equal(outs["polling"], outs["continuation"])
