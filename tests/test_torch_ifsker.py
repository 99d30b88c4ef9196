"""Port parity: the IFSKer benchmark of ``repro_torch`` against the JAX
package's ``benchmarks/ifsker.py``, on the CPU.

* ``run_real``: every version under both notify backends within 1e-12 of
  the reference's (both start from the same numpy draws; physics' ``tanh``
  and cube and the torch against numpy FFTs differ by a few ulps: measured
  2e-15 on fields of magnitude ~2), and the port's three versions bitwise
  equal to one another.
* ``run_elastic``: a run that loses a rank mid-transposition, shrinks and
  resumes equals the clean full-size run bitwise (``tests/test_e2e_parity.py``)
  and the reference's clean run within 1e-12 (that run in a subprocess
  killed and started again after 120 s, at most 3 times:
  ``tests/torch_elastic_guard.py``).
* the traced leg's exported trace is schema-valid (no wall-clock ordering
  is asserted).
"""

import functools

import numpy as np
import pytest
import torch

from benchmarks import ifsker as jax_ifsker
from repro_torch.bench import ifsker
from torch_elastic_guard import reference_run_elastic

NOTIFY = ("polling", "continuation")
SIZES = {"default": {},
         "wide": dict(n_ranks=4, workers=3, n_fields=12, n_grid=96,
                      steps=4, seed=5)}
TOL = 1e-12


@functools.lru_cache(maxsize=None)
def _reference(size):
    return jax_ifsker.run_real("pure", **SIZES[size])[0]


@functools.lru_cache(maxsize=None)
def _port_pure(size):
    return ifsker.run_real("pure", device="cpu", **SIZES[size])[0]


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("notify", NOTIFY)
@pytest.mark.parametrize("version", ifsker.VERSIONS)
def test_run_real_matches_reference(version, notify, size):
    out, stats = ifsker.run_real(version, notify=notify, device="cpu",
                                 **SIZES[size])
    want = _reference(size)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    assert out.device.type == "cpu" and tuple(out.shape) == want.shape
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=TOL)
    assert torch.equal(out, _port_pure(size))
    assert stats["seconds"] > 0


def test_physics_and_spectral_step_match_reference():
    x = np.random.default_rng(2).standard_normal(4099) * 3
    t = torch.from_numpy(x)
    np.testing.assert_allclose(ifsker.physics(t).numpy(),
                               jax_ifsker.physics(x), rtol=0, atol=TOL)
    np.testing.assert_allclose(ifsker.spectral_step(t).numpy(),
                               jax_ifsker.spectral_step(x), rtol=0, atol=TOL)


def test_run_real_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ifsker.run_real("pure")


@pytest.mark.parametrize("kw,match", [
    (dict(version="hybrid"), "version"),
    (dict(version="pure", n_ranks=3), "divide")])
def test_run_real_rejects_bad_arguments(kw, match):
    with pytest.raises(ValueError, match=match):
        ifsker.run_real(device="cpu", **kw)


def test_run_real_frees_its_fields_without_gc():
    """run_real's task closures form reference cycles with its frame; the
    slices, exchange blocks and spectra must be freed when it returns,
    not at the collector's next pass."""
    import gc

    def live():
        return sum(1 for o in gc.get_objects()
                   if issubclass(type(o), torch.Tensor) and o.dtype in
                   (torch.float64, torch.complex128))

    gc.collect()
    gc.disable()
    try:
        before = live()
        out, stats = ifsker.run_real("interop-nonblk", device="cpu")
        del out, stats
        assert live() - before <= len(ifsker._DIFFUSION)
    finally:
        gc.enable()


@pytest.mark.faults
def test_elastic_resume_equals_clean_run(tmp_path):
    """Decomposition-independent numerics: the killed + shrunken + resumed
    run equals the undisturbed full-size run BITWISE, and the reference's
    clean run within 1e-12."""
    clean, ic = ifsker.run_elastic(str(tmp_path / "a"), steps=3, seed=11,
                                   device="cpu")
    assert not ic["recoveries"]
    healed, ih = ifsker.run_elastic(str(tmp_path / "b"), steps=3, seed=11,
                                    kill_step=2, kill_rank=3, device="cpu")
    assert ih["recoveries"] and ih["size"] == 3
    assert ih["recoveries"][0]["resumed_step"] == 1
    assert torch.equal(clean, healed)
    # the reference's elastic leg can hang: run it guarded
    want, _ = reference_run_elastic("ifsker", str(tmp_path / "c"), steps=3,
                                    seed=11)
    np.testing.assert_allclose(healed.numpy(), want, rtol=0, atol=TOL)


def test_traced_leg_exports_a_valid_trace(tmp_path):
    from repro_torch import obs
    path = tmp_path / "ifsker.json"
    overlap = ifsker.run_traced(str(path), print_fn=lambda *_: None,
                                device="cpu")
    assert 0.0 <= overlap <= 1.0
    import json
    doc = json.loads(path.read_text())
    assert obs.validate_trace(doc) == []
    assert doc["otherData"]["benchmark"] == "ifsker"
