"""Gradients through the kernel entry points (``repro_torch.kernels.ops``).

* ``mamba2_ssd``, ``mlstm_chunked`` and ``moe_gmm`` launch kernels that
  have no backward: given an input that lies on the card and requires
  grad, with grad enabled, they raise ``NotImplementedError`` naming the
  kernel, before any launch (here the CUDA test is monkeypatched, and a
  launch would fail the test); under ``no_grad``, or with no input
  requiring grad, they reach the kernel; ``impl="ref"`` never refuses.
* On the CPU the plain versions differentiate through autograd, as the
  reference's jnp does: finite gradients for every input that asks.
* ``flash_attention`` is differentiable on every device; its lse and its
  backward are held against the JAX package in
  ``tests/test_torch_train.py``.
* On the card (``-m cuda``): the refusals with real CUDA tensors, and the
  kernel's lse against its plain version (``chip_smoke.py`` phases T1 and
  T2's refusal check).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]


def _inputs(requires_grad=True):
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0, grad=False):
        x = torch.tensor(rng.standard_normal(shape).astype(np.float32)) \
            * scale
        return x.requires_grad_(grad and requires_grad)

    return {
        "mamba2_ssd": (lambda x, dt, A, B, C: ops.mamba2_ssd(
            x, dt, A, B, C, chunk=8), "mamba2_ssd",
            (t(1, 16, 2, 8, grad=True), t(1, 16, 2, scale=0.1).abs(),
             -t(2).abs(), t(1, 16, 8), t(1, 16, 8))),
        "mlstm_chunk": (lambda q, k, v, i, f: ops.mlstm_chunked(
            q, k, v, i, f, chunk=8), "mlstm_chunk",
            (t(1, 16, 2, 8, grad=True), t(1, 16, 2, 8), t(1, 16, 2, 8),
             t(1, 16, 2), t(1, 16, 2))),
        "moe_gmm": (lambda x, w: ops.moe_gmm(x, w), "moe_gmm",
                    (t(2, 4, 8, grad=True), t(2, 8, 6))),
    }


@pytest.fixture
def on_card(monkeypatch):
    """Make every CPU tensor count as one on the card, and every kernel
    launch a failure: what reaches a wrapper is recorded instead."""
    reached = []

    def launcher(name):
        def launch(*args, **kwargs):
            reached.append(name)
            raise RuntimeError("launch")
        return launch

    monkeypatch.setattr(ops, "_launches_kernel", lambda t: True)
    for mod, fn in (("_ssd", "mamba2_ssd"), ("_mlstm", "mlstm_chunk"),
                    ("_gmm", "moe_gmm")):
        monkeypatch.setattr(getattr(ops, mod), fn, launcher(fn))
    return reached


@pytest.mark.parametrize("name", ["mamba2_ssd", "mlstm_chunk", "moe_gmm"])
def test_kernel_with_no_backward_refuses_grad(on_card, name):
    call, kernel, args = _inputs()[name]
    with pytest.raises(NotImplementedError, match=kernel):
        call(*args)
    assert on_card == []                    # refused before any launch
    with torch.no_grad(), pytest.raises(RuntimeError, match="launch"):
        call(*args)
    assert on_card == [kernel]
    call, _, args = _inputs(requires_grad=False)[name]
    with pytest.raises(RuntimeError, match="launch"):
        call(*args)
    assert on_card == [kernel, kernel]


def test_ref_impl_never_refuses(on_card):
    _, _, (x, dt, A, B, C) = _inputs()["mamba2_ssd"]
    y, _ = ops.mamba2_ssd(x, dt, A, B, C, chunk=8, impl="ref")
    assert y.grad_fn is not None
    _, _, (xg, w) = _inputs()["moe_gmm"]
    assert ops.moe_gmm(xg, w, impl="ref").grad_fn is not None
    assert on_card == []


@pytest.mark.parametrize("name", ["mamba2_ssd", "mlstm_chunk", "moe_gmm"])
def test_plain_versions_differentiate_on_cpu(name):
    call, _, args = _inputs()[name]
    out = call(*args)
    y = out[0] if isinstance(out, tuple) else out
    y.square().sum().backward()
    for a in args:
        if a.requires_grad:
            assert a.grad is not None and bool(torch.isfinite(a.grad).all())
            assert float(a.grad.abs().max()) > 0


@pytest.mark.cuda
def test_refusals_and_lse_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    device = torch.device("cuda")
    chip_smoke.check_grad_refusals(device)
    chip_smoke.check_flash_lse(fa, ref, device)
