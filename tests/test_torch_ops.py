"""The port's ``kernels.ops`` entry points take views, as the JAX ``ops``
do: a CUDA input that a kernel wrapper would refuse (non-contiguous, or
misaligned where the wrapper reads 16-byte vectors) is copied to a fresh
contiguous tensor first, and every other input reaches the wrapper as it
is.  The copy rule is checked here on CPU tensors; the entry points on the
card (``-m cuda``, and ``chip_smoke.py`` phase 2b) with transposed and
offset views of every input, against the plain versions.
"""

import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops


def _offset_view(t, k=1):
    buf = torch.zeros(t.numel() + k, dtype=t.dtype)
    return buf[k:].view(t.shape).copy_(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("case", ["contiguous", "transposed", "offset",
                                  "offset16"])
def test_as_kernel_input(case, aligned, dtype):
    """What a wrapper takes comes back as the same tensor (no copy);
    a transposed view as an equal contiguous copy; a misaligned offset
    view as an equal 16-byte-aligned copy where the wrapper needs
    alignment (``aligned``), and unchanged where it does not (as for
    ``mamba2_ssd``, whose fma route takes it)."""
    t = torch.randn(6, 8, generator=torch.Generator().manual_seed(0)).to(
        dtype)
    if case == "transposed":
        t = t.t().contiguous().t()
    elif case.startswith("offset"):
        t = _offset_view(t, 16 // t.element_size() if case == "offset16"
                         else 1)
    got = ops._as_kernel_input(t, aligned=aligned)
    copied = case == "transposed" or (case == "offset" and aligned)
    assert torch.equal(got, t)
    assert got.is_contiguous()
    if copied:
        assert got.data_ptr() != t.data_ptr() and got.data_ptr() % 16 == 0
    else:
        assert got is t
    assert ops._as_kernel_input(None, aligned=aligned) is None


def test_entry_points_pass_cpu_views_on():
    """On the CPU the plain versions take views: an entry point hands a
    view to them as it is (equal to the result on a contiguous copy)."""
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(2, 5, 8, generator=g), torch.randn(2, 6, 8,
                                                          generator=g)
    wt = w.transpose(1, 2)                      # (2, 8, 6), a view
    assert not wt.is_contiguous()
    assert torch.equal(ops.moe_gmm(x, wt), ops.moe_gmm(x, wt.contiguous()))
    block = torch.randn(8, 6, generator=g).t()  # (6, 8), a view
    halos = [torch.randn(n, generator=g) for n in (8, 6, 8, 6)]
    got, want = ops.gs_stencil(block, *halos), ops.gs_stencil(
        block.contiguous(), *halos)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_views_through_ops_on_card():
    """Transposed and offset views of every input of the five entry
    points with a hand kernel launch the kernel and match the plain
    version (``chip_smoke.check_ops_views``, phase 2b)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    chip_smoke.check_ops_views(torch.device("cuda"))
