"""Port parity: Level-A collectives over tensor payloads.

A ``torch.Tensor`` payload stays a tensor on its own device through every
schedule op (split, concatenate, combine, the persistent plan's ``out=``
arena), and its values equal the JAX package's ``repro.core.collectives``
on the same numpy inputs bitwise: the combines are the same elementwise
fp32/fp64 operations in the same order.
"""

import numpy as np
import pytest
import torch

from repro.core import Collectives as JaxCollectives
from repro.core import tac as jax_tac
from repro_torch.core import Collectives, tac

N = 4

CASES = [
    ("allreduce", {}),
    ("allreduce", {"segments": 3}),
    ("allreduce", {"algorithm": "doubling"}),
    ("allreduce", {"hierarchical": 2}),
    ("allreduce", {"op": "max"}),
    ("reduce_scatter", {}),
    ("reduce_scatter", {"algorithm": "doubling"}),
    ("reduce", {"op": "prod"}),
]


def _inputs(dtype, seed=0, m=37):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(m).astype(dtype) for _ in range(N)]


def _assert_tensors_equal(got, want, device):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert isinstance(g, torch.Tensor), type(g)
        assert g.device.type == device
        np.testing.assert_array_equal(g.cpu().numpy(), w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("executor", ["compiled", "interpreted"])
@pytest.mark.parametrize("name,kw", CASES)
def test_tensor_payloads_stay_tensors(name, kw, executor, dtype):
    xs = _inputs(dtype)
    got = Collectives(tac.CommWorld(N), executor=executor).run_group(
        name, [{"value": torch.from_numpy(x)} for x in xs], **kw)
    want = JaxCollectives(jax_tac.CommWorld(N), executor=executor) \
        .run_group(name, [{"value": x} for x in xs], **kw)
    _assert_tensors_equal(got, want, "cpu")


@pytest.mark.parametrize("executor", ["compiled", "interpreted"])
def test_persistent_plan_over_tensors(executor):
    """The compiled plan writes into its arena with ``out=`` into a
    tensor buffer; every posting returns a fresh tensor."""
    plan = Collectives(tac.CommWorld(N), executor=executor) \
        .persistent("allreduce")
    jplan = JaxCollectives(jax_tac.CommWorld(N), executor=executor) \
        .persistent("allreduce")
    first = None
    for it in range(3):
        xs = _inputs(np.float32, seed=it)
        got = plan.run_group([torch.from_numpy(x) for x in xs])
        _assert_tensors_equal(got, jplan.run_group(xs), "cpu")
        if first is None:
            first = [g.clone() for g in got]
            kept = got
    for f, k in zip(first, kept):           # later postings reuse the arena
        assert torch.equal(f, k)


def test_numpy_payloads_keep_numpy():
    xs = _inputs(np.float32)
    got = Collectives(tac.CommWorld(N)).run_group(
        "allreduce", [{"value": x} for x in xs])
    assert all(isinstance(g, np.ndarray) for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", CASES)
def test_tensor_payloads_stay_on_card(name, kw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    xs = _inputs(np.float32)
    got = Collectives(tac.CommWorld(N)).run_group(
        name, [{"value": torch.from_numpy(x).cuda()} for x in xs], **kw)
    want = JaxCollectives(jax_tac.CommWorld(N)).run_group(
        name, [{"value": x} for x in xs], **kw)
    _assert_tensors_equal(got, want, "cuda")
    plan = Collectives(tac.CommWorld(N)).persistent("allreduce")
    for _ in range(2):
        got = plan.run_group([torch.from_numpy(x).cuda() for x in xs])
        _assert_tensors_equal(got, JaxCollectives(jax_tac.CommWorld(N))
                              .run_group("allreduce",
                                         [{"value": x} for x in xs]),
                              "cuda")
