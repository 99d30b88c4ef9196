"""How ``correct`` is decided, at toy sizes on the CPU: the whole run
(the program's timed path, then the reference) comes out correct, and
comes out not correct with the timed path broken underneath, once for
each fault the cells can have; the fp8 control fails the cells' limits.
The harness's look for a card is skipped (``device=cpu``)."""

import pytest
import torch

from port_bench import controls, harness
from port_bench.tests import tiny

TRAIN = "granite-3-2b.train-4k"
SERVE = ("zamba2-2.7b.serve-score-4k",)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seed=2**32 + 3):
    return harness.execute(["--workload", cell, "--seed", str(seed),
                            "--seconds", "1"], root=root,
                           device=torch.device("cpu"))


@pytest.mark.parametrize("cell", (TRAIN,) + SERVE)
def test_sound_runs_are_correct(root, cell):
    out = _run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def _unchanged(build):
    from repro_torch.runtime import steps

    def make(cfg, *a, **kw):
        fn, sh = build(cfg, *a, **kw)

        def step(state, batch):
            with torch.no_grad():
                _, loss = steps._loss_fn(
                    state.params, steps._as_tensors(batch,
                                                    state.params.device),
                    cfg, None)
            return state, {"loss": loss}
        return step, sh
    return make


def _half_batch(build):
    def make(cfg, *a, **kw):
        fn, sh = build(cfg, *a, **kw)

        def step(state, batch):
            rows = next(iter(batch.values())).shape[0]
            return fn(state, {k: v[:max(1, rows // 2)]
                              for k, v in batch.items()})
        return step, sh
    return make


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(root, monkeypatch, fault):
    from repro_torch.runtime import steps
    monkeypatch.setattr(steps, "build_train_step",
                        fault(steps.build_train_step))
    out = _run(root, TRAIN)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", SERVE)
def test_an_altered_token_is_not_correct(root, monkeypatch, cell):
    from repro_torch.serving.lm import LMAdapter
    token = LMAdapter._token
    monkeypatch.setattr(LMAdapter, "_token", lambda self, logits: token(
        self, logits.roll(1, dims=-1)))
    out = _run(root, cell)
    assert not out["correct"], out["checks"]


def test_the_fp8_control_fails_the_train_limits(root):
    cell = harness.find_cell(TRAIN, root)
    rows = controls.train_readings(cell, 21, torch.device("cpu"))
    for r in rows:
        assert any(r[k] > cell.limits[k] for k in cell.limits), r


@pytest.mark.parametrize("cell", SERVE)
def test_the_fp8_control_fails_the_serve_limit(root, cell):
    c = harness.find_cell(cell, root)
    (r,) = controls.serve_readings(c, 21, torch.device("cpu"), 2)
    assert r["token_gap"] > c.limits["token_gap"], r
