"""The port's auto-mode steps over logical meshes against the JAX
package's GSPMD steps on forced host devices.

Two JAX subprocesses with 8 host devices each (``tests/test_distributed.py``'s
setting), run at once, write, as checkpoints in the shared layout and
JSONs of metrics:

* for smoke granite-3-2b and olmoe-1b-7b (EP: 8 experts over the model
  axis) in fp32, the train state from key 0 and the state after one
  ``build_train_step`` on each of the meshes (4, 2), (2, 2) and (4, 1)
  (``ShardingPolicy(remat=None)``: FSDP, TP, SP and EP as the rule table
  places them) over the synthetic stream's first 8 x 32 batch;
* for smoke zamba2-2.7b and xlstm-350m, the same from the single-device
  step (a (1, 1) mesh): their GSPMD steps take 13-17 s each to compile
  on the CPU;
* for all four, the logits of one prefill of 2 x 16 tokens and four
  teacher-forced decode steps on (2, 2) (``ShardingPolicy()``);
* a smoke granite-3-2b state (bf16 parameters) placed on (4, 2), saved.

The port restores each initial state, places it by its own
``state_shardings`` on the same mesh of CPU logical ranks and takes the
same step under ``ShardingPolicy()`` (remat ``"dots"``: the port's
remat gives the same gradients): loss within rtol 2e-5, grad norm within
rtol 2e-4 and every parameter within atol 1e-5 / rtol 1e-4 of the
reference's (``tests/test_distributed.py``'s bounds).  zamba2 and xlstm
also take the step on one rank (a (1, 1) mesh), and there the parameter
bounds measure AdamW's amplification more than the layout: the first
step moves a parameter by about lr * g / (|g| + eps), so where 0 < |g| <
10 eps a change of summation order dg moves it by up to lr * dg / eps.
The reference's own head-sharded (4, 2) GSPMD step of smoke zamba2
fails those bounds against its single-device step on three Mamba2
weights whose gradient is that small, and the port's Mamba2, mLSTM and
sLSTM blocks run tensor-parallel over their heads, which changes the
summation order of exactly those gradients.  So for zamba2 and xlstm the
parameters are compared where the reference's gradient is 0 or at least
``10 * eps`` (the test prints how many elements the rule leaves out:
192 of 232,228 for zamba2, 295 of 278,552 for xlstm, and fails above 0.2
%), and every element of every gradient leaf (the port's first AdamW
``m / (1 - b1)``, the reference's the same) is held within 1e-4 |g| +
1e-3 max|g_leaf|.  On every mesh, (1, 1) included, the port's gradients
lie within 0.015 (zamba2) and 0.071 (xlstm) of that bound (0.011 and
0.068 before the blocks became tensor-parallel): the port's one-rank
step differs from the reference's by up to 1.2e-5 (zamba2) and 7.0e-5
(xlstm) of a leaf's largest gradient, 2 to 6 times the change that
moving the port's own scan chunk from 16 to 8 or 32 makes (2e-6 to 6e-6
and 1.4e-5 to 1.9e-5): rounding order, not the layout.  The serving
steps' logits are within 1e-4 of the reference's and their greedy tokens
equal.
Checkpoints cross meshes and packages bitwise
(``tests/test_distributed.py``'s elastic restore): a placed state saved
on (4, 2) restores onto (2, 4) and onto one rank; the reference's (4, 2)
checkpoint restores onto (2, 2) in the port, and the port's save of that
restores onto (4, 2) in the reference (a second subprocess).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import configs, optim
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import steps
from repro_torch.runtime.sharding import ShardingPolicy
from torch_sharded_steps import (_ENV, _RESTORE, MESHES, SAME_MESH,
                                 SERVE_MESHES, TRAIN_EXTRA,
                                 check_serving_steps, check_train_step,
                                 run_reference)
from torch_threads import one_intra_op_thread  # noqa: F401

# granite and olmoe here; zamba2 and xlstm in
# tests/test_torch_sharded_steps_{zamba2,xlstm}.py
ARCHS = SAME_MESH


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, ARCHS, with_ckpt=True)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_reference(reference, arch, shape):
    check_train_step(reference, arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_steps_match_reference(reference, arch):
    check_serving_steps(reference, arch)


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ARCHS for s in TRAIN_EXTRA.get(a, ())],
    ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_sharded_train_step_query_heads_match_reference(reference, arch,
                                                        shape):
    """Smoke granite on (2, 4): its attention tensor-parallel over the
    query heads alone (``"tp_q"``), the KV heads gathered."""
    check_train_step(reference, arch, shape)


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ARCHS for s in SERVE_MESHES.get(a, ()) if s != (2, 2)],
    ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_sharded_serving_steps_over_time_sharded_cache(reference, arch,
                                                       shape):
    """Smoke granite on (1, 4): ``"tp_q"`` attention, and decode over
    the KV cache sharded over time (flash-decode)."""
    check_serving_steps(reference, arch, shape)


def test_placed_checkpoint_restores_onto_other_meshes(tmp_path):
    cfg = configs.smoke("granite_3_2b")
    opt_cfg = optim.OptimConfig()
    pol = ShardingPolicy()
    mesh_a = make_mesh((4, 2), ("data", "model"), "cpu")
    sa = steps.state_shardings(mesh_a, steps.abstract_train_state(
        cfg, opt_cfg), pol)
    state = steps.init_train_state(cfg, opt_cfg, 1, device="cpu",
                                   shardings=sa)
    ckpt.save_checkpoint(str(tmp_path), steps.state_to_reference(state), 7)
    want = steps.tree_flatten(steps.state_to_reference(state))[0]
    aref = steps.abstract_reference_state(cfg)
    mesh_b = make_mesh((2, 4), ("data", "model"), "cpu")
    restored, step = ckpt.restore_checkpoint(
        str(tmp_path), aref, shardings=steps.state_shardings(mesh_b, aref,
                                                             pol))
    assert step == 7
    on_b = steps.state_from_reference(cfg, restored)
    wq = on_b.params["layers"]["L0_0_attn"]["wq"][1]
    assert wq.sharding.mesh is mesh_b and len(wq.blocks) == 8
    one, _ = ckpt.restore_checkpoint(str(tmp_path), aref)
    on_one = steps.state_from_reference(cfg, one, device="cpu")
    for got in (on_b, on_one):
        leaves = steps.tree_flatten(steps.state_to_reference(got))[0]
        assert len(leaves) == len(want)
        for a, b in zip(leaves, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_reference_checkpoint_crosses_meshes_and_back(reference, tmp_path):
    out, _ = reference
    cfg = configs.smoke("granite_3_2b")
    aref = steps.abstract_reference_state(cfg)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    placed, step = ckpt.restore_checkpoint(
        str(out / "ckpt_4x2"), aref,
        shardings=steps.state_shardings(mesh, aref, ShardingPolicy()))
    whole, _ = ckpt.restore_checkpoint(str(out / "ckpt_4x2"), aref)
    assert step == 7
    state = steps.state_from_reference(cfg, placed)
    assert state.params["embed"].sharding.mesh is mesh
    got = steps.tree_flatten(steps.state_to_reference(state))[0]
    for a, b in zip(got, steps.tree_flatten(whole)[0]):
        b = b if isinstance(b, torch.Tensor) else torch.from_numpy(
            np.asarray(b))
        assert a.dtype == b.dtype and torch.equal(a, b)
    ckpt.save_checkpoint(str(tmp_path), steps.state_to_reference(state), 7)
    proc = subprocess.run([sys.executable, "-c", _RESTORE, str(tmp_path),
                           str(out / "ckpt_4x2")], env=_ENV,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("RESTORED")
