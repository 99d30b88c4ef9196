"""Parity of the port's training path with the JAX package's, on the CPU:
checkpoints, restart, the training CLI and the prefetcher (split off
``tests/test_torch_train.py``, whose helpers and bounds these use).

* The train state crosses between the packages through checkpoints both
  ways (the reference's layout), and the port's restart is bitwise
  deterministic (``tests/test_system.py``'s restart test).
* ``python -m repro_torch.launch.train --device cpu`` prints finite
  losses; what a train step builds is freed without the cyclic
  collector; the prefetcher yields the stream's batches and restarts
  mid-stream (``tests/test_system.py``'s prefetcher test).
"""

import math
import subprocess
import sys

import jax
import numpy as np
import torch

from repro import checkpoint as jax_ckpt
from repro_torch import checkpoint as ckpt
from repro_torch import configs, optim
from repro_torch.core.overlap import tree_flatten
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import local_mesh, make_mesh
from repro_torch.models import model
from repro_torch.runtime import steps
from repro_torch.runtime.sharding import ShardingPolicy
from test_torch_train import (CPU, OPT, ROOT, _batches, _check_step,  # noqa: F401
                              _jax_leaves, _jax_step, _policy, _port_leaves,
                              _port_run, _port_state, granite)
from torch_threads import one_intra_op_thread  # noqa: F401


def test_reference_checkpoint_continues_in_the_port(granite, tmp_path):
    """The reference trains 2 steps and saves; the port restores and
    trains 2 more, matching the reference's 4-step run."""
    jcfg, cfg, jstate0 = granite
    batches = _batches(cfg, 4)
    j2, _ = _jax_step(jcfg, jstate0, batches[:2])
    j4, jm = _jax_step(jcfg, jstate0, batches)
    jax_ckpt.save_checkpoint(str(tmp_path), j2, step=2)
    restored, step = ckpt.restore_checkpoint(
        str(tmp_path), steps.abstract_reference_state(cfg))
    assert step == 2
    state = steps.state_from_reference(cfg, restored, device=CPU)
    fn, _ = steps.build_train_step(cfg, local_mesh(device=CPU),
                                   ShardingPolicy(**_policy()),
                                   optim.OptimConfig(**OPT))
    state, m = _port_run(fn, state, batches[2:])
    _check_step(state, m, j4, jm[2:])


def test_port_checkpoint_restores_in_the_reference(granite, tmp_path):
    jcfg, cfg, jstate0 = granite
    batches = _batches(cfg, 2)
    fn, _ = steps.build_train_step(cfg, local_mesh(device=CPU),
                                   ShardingPolicy(**_policy()),
                                   optim.OptimConfig(**OPT))
    state, _ = _port_run(fn, _port_state(cfg, jstate0), batches)
    ckpt.save_checkpoint(str(tmp_path), steps.state_to_reference(state), 2)
    restored, step = jax_ckpt.restore_checkpoint(
        str(tmp_path), jax.eval_shape(lambda: jstate0))
    assert step == 2
    want = _port_leaves(steps.state_to_reference(state))
    got = _jax_leaves(restored)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # ... and the reference trains on from it
    jstate, _ = _jax_step(jcfg, restored, _batches(cfg, 3)[2:])
    assert int(jstate.opt.step) == 3


def test_port_restart_is_bitwise_deterministic(tmp_path):
    """tests/test_system.py's restart test on the port: 12 steps straight
    against 6, a checkpoint, a restore and 6 more."""
    cfg = configs.smoke("granite_3_2b").scaled(
        dtype="float32", n_layers=2, d_model=64, d_ff=128, vocab=128)
    opt_cfg = optim.OptimConfig(peak_lr=3e-3, warmup_steps=10,
                                total_steps=60)
    fn, _ = steps.build_train_step(cfg, local_mesh(device=CPU),
                                   ShardingPolicy(**_policy()), opt_cfg)
    batches = _batches(cfg, 12)
    straight, _ = _port_run(fn, steps.init_train_state(
        cfg, opt_cfg, 0, device=CPU), batches)
    half, _ = _port_run(fn, steps.init_train_state(
        cfg, opt_cfg, 0, device=CPU), batches[:6])
    ckpt.save_checkpoint(str(tmp_path), steps.state_to_reference(half), 6)
    restored, step = ckpt.restore_checkpoint(
        str(tmp_path), steps.abstract_reference_state(cfg))
    assert step == 6
    resumed, _ = _port_run(fn, steps.state_from_reference(
        cfg, restored, device=CPU), batches[6:])
    for a, b in zip(_port_leaves(steps.state_to_reference(straight)),
                    _port_leaves(steps.state_to_reference(resumed))):
        np.testing.assert_array_equal(a, b)


def test_train_cli_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--scale", "smoke", "--steps", "3", "--batch", "2", "--seq", "16",
         "--log-every", "1", "--grad-sync", "bucketed", "--mesh", "2x1"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    losses = [float(line.split("loss=")[1].split()[0])
              for line in proc.stdout.splitlines() if "loss=" in line]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "s/step" in proc.stdout and "tokens/s" in proc.stdout


def test_train_step_frees_the_state_without_the_cyclic_collector(granite):
    """What a train step builds is freed by reference counts alone
    (chip_smoke.py's memory gate after training needs it): no reference
    cycle holds a parameter, a gradient or the optimizer state."""
    import gc
    import weakref
    _, cfg, jstate0 = granite
    batches = _batches(cfg, 1, batch=4, seq=16)
    gc.collect()
    gc.disable()
    try:
        for grad_sync in ("auto", "fused"):
            state = _port_state(cfg, jstate0)
            if grad_sync == "auto":
                fn, _ = steps.build_train_step(
                    cfg, local_mesh(device=CPU),
                    ShardingPolicy(**_policy()), optim.OptimConfig(**OPT))
            else:
                fn = steps.build_train_step_manual(
                    cfg, make_mesh((2, 1), ("data", "model"), CPU),
                    ShardingPolicy(**_policy(grad_sync=grad_sync)),
                    optim.OptimConfig(**OPT))(None, None)
            state, _ = _port_run(fn, state, batches)
            held = [weakref.ref(t) for t in tree_flatten(
                (model.param_tree(state.params), state.opt))[0]]
            grad = weakref.ref(fn.replicas()[1].params.embed) \
                if grad_sync != "auto" else None
            del state, fn
            assert all(r() is None for r in held), grad_sync
            assert grad is None or grad() is None
    finally:
        gc.enable()


def test_prefetcher_deterministic_and_restartable():
    """tests/test_system.py's prefetcher test on the port, with the
    device put of the training CLI: the batches are the stream's, and a
    prefetcher started mid-stream yields the same ones."""
    from repro_torch.data import Prefetcher, to_device
    cfg = configs.smoke("granite_3_2b")
    data = SyntheticLMData(cfg, batch=4, seq=16, seed=7)
    put = lambda b: to_device(b, CPU)  # noqa: E731
    pf = Prefetcher(data, start_step=0, device_put_fn=put)
    got = [pf.get(s)["tokens"] for s in range(5)]
    pf.close()
    for s, t in enumerate(got):
        np.testing.assert_array_equal(t.numpy(), data.batch_at(s)["tokens"])
    pf2 = Prefetcher(data, start_step=3, device_put_fn=put)
    assert torch.equal(pf2.get(3)["tokens"], got[3])
    assert torch.equal(pf2.get(4)["tokens"], got[4])
    pf2.close()
