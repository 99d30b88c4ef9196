"""Shared parts of the sharded-steps parity tests
(``tests/test_torch_sharded_steps*.py``, one file per group of archs so
that no file runs long): the reference's script, the constants and
bounds, and the test bodies.  See ``tests/test_torch_sharded_steps.py``
for what is compared and why.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch import configs, optim
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model
from repro_torch.runtime import sharding, steps
from repro_torch.runtime.sharding import ShardingPolicy

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite_3_2b", "olmoe_1b_7b", "zamba2_2p7b", "xlstm_350m")
MESHES = ((4, 2), (2, 2), (4, 1))
# more train meshes for some of the SAME_MESH archs: smoke granite's 4
# query heads divide a model axis of 4 and its 2 KV heads do not, so its
# attention runs tensor-parallel over the query heads alone ("tp_q")
TRAIN_EXTRA = {"granite_3_2b": ((2, 4),)}
# the serving steps' meshes: (2, 2) for every arch, and (1, 4) for smoke
# granite, whose KV cache of S + N = 20 positions is sharded over time
SERVE_MESHES = {"granite_3_2b": ((2, 2), (1, 4))}
# the archs whose reference step runs on the same meshes; the others' on
# one device, and the port's steps of those also on one rank
SAME_MESH = ("granite_3_2b", "olmoe_1b_7b")
ONE_DEVICE_MESHES = MESHES + ((1, 1),)
# the archs whose parameters are compared only where the reference's
# gradient is 0 or at least NEAR_EPS * eps, and whose every gradient
# element is compared instead (see the module docstring)
NEAR_EPS_ARCHS = ("zamba2_2p7b", "xlstm_350m")
NEAR_EPS = 10
# |port's g - reference's g| <= GRAD_RTOL |g| + GRAD_LEAF_ATOL max|g_leaf|
# (see the module docstring of tests/test_torch_sharded_steps.py)
GRAD_RTOL, GRAD_LEAF_ATOL = 1e-4, 1e-3
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_RTOL, GNORM_RTOL = 2e-5, 2e-4
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
B, S, N = 2, 16, 4
SERVE_TOL = dict(atol=1e-4, rtol=1e-4)
_ENV = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
            PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")

_REFERENCE = r"""
import json, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs, optim
from repro.checkpoint import save_checkpoint
from repro.data import SyntheticLMData
from repro.launch.mesh import make_mesh
from repro.models import model
from repro.runtime import steps
from repro.runtime.sharding import (ShardingPolicy, batch_shardings,
                                    cache_shardings, param_shardings)

(out, archs, same_mesh, meshes, opt, (B, S, N), part, with_ckpt, extra,
 serve_meshes) = json.loads(sys.argv[1])
opt_cfg = optim.OptimConfig(**opt)
metrics = {}
for arch in archs:
    cfg = configs.smoke(arch).scaled(dtype="float32")
    state = steps.init_train_state(cfg, opt_cfg, jax.random.PRNGKey(0))
    save_checkpoint(os.path.join(out, arch + "_init"), state, step=0)
    batch = SyntheticLMData(cfg, batch=8, seq=32, seed=1).batch_at(0)
    for shape in meshes + extra.get(arch, []) if arch in same_mesh \
            else [(1, 1)]:
        mesh = make_mesh(shape, ("data", "model"))
        tag = f"{arch}_{shape[0]}x{shape[1]}"
        pol = ShardingPolicy(remat=None) if shape != (1, 1) else \
            ShardingPolicy(fsdp=False, tp=False, sp=False, remat=None)
        with mesh:
            abatch = jax.eval_shape(lambda: batch)
            fn, sshard = steps.build_train_step(
                cfg, mesh, pol, opt_cfg, abstract_batch=abatch,
                donate=False)
            new, m = fn(jax.device_put(state, sshard),
                        jax.device_put(batch, batch_shardings(mesh, abatch)))
        save_checkpoint(os.path.join(out, tag), new, step=1)
        metrics[tag] = [float(m["loss"]), float(m["grad_norm"])]

    # serving on (2, 2), and on the arch's other serving meshes
    params = model.init(cfg, jax.random.PRNGKey(0))
    save_checkpoint(os.path.join(out, arch + "_params"), params, step=0)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab, (N, B)).astype(np.int32)
    for shape in serve_meshes.get(arch, [[2, 2]]):
        mesh = make_mesh(tuple(shape), ("data", "model"))
        pol = ShardingPolicy()
        batch = {"tokens": jnp.asarray(toks)}
        dec_batch = {"tokens": jnp.zeros((B, 1), jnp.int32)}
        logits_all = []
        with mesh:
            ps = param_shardings(mesh, jax.eval_shape(lambda: params), pol)
            placed = jax.device_put(params, ps)
            prefill = steps.build_prefill_step(
                cfg, mesh, pol, abstract_batch=jax.eval_shape(lambda: batch))
            logits, cache = prefill(placed, batch)
            logits_all.append(np.asarray(logits))
            cache = model.pad_cache(cfg, cache, S + N)
            decode, a_cache = steps.build_decode_step(
                cfg, mesh, pol, batch=B, cache_len=S + N,
                abstract_batch=jax.eval_shape(lambda: dec_batch),
                donate=False)
            cache = jax.device_put(cache, cache_shardings(mesh, a_cache, pol))
            for i in range(N):
                logits, cache = decode(
                    placed, cache, {"tokens": jnp.asarray(forced[i][:, None])},
                    jnp.int32(S + i))
                logits_all.append(np.asarray(logits))
        tag = "" if list(shape) == [2, 2] else f"_{shape[0]}x{shape[1]}"
        np.savez(os.path.join(out, arch + f"_serve{tag}.npz"), *logits_all,
                 toks=toks, forced=forced)

# a bf16 smoke granite state placed on (4, 2), saved
if with_ckpt:
    cfg = configs.smoke("granite_3_2b")
    state = steps.init_train_state(cfg, opt_cfg, jax.random.PRNGKey(4))
    mesh = make_mesh((4, 2), ("data", "model"))
    sa = steps.state_shardings(mesh, jax.eval_shape(lambda: state),
                               ShardingPolicy())
    save_checkpoint(os.path.join(out, "ckpt_4x2"),
                    jax.device_put(state, sa), step=7)
json.dump(metrics, open(os.path.join(out, f"metrics_{part}.json"), "w"))
"""

_RESTORE = r"""
import sys
import jax, numpy as np
from repro import configs, optim
from repro.checkpoint import restore_checkpoint
from repro.launch.mesh import make_mesh
from repro.runtime import steps
from repro.runtime.sharding import ShardingPolicy

ours, theirs = sys.argv[1:3]
cfg = configs.smoke("granite_3_2b")
abstract = jax.eval_shape(lambda: steps.init_train_state(
    cfg, optim.OptimConfig(), jax.random.PRNGKey(4)))
mesh = make_mesh((4, 2), ("data", "model"))
sa = steps.state_shardings(mesh, abstract, ShardingPolicy())
got, step = restore_checkpoint(ours, abstract, sa)
want, _ = restore_checkpoint(theirs, abstract)
assert step == 7, step
n = 0
for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(got)),
                jax.tree_util.tree_leaves(want)):
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    n += 1
print("RESTORED", n)
"""


def run_reference(tmp_path_factory, archs, with_ckpt: bool = False):
    """The reference's steps for ``archs`` (and with ``with_ckpt`` the
    placed bf16 granite checkpoint) from one JAX subprocess: (its output
    directory, the metrics)."""
    out = tmp_path_factory.mktemp("reference")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(
            [str(out), list(archs), SAME_MESH, MESHES, OPT, (B, S, N), "a",
             with_ckpt, TRAIN_EXTRA, SERVE_MESHES])], env=_ENV,
        capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr
    return out, json.loads((out / "metrics_a.json").read_text())


def _cfg(arch):
    return configs.smoke(arch).scaled(dtype="float32")


def _restore_state(cfg, d):
    ref, _ = ckpt.restore_checkpoint(str(d),
                                     steps.abstract_reference_state(cfg))
    return steps.state_from_reference(cfg, ref, device="cpu")


def _leaves(state):
    ref = steps.state_to_reference(state)
    return ([t.float().numpy() for t in steps.tree_flatten(ref.params)[0]],
            [t.numpy() for t in steps.tree_flatten(ref.opt.m)[0]])


def grad_ratio(got, want) -> float:
    """The largest |got - want| / (GRAD_RTOL |want| + GRAD_LEAF_ATOL
    max|want|) over the elements of one gradient leaf (0 for a leaf that
    is zero in both)."""
    bound = GRAD_RTOL * np.abs(want) + GRAD_LEAF_ATOL * np.abs(want).max()
    diff = np.abs(got.astype(np.float64) - want)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.where(diff == 0, 0.0, diff / bound).max())


def check_train_step(reference, arch, shape):
    """The body of ``test_sharded_train_step_matches_reference``."""
    out, metrics = reference
    cfg = _cfg(arch)
    opt_cfg = optim.OptimConfig(**OPT)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    fn, sshard = steps.build_train_step(cfg, mesh, ShardingPolicy(),
                                        opt_cfg)
    state = _restore_state(cfg, out / f"{arch}_init")
    if mesh.size > 1:
        state = steps.place_state(state, sshard)
    batch = SyntheticLMData(cfg, batch=8, seq=32, seed=1).batch_at(0)
    state, m = fn(state, batch)
    tag = f"{arch}_{shape[0]}x{shape[1]}" if arch in SAME_MESH \
        else f"{arch}_1x1"
    loss, gnorm = metrics[tag]
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), gnorm,
                               rtol=GNORM_RTOL)
    ref, _ = ckpt.restore_checkpoint(str(out / tag),
                                     steps.abstract_reference_state(cfg))
    want = [t.float().numpy() for t in steps.tree_flatten(ref.params)[0]]
    # AdamW's first m is (1 - b1) g: the reference's clipped gradient
    grads = [t.numpy() / (1 - opt_cfg.b1)
             for t in steps.tree_flatten(ref.opt.m)[0]]
    got, moments = _leaves(state)
    assert len(got) == len(want) == len(grads) == len(moments)
    left_out, worst = 0, 0.0
    for a, b, g, mg in zip(got, want, grads, moments):
        keep = np.ones(g.shape, bool)
        if arch in NEAR_EPS_ARCHS:
            keep = (g == 0) | (np.abs(g) >= NEAR_EPS * opt_cfg.eps)
            left_out += int((~keep).sum())
            worst = max(worst, grad_ratio(mg / (1 - opt_cfg.b1), g))
        np.testing.assert_allclose(a[keep], b[keep], atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL)
    if arch in NEAR_EPS_ARCHS:
        print(f"{arch} {shape}: {left_out} of {sum(g.size for g in grads)} "
              f"parameters left out (0 < |g| < {NEAR_EPS} eps); gradient "
              f"|dg| / ({GRAD_RTOL} |g| + {GRAD_LEAF_ATOL} max|g_leaf|) "
              f"at most {worst:.4g}")
        assert worst <= 1.0, worst
    assert left_out <= 2e-3 * sum(g.size for g in grads)
    assert int(state.opt.step) == 1
    # the blocks: no rank holds a whole sharded leaf
    wq = state.params["layers"]["L0_0_attn"]["wq"][0] \
        if mesh.size > 1 and "L0_0_attn" in state.params["layers"] \
        else None
    if wq is not None:
        assert wq.blocks[0].numel() < np.prod(wq.shape)




def _serve(cfg, net, mesh, toks, forced):
    """Prefill, the cache grown to S + N, then N teacher-forced decode
    steps: the logits of each."""
    pol = ShardingPolicy()
    params = steps.place_params(net, sharding.param_shardings(mesh, net, pol))
    prefill = steps.build_prefill_step(cfg, mesh, pol)
    decode, template = steps.build_decode_step(cfg, mesh, pol, batch=B,
                                               cache_len=S + N)
    logits, cache = prefill(params, {"tokens": toks})
    outs = [logits]
    cache = sharding.place(
        model.pad_cache(cfg, sharding.gather(cache), S + N),
        sharding.cache_shardings(mesh, template, pol))
    for i in range(N):
        logits, cache = decode(params, cache,
                               {"tokens": forced[i][:, None]}, S + i)
        outs.append(logits)
    return outs


def check_serving_steps(reference, arch, shape=(2, 2)):
    """The body of ``test_sharded_serving_steps_match_reference``: the
    port's serving steps on ``shape`` against the reference's on the same
    mesh."""
    out, _ = reference
    cfg = _cfg(arch)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ref_params, _ = ckpt.restore_checkpoint(
        str(out / f"{arch}_params"), model.params_to_reference(
            model.Model(cfg, device="meta")))
    net = model.params_from_reference(cfg, ref_params, device="cpu")
    tag = "" if tuple(shape) == (2, 2) else f"_{shape[0]}x{shape[1]}"
    got = np.load(out / f"{arch}_serve{tag}.npz")
    want = [got[f"arr_{i}"] for i in range(N + 1)]
    outs = _serve(cfg, net, mesh, got["toks"], got["forced"])
    for a, b in zip(outs, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, **SERVE_TOL)
        assert np.array_equal(a.numpy().argmax(-1), b.argmax(-1))


