"""Parity of the port's training path with the JAX package's, on the CPU.

Inputs are drawn with numpy from fixed seeds (the reference's parameters
from ``jax.random``, handed to the port through ``params_from_reference``
or ``steps.state_from_reference``).  Every side computes in fp32 on the
CPU, so only summation orders differ; the tolerances below say so case by
case.

* ``SyntheticLMData.batch_at`` is bitwise the reference's, for token,
  audio and VLM frontends.
* ``lr_at`` within one fp32 ulp at 0, in warmup, mid-decay and the end.
* ``optim.update``, three steps on one fp32 tree: parameters, moments and
  masters within 1e-6 of each leaf's largest value (two fp32 programs,
  one ulp of rounding per operation, some fused); bf16 parameters within
  one bf16 ulp (2^-8) of the leaf's largest value.
* ``lm_loss`` within 1e-6 relative, with and without a mask.
* Attention: ``ops.flash_attention`` (the kernel wrapper's plain forward
  with its lse, the plain backward) and ``ref.attention_chunked`` against
  ``jax.vjp`` of the reference's ``ref.attention_chunked`` at causal,
  windowed, GQA, ragged (S != T) and multi-chunk shapes: out, dq, dk, dv
  within atol = rtol = 2e-5 (the repo's fp32 kernel tolerance).
* One auto train step of smoke granite-3-2b in fp32 against
  ``steps.build_train_step``: loss, grad norm and new parameters within
  the bounds ``tests/test_distributed.py`` holds two grad-sync modes to
  (loss 1e-5 and grad norm 1e-4 absolute; parameters atol 1e-5, rtol
  1e-4: at step 1 AdamW moves every parameter by about lr · sign(g), so
  a parameter whose gradient is ~0 may move differently by up to lr, and
  step 2's gradients see those differences); the same for two steps
  with ``microbatches=2``, for the port's manual step over 4 logical CPU
  ranks in all three grad-sync modes against the reference's step on the
  whole batch, and for one step of smoke olmoe-1b-7b (the MoE aux loss).
* ``remat="full"`` and ``"dots"`` give bitwise the gradients of None.
* The checkpoint crossings, the port's bitwise restart, the training
  CLI, the no-reference-cycle gate and the prefetcher are in
  ``tests/test_torch_train_checkpoints.py`` (split off so that neither
  file runs long).
"""

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import optim as jax_optim
from repro.data import SyntheticLMData as JaxData
from repro.kernels import ref as jax_ref
from repro.launch.mesh import local_mesh as jax_local_mesh
from repro.models import model as jax_model
from repro.runtime import steps as jax_steps
from repro.runtime.sharding import ShardingPolicy as JaxPolicy
from repro_torch import configs, optim
from repro_torch.core.overlap import tree_flatten
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import local_mesh, make_mesh
from repro_torch.models import model
from repro_torch.runtime import steps
from repro_torch.runtime.sharding import ShardingPolicy
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ATTN_TOL = 2e-5
# tests/test_distributed.py's bounds between grad-sync modes
STEP_ATOL, STEP_RTOL = 1e-5, 1e-4
LOSS_ATOL, GNORM_ATOL = 1e-5, 1e-4
OPT_RTOL = 1e-6


def _np(tree):
    """A jax tree as numpy fp32 leaves (bf16 widened)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.float32)), tree)


def _jax_leaves(tree):
    return [np.asarray(jnp.asarray(x, jnp.float32))
            for x in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    return [t.detach().float().numpy() for t in tree_flatten(tree)[0]]


def _assert_leaves_close(port, jax_, atol, rtol):
    assert len(port) == len(jax_)
    for a, b in zip(port, jax_):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


def _assert_leaves_rel(port, jax_, rtol):
    """max |port - jax| <= rtol * max |jax|, leaf by leaf."""
    assert len(port) == len(jax_)
    for a, b in zip(port, jax_):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rtol * np.abs(b).max()


def _policy(**kw):
    return dict(fsdp=False, tp=False, sp=False, remat=None, **kw)


def _cfg(arch="granite_3_2b"):
    return (jax_configs.smoke(arch).scaled(dtype="float32"),
            configs.smoke(arch).scaled(dtype="float32"))


OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module")
def granite():
    """Smoke granite-3-2b in fp32: the reference's train state from key 0
    and a batch of 8 x 32 from the synthetic stream."""
    jcfg, cfg = _cfg()
    jstate = jax_steps.init_train_state(
        jcfg, jax_optim.OptimConfig(**OPT), jax.random.PRNGKey(0))
    return jcfg, cfg, jstate


def _jax_step(jcfg, jstate, batches, microbatches=1):
    opt_cfg = jax_optim.OptimConfig(**OPT)
    mesh = jax_local_mesh(model=1)
    policy = JaxPolicy(**_policy(microbatches=microbatches))
    out = []
    with mesh:
        fn, _ = jax_steps.build_train_step(
            jcfg, mesh, policy, opt_cfg,
            abstract_batch=jax.eval_shape(lambda: batches[0]), donate=False)
        for b in batches:
            jstate, m = fn(jstate, b)
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return jstate, out


def _port_state(cfg, jstate):
    return steps.state_from_reference(cfg, _np(jstate), device=CPU)


def _check_step(port_state, port_metrics, jstate, jmetrics):
    for (loss, gnorm), (jl, jg) in zip(port_metrics, jmetrics):
        assert abs(loss - jl) < LOSS_ATOL, (loss, jl)
        assert abs(gnorm - jg) < GNORM_ATOL, (gnorm, jg)
    ref_state = steps.state_to_reference(port_state)
    _assert_leaves_close(_port_leaves(ref_state.params),
                         _jax_leaves(jstate.params), STEP_ATOL, STEP_RTOL)
    assert int(ref_state.opt.step) == int(jstate.opt.step)


# ---------------------------------------------------------------------------
# data, schedule, optimizer, loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["granite_3_2b", "hubert_xlarge",
                                  "internvl2_2b"])
def test_synthetic_batches_are_the_references(arch):
    cfg = configs.smoke(arch)
    port = SyntheticLMData(cfg, batch=3, seq=16, seed=5)
    jref = JaxData(jax_configs.smoke(arch), batch=3, seq=16, seed=5)
    for step in (0, 1, 7):
        a, b = port.batch_at(step), jref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_lr_schedule_matches():
    cfg = optim.OptimConfig(peak_lr=3e-4, warmup_steps=10, total_steps=50)
    jcfg = jax_optim.OptimConfig(peak_lr=3e-4, warmup_steps=10,
                                 total_steps=50)
    for step in (0, 1, 5, 10, 30, 50, 60):
        got = optim.lr_at(cfg, step)
        want = float(jax_optim.lr_at(jcfg, jnp.int32(step)))
        assert got == pytest.approx(want, rel=2 ** -23, abs=0.0), step


def _opt_tree(rng, dtype):
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 4, 2)}, "e": (2, 3)}
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches(dtype):
    """Three AdamW steps (clipping active: the gradients' norm is above
    clip_norm) on the same tree.  fp32 within 1e-6 relative; bf16
    parameters within one bf16 ulp (2^-8) of the reference's rounding of
    the same fp32 masters."""
    rng = np.random.default_rng(0)
    params = _opt_tree(rng, dtype)
    grads = [_opt_tree(rng, dtype) for _ in range(3)]
    cfg = optim.OptimConfig(peak_lr=1e-2, warmup_steps=2, total_steps=5)
    jcfg = jax_optim.OptimConfig(peak_lr=1e-2, warmup_steps=2,
                                 total_steps=5)
    jdt = getattr(jnp, dtype)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), params)
    js = jax_optim.init(jp)
    tdt = getattr(torch, dtype)
    tp = jax.tree_util.tree_map(lambda x: torch.tensor(x).to(tdt), params)
    ts = optim.init(tp)
    for g in grads:
        jp, js, jm = jax_optim.update(
            jcfg, jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), g),
            js, jp)
        tp, ts, tm = optim.update(
            cfg, jax.tree_util.tree_map(lambda x: torch.tensor(x).to(tdt),
                                        g), ts, tp)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=OPT_RTOL)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=OPT_RTOL)
    assert int(ts.step) == int(js.step) == 3
    for port, want in ((ts.m, js.m), (ts.v, js.v), (ts.master, js.master)):
        _assert_leaves_rel(_port_leaves(port), _jax_leaves(want), OPT_RTOL)
    tol = OPT_RTOL if dtype == "float32" else 2.0 ** -8
    _assert_leaves_rel(_port_leaves(tp), _jax_leaves(jp), tol)


def test_lm_loss_matches():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = float(model.lm_loss(torch.tensor(logits), torch.tensor(labels),
                                  None if m is None else torch.tensor(m)))
        want = float(jax_model.lm_loss(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       None if m is None else
                                       jnp.asarray(m)))
        assert got == pytest.approx(want, rel=OPT_RTOL)


# ---------------------------------------------------------------------------
# attention's backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,T,H,Hkv,D,causal,window", [
    (2, 40, 40, 4, 2, 16, True, None),      # causal GQA
    (1, 64, 64, 4, 1, 32, True, 9),         # windowed MQA
    (2, 24, 37, 2, 2, 16, False, None),     # bidirectional, S != T
    (1, 600, 600, 2, 1, 16, True, None),    # two key chunks of 512
])
def test_attention_vjp_matches_jax(B, S, T, H, Hkv, D, causal, window):
    rng = np.random.default_rng(S + T + H)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    dout = rng.standard_normal((B, S, H, D)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jax_ref.attention_chunked(
        a, b, c, causal=causal, window=window), q, k, v)
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(dout)]
    for fn in (ops.flash_attention, ref.attention_chunked):
        tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        o = fn(tq, tk, tv, causal=causal, window=window)
        got = [o] + list(torch.autograd.grad(o, (tq, tk, tv),
                                             torch.tensor(dout)))
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.detach().numpy(), b,
                                       atol=ATTN_TOL, rtol=ATTN_TOL,
                                       err_msg=f"{fn.__name__} {name}")


def test_attention_lse_matches_reference_forward():
    """The lse the kernel wrapper's plain forward returns (the kernel's
    contract) equals the reference's ``_attn_fwd_impl`` lse."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 50, 4, 16), (2, 50, 2, 16), (2, 50, 2, 16)))
    _, want = jax_ref._attn_fwd_impl(q, k, v, True, 7, 512)
    for fn in (lambda *a, **kw: ref.flash_attention(*a, return_lse=True,
                                                    **kw),
               ref.attention_fwd):
        _, lse = fn(*(torch.tensor(x) for x in (q, k, v)), causal=True,
                    window=7)
        np.testing.assert_allclose(lse.numpy(), np.asarray(want),
                                   atol=ATTN_TOL, rtol=ATTN_TOL)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
def _batches(cfg, n, batch=8, seq=32, seed=1):
    data = SyntheticLMData(cfg, batch=batch, seq=seq, seed=seed)
    return [data.batch_at(s) for s in range(n)]


def _port_run(fn, state, batches):
    out = []
    for b in batches:
        state, m = fn(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return state, out


@pytest.mark.parametrize("microbatches,n_steps", [(1, 1), (2, 2)])
def test_auto_train_step_matches(granite, microbatches, n_steps):
    jcfg, cfg, jstate0 = granite
    batches = _batches(cfg, n_steps)
    jstate, jm = _jax_step(jcfg, jstate0, batches, microbatches)
    fn, _ = steps.build_train_step(
        cfg, local_mesh(device=CPU),
        ShardingPolicy(**_policy(microbatches=microbatches)),
        optim.OptimConfig(**OPT))
    state, m = _port_run(fn, _port_state(cfg, jstate0), batches)
    _check_step(state, m, jstate, jm)


def test_remat_gives_the_same_gradients(granite):
    _, cfg, jstate0 = granite
    batch = steps._as_tensors(_batches(cfg, 1)[0], CPU)
    got = {}
    for remat in (None, "full", "dots"):
        params = _port_state(cfg, jstate0).params
        _, _, grads = steps._grads(params, batch, cfg, remat)
        got[remat] = [g.clone() for g in tree_flatten(grads)[0]]
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(got[None], got[remat]))


@pytest.mark.parametrize("mode", ["fused", "bucketed", "sentinel"])
def test_manual_step_matches_single_device(granite, mode):
    """4 logical CPU ranks, a quarter of the batch each, against the
    reference's step on the whole batch; the ranks end bitwise equal."""
    jcfg, cfg, jstate0 = granite
    batches = _batches(cfg, 1)
    jstate, jm = _jax_step(jcfg, jstate0, batches)
    mesh = make_mesh((4, 1), ("data", "model"), CPU)
    make = steps.build_train_step_manual(
        cfg, mesh, ShardingPolicy(**_policy(grad_sync=mode)),
        optim.OptimConfig(**OPT), bucket_bytes=1 << 12)
    fn = make(None, None)
    state, m = _port_run(fn, _port_state(cfg, jstate0), batches)
    _check_step(state, m, jstate, jm)
    reps = fn.replicas()
    assert len(reps) == 4 and reps[0] is state
    first = _port_leaves(steps.state_to_reference(reps[0]))
    for r in reps[1:]:
        for a, b in zip(first, _port_leaves(steps.state_to_reference(r))):
            np.testing.assert_array_equal(a, b)
    assert (min(mesh.token_waits) > 0) == (mode == "sentinel")


def test_olmoe_step_matches():
    """Smoke olmoe-1b-7b (MoE blocks: the loss carries 0.01 x the aux
    loss) trains one step through the plain expert products on the CPU."""
    jcfg, cfg = _cfg("olmoe_1b_7b")
    jstate0 = jax_steps.init_train_state(
        jcfg, jax_optim.OptimConfig(**OPT), jax.random.PRNGKey(0))
    batches = _batches(cfg, 1, batch=2, seq=16)
    jstate, jm = _jax_step(jcfg, jstate0, batches)
    fn, _ = steps.build_train_step(cfg, local_mesh(device=CPU),
                                   ShardingPolicy(**_policy()),
                                   optim.OptimConfig(**OPT))
    state, m = _port_run(fn, _port_state(cfg, jstate0), batches)
    _check_step(state, m, jstate, jm)


def test_sharding_refused_on_several_ranks(granite):
    """Manual data parallelism still refuses ``fsdp=True``; the auto-mode
    calls that the port refused on several ranks before the sharded steps
    existed now build a step over the placed state and run it."""
    _, cfg, _ = granite
    mesh = make_mesh((2, 1), ("data", "model"), CPU)
    with pytest.raises(ValueError, match="fsdp=False"):
        steps.build_train_step_manual(cfg, mesh, ShardingPolicy(),
                                      optim.OptimConfig())
    opt_cfg = optim.OptimConfig(**OPT)
    for policy in (ShardingPolicy(), ShardingPolicy(**_policy())):
        fn, sshard = steps.build_train_step(cfg, mesh, policy, opt_cfg)
        assert sshard.params["embed"].mesh is mesh
        state = steps.init_train_state(cfg, opt_cfg, 0, device=CPU,
                                       shardings=sshard)
        state, m = fn(state, _batches(cfg, 1)[0])
        assert math.isfinite(float(m["loss"])) and int(state.opt.step) == 1


# ---------------------------------------------------------------------------
# the state carried across: layouts and checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["granite_3_2b", "zamba2_2p7b",
                                  "xlstm_350m", "olmoe_1b_7b",
                                  "hubert_xlarge"])
def test_params_to_reference_inverts_params_from_reference(arch):
    jcfg, cfg = jax_configs.smoke(arch), configs.smoke(arch)
    p = _np(jax_model.init(jcfg, jax.random.PRNGKey(2)))
    back = model.params_to_reference(
        model.params_from_reference(cfg, p, device=CPU))
    assert jax.tree_util.tree_structure(p) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: 0, back))
    for a, b in zip(_jax_leaves(p), _port_leaves(back)):
        np.testing.assert_array_equal(a, b)
