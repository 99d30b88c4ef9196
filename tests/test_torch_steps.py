"""The port's serving steps against the JAX package's.

``runtime.steps.build_prefill_step`` and ``build_decode_step`` are held
against the reference's jitted steps on smoke granite-3-2b, zamba2-2.7b,
xlstm-350m and olmoe-1b-7b in fp32, the port holding the reference's
weights (``params_from_reference``): one prefill of 2 × 16 tokens, the
cache grown by ``pad_cache`` to 20, then four teacher-forced decode steps,
every step's logits within 1e-4 (``tests/test_torch_models.py``'s fp32
bound) and its greedy tokens equal (``tests/test_torch_serving.py``'s
stream equality).  The decode step's cache template has the reference's
``a_cache`` structure, shapes and dtypes, on the ``meta`` device, and
``abstract_params`` / ``abstract_train_state`` describe the real state
without memory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro import optim as jax_optim
from repro.launch import mesh as jax_meshlib
from repro.models import model as jax_model
from repro.runtime import steps as jax_steps
from repro.runtime.sharding import ShardingPolicy as JaxPolicy
from repro_torch import configs, optim
from repro_torch.core.overlap import tree_flatten
from repro_torch.launch.mesh import local_mesh, make_mesh
from repro_torch.models import model
from repro_torch.runtime import sharding, steps
from repro_torch.runtime.sharding import ShardingPolicy

B, S, DECODE_STEPS = 2, 16, 4
TOL = dict(atol=1e-4, rtol=1e-4)
POLICY = dict(fsdp=False, tp=False, sp=False, remat=None)
ARCHS = ("granite-3-2b", "zamba2-2.7b", "xlstm-350m", "olmoe-1b-7b")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_steps(jcfg, params, toks, forced):
    """The reference's prefill step, ``pad_cache`` and decode steps."""
    mesh = jax_meshlib.local_mesh(model=1)
    policy = JaxPolicy(**POLICY)
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    dec_batch = {"tokens": jnp.zeros((B, 1), jnp.int32)}
    out = []
    with mesh:
        prefill = jax_steps.build_prefill_step(
            jcfg, mesh, policy, abstract_batch=jax.eval_shape(lambda: batch))
        logits, cache = prefill(params, batch)
        out.append(np.asarray(logits))
        cache = jax_model.pad_cache(jcfg, cache, S + DECODE_STEPS)
        decode, a_cache = jax_steps.build_decode_step(
            jcfg, mesh, policy, batch=B, cache_len=S + DECODE_STEPS,
            abstract_batch=jax.eval_shape(lambda: dec_batch), donate=False)
        for i in range(DECODE_STEPS):
            logits, cache = decode(
                params, cache,
                {"tokens": jnp.asarray(forced[i][:, None], jnp.int32)},
                jnp.int32(S + i))
            out.append(np.asarray(logits))
    return out, a_cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    jcfg = dataclasses.replace(jax_configs.smoke(arch), dtype="float32")
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    params = jax_model.init(jcfg, jax.random.PRNGKey(0))
    net = model.params_from_reference(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, S))
    forced = rng.integers(0, cfg.vocab, (DECODE_STEPS, B))
    want, a_cache = _jax_steps(jcfg, params, toks, forced)

    mesh = local_mesh(device="cpu")
    policy = ShardingPolicy(**POLICY)
    prefill = steps.build_prefill_step(cfg, mesh, policy)
    decode, template = steps.build_decode_step(
        cfg, mesh, policy, batch=B, cache_len=S + DECODE_STEPS, donate=False)
    logits, cache = prefill(net, {"tokens": toks})
    got = [logits]
    cache = model.pad_cache(cfg, cache, S + DECODE_STEPS)
    for i in range(DECODE_STEPS):
        logits, cache2 = decode(net, cache, {"tokens": forced[i][:, None]},
                                S + i)
        assert cache2 is cache                   # written in place
        got.append(logits)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (B, 1, cfg.vocab), k
        np.testing.assert_allclose(_f32(g), w, **TOL, err_msg=f"step {k}")
        assert (_f32(g).argmax(-1) == w.argmax(-1)).all(), k

    # the cache template: the reference's tree, shapes and dtypes
    assert sorted(template) == sorted(a_cache)
    for name, entry in a_cache.items():
        assert sorted(template[name]) == sorted(entry), name
        for n, leaf in entry.items():
            t = template[name][n]
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(leaf.shape), (name, n)
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), (name, n)
            assert tuple(cache[name][n].shape) == tuple(leaf.shape)


def test_abstract_params_and_train_state():
    cfg = configs.smoke("olmoe-1b-7b")
    opt_cfg = optim.OptimConfig()
    a_params = steps.abstract_params(cfg)
    a_state = steps.abstract_train_state(cfg, opt_cfg)
    real = steps.init_train_state(cfg, opt_cfg, 0, device="cpu")
    want = tree_flatten(model.param_tree(real.params))[0]
    for tree in (model.param_tree(a_params),
                 model.param_tree(a_state.params)):
        leaves = tree_flatten(tree)[0]
        assert [(t.shape, t.dtype) for t in leaves] == \
            [(t.shape, t.dtype) for t in want]
        assert all(t.device.type == "meta" for t in leaves)
    for moments in (a_state.opt.m, a_state.opt.v, a_state.opt.master):
        leaves = tree_flatten(moments)[0]
        assert [(t.shape, t.dtype) for t in leaves] == \
            [(t.shape, torch.float32) for t in want]
        assert all(t.device.type == "meta" for t in leaves)
    # the reference's abstract state holds as many numbers
    ref = jax_steps.abstract_train_state(jax_configs.smoke("olmoe-1b-7b"),
                                         jax_optim.OptimConfig())
    assert sum(int(np.prod(x.shape)) for x in
               jax.tree_util.tree_leaves(ref.params)) == \
        sum(t.numel() for t in want)


def test_serving_steps_serve_on_several_ranks():
    """The meshes and policies the serving steps refused before they were
    sharded — FSDP over (2, 1), TP over (1, 2), whole replicas on (2, 1)
    — now serve a prefill and a decode step, giving the one-rank step's
    logits (fp32, ``TOL``)."""
    cfg = dataclasses.replace(configs.smoke("granite-3-2b"),
                              dtype="float32")
    net = model.init(cfg, 0, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
    nxt = {"tokens": toks[:, :1]}

    def serve(mesh, policy):
        params = net if mesh.size == 1 else steps.place_params(
            net, sharding.param_shardings(mesh, net, policy))
        logits, cache = steps.build_prefill_step(cfg, mesh, policy)(
            params, {"tokens": toks})
        decode, template = steps.build_decode_step(
            cfg, mesh, policy, batch=2, cache_len=9)
        if mesh.size == 1:
            cache = model.pad_cache(cfg, cache, 9)
        else:
            cache = sharding.place(
                model.pad_cache(cfg, sharding.gather(cache), 9),
                sharding.cache_shardings(mesh, template, policy))
        return logits, decode(params, cache, nxt, 8)[0]

    want = serve(make_mesh((1, 1), ("data", "model"), "cpu"),
                 ShardingPolicy(**POLICY))
    for shape, policy in (((2, 1), ShardingPolicy()),
                          ((1, 2), ShardingPolicy(fsdp=False)),
                          ((2, 1), ShardingPolicy(**POLICY))):
        got = serve(make_mesh(shape, ("data", "model"), "cpu"), policy)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_lm_step_rows_are_the_references():
    """``bench/lm_step.py`` on the CPU runs every row of its archs: a
    train row for each and a decode row for each causal one, named as the
    reference names them; on the card the rows whose blocks have no
    backward kernel are named as not run, decided from the config."""
    from repro_torch.bench import lm_step
    archs = ["granite_3_2b", "hubert_xlarge", "olmoe_1b_7b"]
    lines = []
    rows = lm_step.bench(print_fn=lines.append, archs=archs, device="cpu")
    want = []
    for arch in archs:
        want.append(f"train_step_{arch}")
        if jax_configs.smoke(arch).causal:
            want.append(f"decode_step_{arch}")
    assert [r[0] for r in rows] == want == [ln.split(",")[0]
                                            for ln in lines]
    assert all(r[1] > 0 and r[2].startswith("tok_per_s=") for r in rows)
    cuda = torch.device("cuda")
    assert [lm_step.train_not_run(configs.smoke(a), cuda)
            for a in configs.ARCHS] == [
        "no_backward_kernel", "no_backward_kernel", None, None,
        None, None, None, "no_backward_kernel",
        "no_backward_kernel", None]
    assert all(lm_step.train_not_run(configs.smoke(a), torch.device("cpu"))
               is None for a in configs.ARCHS)
