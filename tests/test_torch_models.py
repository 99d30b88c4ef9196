"""Parity of the port's model stack with the JAX package's.

* The ten configs equal the reference's field by field (full and smoke).
* ``params_from_reference`` loads ``repro.models.model.init`` of smoke
  granite-3-2b; train-mode logits, prefill logits and cache, and four
  teacher-forced decode steps then match ``repro.models.model.apply`` on
  the same tokens.  fp32 within 1e-4 (both sides compute in fp32 on the
  CPU; only summation orders differ).  bf16 within 5e-2 absolute plus
  2e-2 relative: the two frameworks round bf16 activations at different
  points (XLA rounds ``silu``, ``x * sigmoid(x)``, after each operation,
  PyTorch once), one bf16 ulp (2^-8 relative) per rounding.  The largest
  values compared are the k/v cache entries (up to 4.6, where one ulp is
  2^-5 = 0.031), and RoPE's rotation can carry that absolute error onto a
  small entry; measured: 0.031 in the cache, 0.0078 in the logits.
* The same for smoke zamba2-2.7b (Mamba2 blocks and the shared attention
  block), prompt length 24 so that the SSD pads to its chunk of 16: fp32
  within 1e-4 (measured 5.5e-6); bf16 within 0.2 absolute plus 2e-2
  relative, looser than granite's bound because the gated RMSNorm of every
  Mamba2 block rounds outputs near 10 to bf16 (an ulp is 0.0625 there), so
  one-ulp flips from the frameworks' different rounding points reach the
  output projection, and six blocks carry them on; measured: 0.113 in the
  train logits, 0.0996 in the shared block's k/v, 0.0625 (one ulp) in the
  conv tails, 0.019 in the SSD states, 0.078 in the decode logits.
* The same for smoke xlstm-350m (three mLSTM blocks and one sLSTM
  block), prompt length 24 so that the mLSTM scan pads to its chunk of 16;
  decode also runs from the empty cache template, whose mLSTM stabiliser
  is the -1e30 sentinel.  fp32 within 1e-4.  bf16 within XLSTM_BF16_ATOL
  absolute plus 2e-2 relative, for the reason stated there.
* ``init`` draws the Mamba2 and xLSTM leaves as the reference's
  ``mamba2_init``, ``mlstm_init`` and ``slstm_init``.
* A config whose pattern holds a kind that is no block kind raises, as
  the reference's ``_unit_apply`` does.  (Every block kind is ported; the
  MoE models are held in ``tests/test_torch_moe.py``.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import config as jax_config
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch import configs
from repro_torch.models import config, inputs, layers
from repro_torch.models.config import MAMBA2
from repro_torch.models import model as port_model

B, S, DECODE_STEPS = 2, 12, 4


def test_all_configs_equal_the_reference():
    assert configs.ARCHS == jax_configs.ARCHS
    assert configs._ALIASES == jax_configs._ALIASES
    for arch in configs.ARCHS:
        for getter in ("get", "smoke"):
            port = getattr(configs, getter)(arch)
            ref = getattr(jax_configs, getter)(arch)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
            assert port.repeats == ref.repeats
            assert port.head_dim == ref.head_dim
            assert port.activation_dtype == getattr(torch, ref.dtype)
        assert configs.get(arch.replace("_", "-")) == configs.get(arch)
    assert [dataclasses.asdict(s) for s in config.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jax_config.ALL_SHAPES]
    for arch in configs.ARCHS:
        assert [s.name for s in config.applicable_shapes(configs.get(arch))] \
            == [s.name for s in jax_config.applicable_shapes(
                jax_configs.get(arch))]


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.float32)), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(dtype, jax cfg, jax params, port cfg, port model) for smoke
    granite-3-2b, the port holding the reference's weights."""
    dtype = request.param
    jcfg = dataclasses.replace(jax_configs.smoke("granite-3-2b"),
                               dtype=dtype)
    pcfg = dataclasses.replace(configs.smoke("granite-3-2b"), dtype=dtype)
    params = jax_model.init(jcfg, jax.random.PRNGKey(0))
    model = port_model.params_from_reference(pcfg, _to_numpy(params),
                                             device="cpu")
    return dtype, jcfg, params, pcfg, model


def _tol(dtype):
    return dict(atol=1e-4, rtol=1e-4) if dtype == "float32" \
        else dict(atol=5e-2, rtol=2e-2)


def test_params_from_reference_holds_every_leaf(pair):
    dtype, jcfg, params, pcfg, model = pair
    n_ref = sum(int(x.size) for x in jax.tree_util.tree_leaves(params))
    assert port_model.param_count(model) == n_ref
    w = params["layers"]["L0_0_attn"]["wq"]           # (repeats, d, H·dh)
    for r, unit in enumerate(model.units):
        got = unit.blocks["L0_0_attn"].wq
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_f32(got), _f32(w[r]))
    np.testing.assert_array_equal(_f32(model.embed), _f32(params["embed"]))


def test_train_logits_match(pair):
    dtype, jcfg, params, pcfg, model = pair
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S))
    want, _, want_aux = jax_model.apply(
        params, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)}, mode="train")
    with torch.no_grad():
        got, cache, aux = port_model.apply(model,
                                           {"tokens": torch.from_numpy(toks)},
                                           mode="train")
    assert cache is None and got.shape == (B, S, jcfg.vocab)
    assert float(aux) == float(want_aux) == 0.0     # no MoE block
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_prefill_and_decode_match(pair):
    """Prefill into a fixed-size cache (last-position logits, k/v at
    [0, S)), then four teacher-forced decode steps, each extending the
    cache in place, against the reference's prefill + ``pad_cache`` +
    decode."""
    dtype, jcfg, params, pcfg, model = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, (B, S))
    forced = rng.integers(0, jcfg.vocab, (DECODE_STEPS, B))
    total = S + DECODE_STEPS
    want, jcache, _ = jax_model.apply(
        params, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
        mode="prefill")
    jcache = jax_model.pad_cache(jcfg, jcache, total)
    cache = port_model.init_cache(pcfg, B, total, device="cpu")
    with torch.no_grad():
        got, cache2, _ = port_model.apply(model,
                                       {"tokens": torch.from_numpy(toks)},
                                       mode="prefill", cache=cache)
    assert cache2 is cache and got.shape == (B, 1, jcfg.vocab)
    np.testing.assert_allclose(_f32(got), _f32(want[:, -1:]), **_tol(dtype))
    for name, kv in jcache.items():
        for n in ("k", "v"):
            np.testing.assert_allclose(_f32(cache[name][n]), _f32(kv[n]),
                                       **_tol(dtype))
    decode = jax.jit(lambda p, c, b, i: jax_model.apply(
        p, jcfg, b, mode="decode", cache=c, cache_index=i)[:2])
    for i in range(DECODE_STEPS):
        step = {"tokens": jnp.asarray(forced[i][:, None], jnp.int32)}
        want, jcache = decode(params, jcache, step, jnp.int32(S + i))
        with torch.no_grad():
            got, cache, _ = port_model.apply(
                model, {"tokens": torch.from_numpy(forced[i][:, None])},
                mode="decode", cache=cache, cache_index=S + i)
        assert got.shape == (B, 1, jcfg.vocab)
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_prefill_without_cache_allocates_one():
    cfg = dataclasses.replace(configs.smoke("granite-3-2b"), dtype="float32")
    model = port_model.init(cfg, seed=3, device="cpu")
    toks = inputs.make_batch(cfg, batch=1, seq=6, kind="prefill",
                             device="cpu")
    with torch.no_grad():
        logits, cache, _ = port_model.apply(model, toks, mode="prefill")
    assert logits.shape == (1, 1, cfg.vocab) and torch.isfinite(logits).all()
    k = cache["L0_0_attn"]["k"]
    assert k.shape == (cfg.repeats, 1, 6, cfg.n_kv_heads, cfg.head_dim)


def test_init_is_seeded_and_scaled():
    cfg = configs.smoke("granite-3-2b")
    a = port_model.init(cfg, seed=0, device="cpu")
    b = port_model.init(cfg, seed=0, device="cpu")
    c = port_model.init(cfg, seed=1, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    assert a.embed.dtype == torch.bfloat16
    assert abs(a.embed.float().std().item() - 0.02) < 2e-3
    wd = a.units[0].blocks["L0_1_mlp"].wd.float()
    assert abs(wd.std().item() - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert torch.equal(a.final_norm.scale, torch.ones(cfg.d_model))


def test_unknown_block_kind_raises():
    """A pattern with a kind that is no block kind raises ``ValueError``
    naming it, as the reference's ``_unit_apply`` does (``model.py``'s
    ``raise ValueError(kind)``)."""
    pattern = ((MAMBA2,), ("conv",)) * 3
    jcfg = dataclasses.replace(jax_configs.smoke("zamba2-2.7b"),
                               pattern=pattern)
    with pytest.raises(ValueError, match="conv"):
        jax_model.init(jcfg, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(configs.smoke("zamba2-2.7b"), pattern=pattern)
    with pytest.raises(ValueError, match="unknown block kind 'conv'"):
        port_model.Model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ["starcoder2-15b", "hubert-xlarge"])
def test_layernorm_gelu_archs_match(arch):
    """The other ported paths (LayerNorm, tanh GeLU, untied head, the
    audio frontend, bidirectional attention) in fp32 train mode."""
    jcfg = dataclasses.replace(jax_configs.smoke(arch), dtype="float32")
    pcfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    params = jax_model.init(jcfg, jax.random.PRNGKey(4))
    model = port_model.params_from_reference(pcfg, _to_numpy(params),
                                             device="cpu")
    rng = np.random.default_rng(4)
    if jcfg.frontend == "audio":
        x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
        jb, pb = {"embeds": jnp.asarray(x)}, {"embeds": torch.from_numpy(x)}
    else:
        toks = rng.integers(0, jcfg.vocab, (B, S))
        jb = {"tokens": jnp.asarray(toks, jnp.int32)}
        pb = {"tokens": torch.from_numpy(toks)}
    want, _, _ = jax_model.apply(params, jcfg, jb, mode="train")
    with torch.no_grad():
        got, _, _ = port_model.apply(model, pb, mode="train")
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# zamba2-2.7b: Mamba2 blocks and the shared attention block
# ---------------------------------------------------------------------------
ZS = 24          # a prompt that is not a multiple of the SSD chunk (16)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def zamba(request):
    """(dtype, jax cfg, jax params, port cfg, port model) for smoke
    zamba2-2.7b, the port holding the reference's weights."""
    dtype = request.param
    jcfg = dataclasses.replace(jax_configs.smoke("zamba2-2.7b"), dtype=dtype)
    pcfg = dataclasses.replace(configs.smoke("zamba2-2.7b"), dtype=dtype)
    params = jax_model.init(jcfg, jax.random.PRNGKey(5))
    model = port_model.params_from_reference(pcfg, _to_numpy(params),
                                             device="cpu")
    return dtype, jcfg, params, pcfg, model


def _ztol(dtype):
    return dict(atol=1e-4, rtol=1e-4) if dtype == "float32" \
        else dict(atol=0.2, rtol=2e-2)


def _port_leaf(model, path):
    """The port's parameter at a reference tree path."""
    keys = [p.key for p in path]
    if keys[0] == "layers":
        return getattr(model.units[0].blocks[keys[1]], keys[2])
    node = model
    for k in keys:
        node = getattr(node, k)
    return node


def test_zamba2_params_from_reference_holds_every_leaf(zamba):
    """Every leaf of the reference's tree, the shared block held once and
    ``params["shared"]`` mapped onto it, the empty shared_attn entries of
    ``params["layers"]`` skipped; equal parameter counts."""
    dtype, jcfg, params, pcfg, model = zamba
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert port_model.param_count(model) == sum(int(x.size)
                                                for _, x in leaves)
    assert params["layers"]["L5_1_shared_attn"] == {}
    assert "L5_1_shared_attn" not in model.units[0].blocks
    assert "L5_1_norm" not in model.units[0].blocks
    for path, leaf in leaves:
        want = _f32(leaf)
        if path[0].key == "layers":
            want = want[0]              # smoke zamba2 has one repeat
        got = _port_leaf(model, path)
        assert got.dtype == (torch.float32 if leaf.dtype == jnp.float32
                             else getattr(torch, dtype))
        np.testing.assert_array_equal(_f32(got), want)


def test_zamba2_train_logits_match(zamba):
    dtype, jcfg, params, pcfg, model = zamba
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (B, ZS))
    want, _, _ = jax_model.apply(params, jcfg,
                                 {"tokens": jnp.asarray(toks, jnp.int32)},
                                 mode="train")
    with torch.no_grad():
        got, _, _ = port_model.apply(
            model, {"tokens": torch.from_numpy(toks)}, mode="train")
    assert got.shape == (B, ZS, jcfg.vocab)
    np.testing.assert_allclose(_f32(got), _f32(want), **_ztol(dtype))


def test_zamba2_prefill_and_decode_match(zamba):
    """Prefill into a fixed-size cache (last-position logits; every Mamba2
    block's SSD state and conv tail, the shared block's k/v), then four
    teacher-forced decode steps, each updating the cache in place, against
    the reference's prefill + ``pad_cache`` + decode."""
    dtype, jcfg, params, pcfg, model = zamba
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (B, ZS))
    forced = rng.integers(0, jcfg.vocab, (DECODE_STEPS, B))
    total = ZS + DECODE_STEPS
    want, jcache, _ = jax_model.apply(
        params, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
        mode="prefill")
    jcache = jax_model.pad_cache(jcfg, jcache, total)
    cache = port_model.init_cache(pcfg, B, total, device="cpu")
    with torch.no_grad():
        got, cache2, _ = port_model.apply(model,
                                       {"tokens": torch.from_numpy(toks)},
                                       mode="prefill", cache=cache)
    assert cache2 is cache
    np.testing.assert_allclose(_f32(got), _f32(want[:, -1:]), **_ztol(dtype))
    assert sorted(cache) == sorted(jcache)
    for name, entry in jcache.items():
        assert sorted(cache[name]) == sorted(entry)
        for n, v in entry.items():
            assert tuple(cache[name][n].shape) == v.shape
            assert cache[name][n].dtype == (
                torch.float32 if n == "state" else getattr(torch, dtype))
            np.testing.assert_allclose(_f32(cache[name][n]), _f32(v),
                                       **_ztol(dtype))
    decode = jax.jit(lambda p, c, b, i: jax_model.apply(
        p, jcfg, b, mode="decode", cache=c, cache_index=i)[:2])
    for i in range(DECODE_STEPS):
        step = {"tokens": jnp.asarray(forced[i][:, None], jnp.int32)}
        want, jcache = decode(params, jcache, step, jnp.int32(ZS + i))
        with torch.no_grad():
            got, cache, _ = port_model.apply(
                model, {"tokens": torch.from_numpy(forced[i][:, None])},
                mode="decode", cache=cache, cache_index=ZS + i)
        np.testing.assert_allclose(_f32(got), _f32(want), **_ztol(dtype))
    for name in ("L0_0_mamba2", "L5_0_mamba2"):
        np.testing.assert_allclose(_f32(cache[name]["state"]),
                                   _f32(jcache[name]["state"]),
                                   **_ztol(dtype))


def test_zamba2_init_draws_mamba2_leaves():
    """``dt_bias``, ``A_log`` and ``conv_b`` 0; ``D`` and ``gn`` 1;
    ``conv_w`` N(0, 0.1²); projections N(0, 1/fan_in); one shared block."""
    cfg = dataclasses.replace(configs.smoke("zamba2-2.7b"), d_model=256)
    model = port_model.init(cfg, seed=0, device="cpu")
    blk = model.units[0].blocks["L2_0_mamba2"]
    for leaf, value in (("dt_bias", 0.0), ("A_log", 0.0), ("conv_b", 0.0),
                        ("D", 1.0), ("gn", 1.0)):
        t = getattr(blk, leaf)
        assert t.dtype == torch.float32
        assert torch.equal(t, torch.full_like(t, value)), leaf
    assert blk.conv_w.dtype == torch.bfloat16
    conv_w = blk.conv_w.float()
    assert abs(conv_w.mean().item()) < 0.01
    assert abs(conv_w.std().item() - 0.1) < 0.01
    for leaf in ("wz", "wx", "wB", "wdt", "out"):
        w = getattr(blk, leaf).float()
        want = w.shape[0] ** -0.5
        assert abs(w.std().item() - want) < 0.05 * want, leaf
    win = model.shared.win.float()
    assert abs(win.std().item() - (2 * 256) ** -0.5) < 0.05 * 512 ** -0.5
    assert sum(1 for m in model.modules()
               if isinstance(m, layers.SharedAttention)) == 1


# ---------------------------------------------------------------------------
# xlstm-350m: mLSTM and sLSTM blocks
# ---------------------------------------------------------------------------
XS = 24          # a prompt that is not a multiple of the mLSTM chunk (16)
# bf16: on the same input each block agrees with the reference's within
# 2e-2 (test_xlstm_blocks_match_on_same_input; measured 0.0156, one ulp at
# values of 2-4): the frameworks round bf16 at different points (XLA rounds
# ``silu`` after each of its two operations, the tanh GeLU after each of
# its six).  Through the residual stream those flips grow: a block's
# per-position RMS norm rescales positions where the mLSTM output is
# small, so each mLSTM block multiplies a carried difference about 14x
# (measured: residual differences of 0.0078, 0.109, 0.188, 0.25 after
# blocks 1-4).  Measured beyond 2e-2 relative: 0.386 in the train logits,
# 0.329 in the cache, 0.230 in the prefill logits, 0.217 in decode.  fp32,
# where only summation orders differ, holds 1e-4 throughout.
XLSTM_BF16_ATOL = 0.5


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def xlstm(request):
    """(dtype, jax cfg, jax params, port cfg, port model) for smoke
    xlstm-350m, the port holding the reference's weights."""
    dtype = request.param
    jcfg = dataclasses.replace(jax_configs.smoke("xlstm-350m"), dtype=dtype)
    pcfg = dataclasses.replace(configs.smoke("xlstm-350m"), dtype=dtype)
    params = jax_model.init(jcfg, jax.random.PRNGKey(8))
    model = port_model.params_from_reference(pcfg, _to_numpy(params),
                                             device="cpu")
    return dtype, jcfg, params, pcfg, model


def _xtol(dtype):
    return dict(atol=1e-4, rtol=1e-4) if dtype == "float32" \
        else dict(atol=XLSTM_BF16_ATOL, rtol=2e-2)


def test_xlstm_params_from_reference_holds_every_leaf(xlstm):
    """Every leaf of the reference's tree, names unchanged; the gate and
    recurrent weights in fp32 whatever the activation dtype."""
    dtype, jcfg, params, pcfg, model = xlstm
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert port_model.param_count(model) == sum(int(x.size)
                                                for _, x in leaves)
    for path, leaf in leaves:
        want = _f32(leaf)
        if path[0].key == "layers":
            want = want[0]              # smoke xlstm has one repeat
        got = _port_leaf(model, path)
        assert got.dtype == (torch.float32 if leaf.dtype == jnp.float32
                             else getattr(torch, dtype))
        np.testing.assert_array_equal(_f32(got), want)


@pytest.mark.parametrize("name", ["L0_0_mlstm", "L3_0_slstm"])
def test_xlstm_blocks_match_on_same_input(xlstm, name):
    """One block (its norm and the block) on the same input, train mode:
    fp32 within 1e-4, bf16 within 2e-2 (one ulp at the outputs' values)."""
    dtype, jcfg, params, pcfg, model = xlstm
    x = np.random.default_rng(11).standard_normal((B, XS, jcfg.d_model))
    x = x.astype(np.float32)
    li = name[1]
    p = jax.tree_util.tree_map(lambda a: a[0], params["layers"][name])
    pn = jax.tree_util.tree_map(lambda a: a[0],
                                params["layers"][f"L{li}_0_norm"])
    apply = jax_layers.mlstm_apply if "mlstm" in name \
        else jax_layers.slstm_apply
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want, _ = apply(p, jax_layers.norm_apply(pn, xj, jcfg), jcfg)
    blocks = model.units[0].blocks
    with torch.no_grad():
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        got = blocks[name](blocks[f"L{li}_0_norm"](xt))
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_xlstm_train_logits_match(xlstm):
    dtype, jcfg, params, pcfg, model = xlstm
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (B, XS))
    want, _, _ = jax_model.apply(params, jcfg,
                                 {"tokens": jnp.asarray(toks, jnp.int32)},
                                 mode="train")
    with torch.no_grad():
        got, _, _ = port_model.apply(
            model, {"tokens": torch.from_numpy(toks)}, mode="train")
    assert got.shape == (B, XS, jcfg.vocab)
    np.testing.assert_allclose(_f32(got), _f32(want), **_xtol(dtype))


def _assert_cache_equal(cache, jcache, dtype):
    assert sorted(cache) == sorted(jcache)
    for name, entry in jcache.items():
        assert sorted(cache[name]) == sorted(entry)
        for n, v in entry.items():
            got = cache[name][n]
            assert tuple(got.shape) == v.shape and got.dtype == torch.float32
            np.testing.assert_allclose(_f32(got), _f32(v), **_xtol(dtype))


def test_xlstm_prefill_and_decode_match(xlstm):
    """The cache template (mLSTM m at the -1e30 sentinel, sLSTM n at 1)
    equals the reference's; a decode step from it maps the sentinel to
    -inf and back as the reference does; prefill into a cache (every
    block from the zero state, whatever the cache held), then four
    teacher-forced decode steps updating it in place, against the
    reference's prefill and decode; every cache leaf compared."""
    dtype, jcfg, params, pcfg, model = xlstm
    rng = np.random.default_rng(10)
    toks = rng.integers(0, jcfg.vocab, (B, XS))
    forced = rng.integers(0, jcfg.vocab, (DECODE_STEPS, B))
    total = XS + DECODE_STEPS
    decode = jax.jit(lambda p, c, b, i: jax_model.apply(
        p, jcfg, b, mode="decode", cache=c, cache_index=i)[:2])

    jtemplate = jax_model.init_cache(jcfg, B, total)
    cache = port_model.init_cache(pcfg, B, total, device="cpu")
    _assert_cache_equal(cache, jtemplate, dtype)
    assert torch.equal(cache["L0_0_mlstm"]["m"],
                       torch.full((1, B, pcfg.n_heads), -1e30))
    step = {"tokens": jnp.asarray(forced[0][:, None], jnp.int32)}
    want, jstep = decode(params, jtemplate, step, jnp.int32(0))
    with torch.no_grad():
        got, _, _ = port_model.apply(
            model, {"tokens": torch.from_numpy(forced[0][:, None])},
            mode="decode", cache=cache, cache_index=0)
    np.testing.assert_allclose(_f32(got), _f32(want), **_xtol(dtype))
    _assert_cache_equal(cache, jstep, dtype)

    want, jcache, _ = jax_model.apply(
        params, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
        mode="prefill")
    with torch.no_grad():
        got, cache2, _ = port_model.apply(model,
                                       {"tokens": torch.from_numpy(toks)},
                                       mode="prefill", cache=cache)
    assert cache2 is cache
    np.testing.assert_allclose(_f32(got), _f32(want[:, -1:]), **_xtol(dtype))
    _assert_cache_equal(cache, jcache, dtype)
    for i in range(DECODE_STEPS):
        step = {"tokens": jnp.asarray(forced[i][:, None], jnp.int32)}
        want, jcache = decode(params, jcache, step, jnp.int32(XS + i))
        with torch.no_grad():
            got, cache, _ = port_model.apply(
                model, {"tokens": torch.from_numpy(forced[i][:, None])},
                mode="decode", cache=cache, cache_index=XS + i)
        np.testing.assert_allclose(_f32(got), _f32(want), **_xtol(dtype))
    _assert_cache_equal(cache, jcache, dtype)


def test_xlstm_init_draws_xlstm_leaves():
    """mLSTM: ``bi`` 0, ``bf`` 3 (shape (H,)), ``gn`` 1, projections
    N(0, 1/fan_in); sLSTM: ``bf`` 1 (shape (d,)), ``bi``/``bz``/``bo`` 0,
    ``gn`` 1, ``r*`` N(0, 1/dh) (fan-in dh, not H), ``w*`` N(0, 1/d)."""
    cfg = dataclasses.replace(configs.smoke("xlstm-350m"), d_model=256)
    model = port_model.init(cfg, seed=0, device="cpu")
    blocks = model.units[0].blocks
    mb, sb = blocks["L0_0_mlstm"], blocks["L3_0_slstm"]
    H, d = cfg.n_heads, cfg.d_model
    dh = d // H
    expect = ((mb, "bi", (H,), 0.0), (mb, "bf", (H,), 3.0),
              (mb, "gn", (2 * d,), 1.0), (sb, "bf", (d,), 1.0),
              (sb, "bi", (d,), 0.0), (sb, "bz", (d,), 0.0),
              (sb, "bo", (d,), 0.0), (sb, "gn", (d,), 1.0))
    for blk, leaf, shape, value in expect:
        t = getattr(blk, leaf)
        assert t.dtype == torch.float32 and tuple(t.shape) == shape, leaf
        assert torch.equal(t, torch.full_like(t, value)), leaf
    for blk, leaf, fan in ((mb, "wup", d), (mb, "wq", 2 * d),
                           (mb, "wi", 2 * d), (mb, "wd", 2 * d),
                           (sb, "wi", d), (sb, "wz", d), (sb, "ri", dh),
                           (sb, "ro", dh), (sb, "wu", d), (sb, "wd2", 384)):
        w = getattr(blk, leaf).float()
        want = fan ** -0.5
        assert abs(w.std().item() - want) < 0.05 * want, leaf
    assert sb.ri.shape == (H, dh, dh) and sb.wu.shape == (d, 384)
