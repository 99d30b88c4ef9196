"""Parity of the port's mixture of experts with the JAX package's.

The same inputs, drawn with numpy from a seed, go through the JAX package
and the port:

* ``moe_gmm`` — the port's plain version (``ref.moe_gmm``) and its
  wrapper on CPU tensors (``ops.moe_gmm``) against the JAX Pallas kernel
  in interpret mode and ``ops.moe_gmm(impl="ref")`` at the shapes and
  dtypes of ``tests/test_kernels.py`` (fp32 2e-5, bf16 2e-2, atol =
  rtol: one bf16 rounding of the output), and ragged C/K/N that the
  Pallas wrapper refuses, against the JAX ragged oracle; ``ref.gmm``
  against the JAX ``ref.gmm`` with uneven group sizes, one of them 0.
* The ``MoE`` block against ``moe_apply`` for smoke olmoe-1b-7b and smoke
  mixtral-8x22b: fp32 y within 1e-4 and aux within 1e-6 (both sides in
  fp32 on the CPU; only summation orders differ; measured 7e-7 and
  2.4e-7); bf16 y within 2e-2 absolute plus 2e-2 relative (the two
  frameworks round the expert activations at different points, one bf16
  ulp each; measured 0.0156 at values of 2-4, one ulp there) with the
  same expert choices.  Cases: prefill, decode at B > 1 (G = B, one token
  a group, cap = min(8, k) = 2) and a capacity factor of 0.25, which
  drops rows (cap 8 against a mean of 16 rows an expert).
* Whole smoke olmoe and mixtral in fp32: train logits, prefill logits and
  cache, four teacher-forced decode steps, and the aux loss of each,
  against ``repro.models.model.apply`` (1e-4; aux 1e-6).  In bf16 the
  router's top-k is discontinuous: a one-ulp difference in a router
  input, which the frameworks' different rounding points produce, can
  swap an expert and change that token's output by O(1) (measured at
  smoke olmoe: one swap moves the train logits by 1.8).  So the bf16
  model is run whole, and every MoE block call is held against
  ``moe_apply`` on the very input it received.

The kernel runs only on the card (``-m cuda`` and ``chip_smoke.py``).
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.moe_gmm import moe_gmm as jax_gmm
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch import configs
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.models import model as port_model

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
JAX_SHAPES = [(4, 64, 32, 48), (8, 128, 128, 256), (2, 32, 64, 32)]
RAGGED = [(3, 13, 40, 24), (2, 2, 7, 5), (5, 1, 1, 3), (64, 8, 24, 40)]
ARCHS = ["olmoe-1b-7b", "mixtral-8x22b"]
OLMOE_PARAMS, OLMOE_ACTIVE = 6_919_096_320, 1_281_951_744


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _xw(E, C, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, K)).astype(np.float32),
            rng.standard_normal((E, K, N)).astype(np.float32))


# ---------------------------------------------------------------------------
# moe_gmm and gmm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("E,C,K,N", JAX_SHAPES)
def test_moe_gmm_matches_jax(E, C, K, N, dtype):
    tdt, jdt = DTYPES[dtype]
    x, w = _xw(E, C, K, N, seed=E + C + K + N)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    plain = ref.moe_gmm(tx, tw)
    assert plain.dtype == tdt and plain.shape == (E, C, N)
    assert torch.equal(ops.moe_gmm(tx, tw), plain)
    assert torch.equal(ops.moe_gmm(tx, tw, impl="ref"), plain)
    for want in (jax_gmm(jx, jw, block_c=32, block_n=16, block_k=32,
                         interpret=True),
                 jax_ops.moe_gmm(jx, jw, impl="ref")):
        np.testing.assert_allclose(_f32(plain), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("E,C,K,N", RAGGED)
def test_moe_gmm_ragged_matches_jax_oracle(E, C, K, N, dtype):
    """Shapes the Pallas wrapper's divisibility asserts refuse (and
    olmoe's decode row count C = 8), against the JAX ragged oracle at full
    group sizes."""
    tdt, jdt = DTYPES[dtype]
    x, w = _xw(E, C, K, N, seed=7 * E + C)
    got = ops.moe_gmm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    want = jax_ops.moe_gmm(jnp.asarray(x).astype(jdt),
                           jnp.asarray(w).astype(jdt), impl="ref")
    assert got.shape == (E, C, N)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("sizes", [(5, 0, 9, 2), (0, 16, 0, 0), (4, 4, 4, 4)])
def test_gmm_matches_jax_with_uneven_groups(sizes):
    rng = np.random.default_rng(sum(sizes))
    T, K, N = sum(sizes), 12, 10
    x = rng.standard_normal((T, K)).astype(np.float32)
    w = rng.standard_normal((len(sizes), K, N)).astype(np.float32)
    got = ref.gmm(torch.from_numpy(x), torch.from_numpy(w),
                  torch.tensor(sizes, dtype=torch.int32))
    want = jax_ref.gmm(jnp.asarray(x), jnp.asarray(w),
                       jnp.asarray(sizes, jnp.int32))
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5, rtol=1e-5)
    starts = np.cumsum(sizes) - np.asarray(sizes)
    for e, (s0, n) in enumerate(zip(starts, sizes)):   # row by row, by hand
        np.testing.assert_allclose(got[s0:s0 + n].numpy(), x[s0:s0 + n] @ w[e],
                                   atol=1e-5, rtol=1e-5)


def test_fixed_capacity_equals_ragged_oracle():
    """``tests/test_kernels.py``'s check, in the port: the fixed-capacity
    product equals ``gmm`` at full group sizes."""
    E, C, K, N = 3, 8, 16, 8
    x, w = (torch.from_numpy(a) for a in _xw(E, C, K, N, seed=6))
    ragged = ref.gmm(x.reshape(E * C, K), w,
                     torch.full((E,), C, dtype=torch.int32))
    np.testing.assert_allclose(ops.moe_gmm(x, w, impl="ref").numpy(),
                               ragged.reshape(E, C, N).numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", [None, "cuda", "ref"])
def test_wrapper_takes_plain_version_for_cpu_tensors(impl):
    x, w = (torch.from_numpy(a).to(torch.bfloat16)
            for a in _xw(4, 10, 16, 12, seed=8))
    before = mg.moe_gmm.launches
    got = ops.moe_gmm(x, w, impl=impl)
    assert mg.moe_gmm.launches == before
    assert torch.equal(got, ref.moe_gmm(x, w))


@pytest.mark.parametrize("case,match", [
    ("rank", "expected"), ("experts", "does not match"),
    ("depth", "does not match"), ("device", "on meta"), ("impl", "impl")])
def test_argument_checks(case, match):
    x, w = (torch.from_numpy(a) for a in _xw(2, 4, 8, 6, seed=9))
    kw = {}
    if case == "rank":
        x = x[0]
    elif case == "experts":
        w = w[:1]
    elif case == "depth":
        w = w[:, :5]
    elif case == "device":
        w = w.to("meta")
    else:
        kw["impl"] = "pallas"
    with pytest.raises(ValueError, match=match):
        ops.moe_gmm(x, w, **kw)


def _views(E, C, K, N, dtype, offset, device="cpu", seed=12):
    """x (E, C, K) and w (E, K, N) as contiguous views ``offset`` elements
    into flat buffers whose bases are 16-byte aligned."""
    x0, w0 = _xw(E, C, K, N, seed)
    out = []
    for a in (x0, w0):
        buf = torch.zeros(a.size + offset, dtype=dtype, device=device)
        assert buf.data_ptr() % 16 == 0
        buf[offset:] = torch.from_numpy(a.reshape(-1)).to(dtype)
        out.append(buf[offset:].view(a.shape))
    return out


@pytest.mark.parametrize("dtype,E,C,K,N,offset,want", [
    (torch.float32, 1, 320, 2048, 1024, 0, "fma"),
    (torch.float32, 2, 8, 64, 64, 0, "fma"),
    (torch.bfloat16, 1, 320, 2048, 1024, 0, "wgmma"),
    (torch.bfloat16, 1, 320, 1024, 2048, 0, "wgmma"),
    (torch.bfloat16, 1, 8, 2048, 1024, 0, "wgmma_decode"),
    (torch.bfloat16, 2, 1, 72, 200, 0, "wgmma_decode"),
    (torch.bfloat16, 2, 9, 72, 200, 0, "wgmma"),
    (torch.bfloat16, 3, 65, 72, 200, 8, "wgmma"),
    (torch.bfloat16, 3, 8, 72, 200, 8, "wgmma_decode"),
    (torch.bfloat16, 3, 65, 72, 200, 1, "mma_sync"),
    (torch.bfloat16, 3, 8, 72, 200, 3, "mma_sync"),
    (torch.bfloat16, 2, 2, 7, 5, 0, "mma_sync"),
    (torch.bfloat16, 2, 17, 33, 130, 0, "mma_sync"),
    (torch.bfloat16, 2, 16, 64, 130, 0, "mma_sync"),
    (torch.bfloat16, 2, 16, 0, 64, 0, "mma_sync"),
])
def test_route_follows_dtype_shape_and_alignment(dtype, E, C, K, N, offset,
                                                 want):
    x, w = _views(E, C, K, N, dtype, offset)
    assert mg.route(x, w) == want
    assert want in mg.ROUTES


def test_decode_rows_match_the_kernel_tile():
    """The wrapper sends C <= DECODE_ROWS to the decode route, whose tile
    the kernel sizes by its own constant and refuses larger C with."""
    src = (Path(mg.__file__).parent / "csrc" / "moe_gmm.cu").read_text()
    found = re.findall(r"constexpr int kDecodeRows = (\d+);", src)
    assert found == [str(mg.DECODE_ROWS)]


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------
def _block_pair(arch, dtype, capacity_factor=1.25):
    """(jax cfg, jax params of one MoE block, port MoE holding them)."""
    jcfg = dataclasses.replace(jax_configs.smoke(arch), dtype=dtype,
                               capacity_factor=capacity_factor)
    pcfg = dataclasses.replace(configs.smoke(arch), dtype=dtype,
                               capacity_factor=capacity_factor)
    params = jax_layers.moe_init(jax.random.PRNGKey(3), jcfg)
    block = layers.MoE(pcfg, device="cpu")
    with torch.no_grad():
        for k, v in params.items():
            p = getattr(block, k)
            p.copy_(torch.tensor(_f32(v)).to(p.dtype))
    return jcfg, params, block


def _jax_choices(params, x, jcfg):
    """The reference's top-k expert ids for x (G, Tg, d)."""
    logits = jnp.einsum("gtd,de->gte", x.astype(jnp.float32),
                        params["router"])
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1),
                                    jcfg.top_k)[1])


def _assert_block(got, want, dtype):
    (y, aux), (wy, waux) = got, want
    if dtype == "float32":
        np.testing.assert_allclose(_f32(y), _f32(wy), atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(_f32(y), _f32(wy), atol=2e-2, rtol=2e-2)
    assert abs(float(aux) - float(waux)) <= 1e-6


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,cf", [(2, 24, 1.25), (3, 1, 1.25),
                                    (2, 64, 0.25)],
                         ids=["prefill", "decode-B3", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, B, S, cf, dtype):
    jcfg, params, block = _block_pair(arch, dtype, cf)
    x = np.random.default_rng(B * S).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.activation_dtype)
    tx = torch.from_numpy(x).to(block.cfg.activation_dtype)
    want = jax_layers.moe_apply(params, jx, jcfg)
    with torch.no_grad():
        got = block(tx)
        assert torch.equal(block(tx, impl="ref")[0], got[0])
        _, eidx, _ = block.route(tx)
    assert got[0].dtype == tx.dtype and got[0].shape == tx.shape
    np.testing.assert_array_equal(eidx.numpy(), _jax_choices(params, jx,
                                                             jcfg))
    _assert_block(got, want, dtype)
    counts = np.stack([np.bincount(e.reshape(-1), minlength=jcfg.n_experts)
                       for e in eidx.numpy()])
    cap = block.capacity(S)
    assert cap == (8 if cf == 0.25 else min(max(8, -(-int(
        S * jcfg.top_k / jcfg.n_experts * cf) // 8) * 8), S * jcfg.top_k))
    if cf == 0.25:                  # rows were dropped, and it shows
        assert cap == 8 and counts.max() > cap
        wide = layers.MoE(dataclasses.replace(block.cfg, capacity_factor=8.0),
                          device="cpu")
        wide.load_state_dict(block.state_dict())
        with torch.no_grad():
            assert not torch.equal(wide(tx)[0], got[0])


def test_moe_top_k_ties_go_to_the_lower_index():
    """``lax.top_k`` breaks ties toward the lower expert index; so does the
    port's stable descending sort (a zero router gives every expert the
    same probability)."""
    jcfg, params, block = _block_pair("olmoe-1b-7b", "float32")
    with torch.no_grad():
        block.router.zero_()
        gates, eidx, _ = block.route(torch.ones((1, 3, jcfg.d_model)))
    assert eidx.tolist() == [[list(range(jcfg.top_k))] * 3]
    assert torch.allclose(gates, torch.full_like(gates, 1 / jcfg.top_k))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
B, S, DECODE_STEPS = 2, 12, 4


def _model_pair(arch, dtype):
    jcfg = dataclasses.replace(jax_configs.smoke(arch), dtype=dtype)
    pcfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
    params = jax_model.init(jcfg, jax.random.PRNGKey(0))
    model = port_model.params_from_reference(
        pcfg, jax.tree_util.tree_map(_f32, params), device="cpu")
    return jcfg, params, model


@pytest.fixture(scope="module", params=ARCHS)
def fp32_pair(request):
    return _model_pair(request.param, "float32")


def _fp32(got, want):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-4, rtol=1e-4)


def test_params_from_reference_round_trips_moe(fp32_pair):
    jcfg, params, model = fp32_pair
    n_ref = sum(int(x.size) for x in jax.tree_util.tree_leaves(params))
    assert port_model.param_count(model) == n_ref
    assert port_model.active_param_count(model) == \
        jax_model.active_param_count(params, jcfg)
    for leaf in ("router", "wg", "wu", "wd"):
        ref_leaf = params["layers"]["L0_1_moe"][leaf]
        for r, unit in enumerate(model.units):
            got = getattr(unit.blocks["L0_1_moe"], leaf)
            assert got.dtype == (torch.float32 if leaf == "router"
                                 else model.cfg.activation_dtype)
            np.testing.assert_array_equal(_f32(got), _f32(ref_leaf[r]))


def test_moe_model_train_logits_and_aux_match(fp32_pair):
    jcfg, params, model = fp32_pair
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S))
    want, _, waux = jax_model.apply(
        params, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)}, mode="train")
    with torch.no_grad():
        got, cache, aux = port_model.apply(
            model, {"tokens": torch.from_numpy(toks)}, mode="train")
    assert cache is None and aux.dtype == torch.float32
    _fp32(got, want)
    assert float(waux) > 0 and abs(float(aux) - float(waux)) <= 1e-6


def test_moe_model_prefill_and_decode_match(fp32_pair):
    """Prefill into a fixed-size cache, then four teacher-forced decode
    steps (B = 2: each step is G = 2 dispatch groups of one token), each
    with its aux loss, against the reference's prefill + ``pad_cache`` +
    decode."""
    jcfg, params, model = fp32_pair
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, (B, S))
    forced = rng.integers(0, jcfg.vocab, (DECODE_STEPS, B))
    want, jcache, waux = jax_model.apply(
        params, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
        mode="prefill")
    jcache = jax_model.pad_cache(jcfg, jcache, S + DECODE_STEPS)
    cache = port_model.init_cache(model.cfg, B, S + DECODE_STEPS,
                                  device="cpu")
    with torch.no_grad():
        got, cache, aux = port_model.apply(
            model, {"tokens": torch.from_numpy(toks)}, mode="prefill",
            cache=cache)
    _fp32(got, want[:, -1:])
    assert abs(float(aux) - float(waux)) <= 1e-6
    for name, kv in jcache.items():
        for n in ("k", "v"):
            _fp32(cache[name][n], kv[n])
    for i in range(DECODE_STEPS):
        want, jcache, waux = jax_model.apply(
            params, jcfg, {"tokens": jnp.asarray(forced[i][:, None],
                                                 jnp.int32)},
            mode="decode", cache=jcache, cache_index=S + i)
        with torch.no_grad():
            got, cache, aux = port_model.apply(
                model, {"tokens": torch.from_numpy(forced[i][:, None])},
                mode="decode", cache=cache, cache_index=S + i)
        _fp32(got, want)
        assert abs(float(aux) - float(waux)) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_moe_blocks_match_jax_on_their_inputs(arch):
    """The bf16 model run whole (train, prefill and two decode steps);
    every MoE block call held against ``moe_apply`` on the input it got:
    the same expert choices, y within the bf16 bound, and the model's aux
    loss the sum of the reference's per-block losses."""
    jcfg, params, model = _model_pair(arch, "bfloat16")
    calls = []
    hooks = []
    for r, unit in enumerate(model.units):
        for name, blk in unit.blocks.items():
            if isinstance(blk, layers.MoE):
                hooks.append(blk.register_forward_hook(
                    lambda mod, args, out, r=r, name=name: calls.append(
                        (r, name, args[0].clone(), out))))
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, jcfg.vocab, (B, S)))
    runs = []
    with torch.no_grad():
        runs.append(port_model.apply(model, {"tokens": toks}, mode="train"))
        cache = port_model.init_cache(model.cfg, B, S + 2, device="cpu")
        runs.append(port_model.apply(model, {"tokens": toks},
                                     mode="prefill", cache=cache))
        for i in range(2):
            step = torch.from_numpy(rng.integers(0, jcfg.vocab, (B, 1)))
            runs.append(port_model.apply(model, {"tokens": step},
                                         mode="decode", cache=cache,
                                         cache_index=S + i))
    for h in hooks:
        h.remove()
    per_run = len(calls) // len(runs)
    assert per_run == model.cfg.repeats and len(calls) == per_run * len(runs)
    for i, (_, _, aux) in enumerate(runs):
        want_aux = 0.0
        for r, name, x, (y, a) in calls[i * per_run:(i + 1) * per_run]:
            p = jax.tree_util.tree_map(lambda t: t[r],
                                       params["layers"][name])
            jx = jnp.asarray(_f32(x)).astype(jnp.bfloat16)
            wy, waux = jax_layers.moe_apply(p, jx, jcfg)
            _, eidx, _ = model.units[r].blocks[name].route(x)
            np.testing.assert_array_equal(eidx.numpy(),
                                          _jax_choices(p, jx, jcfg))
            _assert_block((y, a), (wy, waux), "bfloat16")
            want_aux += float(waux)
        assert abs(float(aux) - want_aux) <= 1e-5


def test_olmoe_full_size_parameter_counts():
    """olmoe-1b-7b at full size (allocated on the meta device): the
    reference's parameter count and active count, from
    ``jax.eval_shape`` of its init."""
    cfg = configs.get("olmoe-1b-7b")
    model = port_model.Model(cfg, device="meta")
    shapes = jax.eval_shape(
        lambda k: jax_model.init(jax_configs.get("olmoe-1b-7b"), k),
        jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes))
    assert port_model.param_count(model) == n_ref == OLMOE_PARAMS
    assert port_model.active_param_count(model) == OLMOE_ACTIVE == \
        jax_model.active_param_count(shapes, jax_configs.get("olmoe-1b-7b"))
    blk = model.units[0].blocks["L0_1_moe"]
    assert blk.capacity(2048) == 320 and blk.capacity(1) == 8


def test_init_draws_moe_leaves_at_the_reference_fan_ins():
    cfg = dataclasses.replace(configs.smoke("olmoe-1b-7b"), d_model=256,
                              moe_d_ff=64, n_experts=16)
    blk = port_model.init(cfg, seed=0, device="cpu").units[0] \
        .blocks["L0_1_moe"]
    for leaf, fan in (("router", cfg.d_model), ("wg", cfg.d_model),
                      ("wu", cfg.d_model), ("wd", cfg.moe_d_ff)):
        std = getattr(blk, leaf).float().std().item()
        assert abs(std - fan ** -0.5) < 0.05 * fan ** -0.5, leaf
    assert blk.router.dtype == torch.float32
    assert blk.wg.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
CARD_SHAPES = JAX_SHAPES + RAGGED + [(64, 8, 2048, 1024), (8, 200, 256, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("E,C,K,N", CARD_SHAPES)
def test_kernel_matches_plain_on_card(E, C, K, N, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tdt = DTYPES[dtype][0]
    x, w = (torch.from_numpy(a).to(tdt).cuda() for a in _xw(E, C, K, N, 10))
    before = mg.moe_gmm.launches
    got = mg.moe_gmm(x, w)
    again = mg.moe_gmm(x, w)
    want = ref.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert mg.moe_gmm.launches == before + 2
    assert got.dtype == tdt and got.shape == (E, C, N)
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= (2e-2 if dtype == "bfloat16" else 2e-5) * scale, \
        (err, scale)


# The edges of the wgmma route's tiles (C across the 8 rows of x of the
# decode tile and the 160 of the prefill tile, K and N multiples of 8 but
# not of the 64-deep stage or the 128- and 256-column tiles of w, one
# expert), at views 16-byte aligned (offset 0 and 8: the wgmma routes) and
# not (offset 1: mma_sync).
EDGE_SHAPES = [(2, C, 72, 200) for C in (1, 8, 9, 63, 64, 65, 159, 160, 161,
                                         319, 320, 321)] + [
    (3, 65, 72, 200), (2, 320, 1032, 136), (1, 320, 2048, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 8, 1])
@pytest.mark.parametrize("E,C,K,N", EDGE_SHAPES)
def test_route_edges_match_plain_on_card(E, C, K, N, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, w = _views(E, C, K, N, torch.bfloat16, offset, device="cuda")
    assert (mg.route(x, w) == "mma_sync") == (offset == 1)
    before = mg.moe_gmm.launches
    got = mg.moe_gmm(x, w)
    again = mg.moe_gmm(x, w)
    want = ref.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert mg.moe_gmm.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (E, C, N)
    assert torch.equal(got, again)
    np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("case,err,match", [
    ("dtype", TypeError, "dtype"), ("mixed", TypeError, "w dtype"),
    ("strided", ValueError, "contiguous")])
def test_kernel_argument_checks_on_card(case, err, match):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w = (torch.from_numpy(a).cuda() for a in _xw(2, 8, 16, 8, 11))
    if case == "dtype":
        x, w = x.half(), w.half()
    elif case == "mixed":
        w = w.to(torch.bfloat16)
    else:
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(err, match=match):
        mg.moe_gmm(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [24, 1])
def test_moe_block_kernel_matches_plain_on_card(S):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, block = _block_pair("olmoe-1b-7b", "bfloat16")
    block = block.cuda()
    x = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (2, S, block.cfg.d_model)).astype(np.float32)).cuda().bfloat16()
    before = mg.moe_gmm.launches
    with torch.no_grad():
        y, aux = block(x)
        want, want_aux = block(x, impl="ref")
    torch.cuda.synchronize()
    assert mg.moe_gmm.launches == before + 3
    np.testing.assert_allclose(_f32(y.cpu()), _f32(want.cpu()), atol=2e-2,
                               rtol=2e-2)
    assert float(aux) == float(want_aux)
