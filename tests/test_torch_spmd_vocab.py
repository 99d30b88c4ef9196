"""The vocab over the model axis at both ends of the port's sharded model
(``runtime/spmd.py``): the token lookup from the vocab-sharded ``embed``
and, in decode, logits in vocab blocks, as the reference's rule table and
``Constrainer.logits`` lay them out.

* Smoke olmoe-1b-7b (untied), granite-3-2b (tied), zamba2-2.7b and
  xlstm-350m in fp32, random weights from a seed handed to both packages
  in the reference's layout (``params_from_reference``), serve one
  prefill of 2 x 16 tokens and four teacher-forced decode steps on
  (1, 2), (1, 4) and (2, 2).  The
  joined logits of every step lie within :data:`SERVE_TOL` (xlstm:
  :data:`ARCH_TOL`) of the largest logit of the reference's one-device
  prefill and decode on the same weights and tokens, and of the port's
  one-rank steps', with the same greedy tokens.  Each rank's decode
  logits are (B_r, 1, V / T); the prefill's (B_r, 1, V).
* The weights are not gathered over the model axis outside train, by the
  mesh's counters: the FSDP all-gather bytes of a prefill and of a decode
  step are exactly those of the other leaves that a pass gathers (on
  (2, 2), plus ``embed`` and ``lm_head`` gathered over the data axis
  alone), and no FSDP gather spans both axes but those of other leaves.
* The lookup from the vocab-sharded table equals the whole-table lookup
  (``torch.equal``), in fp32 and bf16, prefill and decode (internvl2's
  patch embeddings in place after the sum).
* Where the vocab stays whole: smoke granite with a vocab of 126, which 4
  does not divide, on (1, 4) (whole-vocab head and lookup, as the
  reference's ``_fit_spec`` leaves them); and ``shard_embed_vocab=False``
  (the lookup from the whole table; decode's logits still split, as the
  reference's constraint splits them).  Both are held to the reference.
* One train step of smoke olmoe on (1, 2): every gradient, the embedding's
  included (its gradient now lands in each rank's vocab block alone),
  within ``tests/torch_sharded_steps.py``'s gate of the one-rank step's.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import model as jax_model
from repro_torch import configs, optim
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model
from repro_torch.runtime import sharding, spmd, steps
from repro_torch.runtime.sharding import ShardingPolicy
from repro_torch.runtime.spmd import ShardedModel
from torch_sharded_steps import grad_ratio
from torch_threads import one_intra_op_thread  # noqa: F401

ARCHS = ("olmoe-1b-7b", "granite-3-2b", "zamba2-2.7b", "xlstm-350m")
MESHES = ((1, 2), (1, 4), (2, 2))
B, S, N = 2, 16, 4
SERVE_TOL = 1e-5
# xlstm's own rounding: the port's one-rank steps already lie 8.1e-6 of
# the largest logit from the reference's, and its blocks' heads over the
# model axis 1.7e-5 on (2, 2) (the vocab's layout moves none of its
# logits).  Its sharded serving test against the reference
# (tests/torch_sharded_steps.py) bounds it at 1e-4 likewise.
ARCH_TOL = {"xlstm-350m": 1e-4}
_REFERENCE = {}


def _cfgs(arch, **scale):
    jcfg = dataclasses.replace(jax_configs.smoke(arch), dtype="float32",
                               **scale)
    return jcfg, configs.smoke(arch).scaled(dtype="float32", **scale)


def _reference(arch, **scale):
    """(port cfg, the port's model on the weights the reference runs,
    tokens, forced tokens, the reference's one-device logits of a prefill
    and ``N`` decode steps), once per arch and scale."""
    key = (arch, tuple(sorted(scale.items())))
    if key not in _REFERENCE:
        jcfg, cfg = _cfgs(arch, **scale)
        tree = jax.tree_util.tree_map(
            lambda t: t.detach().numpy(),
            model.params_to_reference(model.init(cfg, 0, "cpu")))
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        net = model.params_from_reference(cfg, tree, device="cpu")
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        forced = rng.integers(0, cfg.vocab, (N, B)).astype(np.int32)
        logits, cache, _ = jax_model.apply(
            params, jcfg, {"tokens": jnp.asarray(toks)}, mode="prefill")
        outs = [np.asarray(logits[:, -1:])]
        cache = jax_model.pad_cache(jcfg, cache, S + N)
        decode = jax.jit(lambda p, c, b, i: jax_model.apply(
            p, jcfg, b, mode="decode", cache=c, cache_index=i)[:2])
        for i in range(N):
            logits, cache = decode(params, cache,
                                   {"tokens": jnp.asarray(forced[i][:, None])},
                                   jnp.int32(S + i))
            outs.append(np.asarray(logits))
        _REFERENCE[key] = (cfg, net, torch.from_numpy(toks),
                           torch.from_numpy(forced), outs)
    return _REFERENCE[key]


def _serve(cfg, net, mesh, toks, forced, pol, record):
    """A prefill, the cache grown to S + N, then N teacher-forced decode
    steps on ``mesh``: each step's logits; ``record`` gets each sharded
    step's per-rank logits shapes and the FSDP / all-gather counters."""
    sharded = mesh.size > 1
    params = steps.place_params(net, sharding.param_shardings(
        mesh, net, pol)) if sharded else net
    prefill = steps.build_prefill_step(cfg, mesh, pol)
    decode, template = steps.build_decode_step(cfg, mesh, pol, batch=B,
                                               cache_len=S + N)
    mesh.reset_counts()
    logits, cache = prefill(params, {"tokens": toks})
    outs = [logits]
    if sharded:
        record["prefill"] = _counters(mesh)
        cache = sharding.place(
            model.pad_cache(cfg, sharding.gather(cache), S + N),
            sharding.cache_shardings(mesh, template, pol))
        mesh.reset_counts()
    else:
        cache = model.pad_cache(cfg, cache, S + N)
    for i in range(N):
        logits, cache = decode(params, cache, {"tokens": forced[i][:, None]},
                               S + i)
        outs.append(logits)
    if sharded:
        record["decode"] = _counters(mesh)
        record["params"] = params
    return outs


def _counters(mesh):
    return (list(mesh.coll_tag_bytes.get(("all_gather", "fsdp"),
                                         [0] * mesh.size)),
            list(mesh.coll_group_bytes.get(("all_gather", mesh.size),
                                           [0] * mesh.size)))


@pytest.fixture
def shapes(monkeypatch):
    """Every sharded step's per-rank logits shapes, by mode."""
    seen = {"prefill": [], "decode": []}
    join = steps._global_logits

    def recorded(net, logits, rows, mode):
        seen[mode].append({tuple(t.shape) for t in logits})
        return join(net, logits, rows, mode)
    monkeypatch.setattr(steps, "_global_logits", recorded)
    return seen


def _gathers(cfg, mesh, params, pol):
    """``chip_smoke.py``'s count of one pass's FSDP gathers of every
    weight but ``embed`` and ``lm_head`` (the one S3 and S4 hold on the
    card): per rank, (operand bytes, those spanning every mesh axis)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke._other_weight_gathers(cfg, mesh, params, pol)


def _vocab_leaf_gathers(mesh, params):
    """Operand bytes a rank of gathering ``embed`` (lookup) and the head's
    weight over the data axes alone, once each a pass (0 where their
    blocks are their uses)."""
    out = [0] * mesh.size
    tied = "lm_head" not in params
    for name, dim in (("embed", 0), ("embed" if tied else "lm_head",
                                     0 if tied else 1)):
        leaf = params[name]
        if spmd._UsePlan(leaf.sharding, leaf.shape, dim).trivial:
            continue
        for r, b in enumerate(leaf.blocks):
            out[r] += b.numel() * b.element_size()
    return out


def _close(got, want, scale, tol=SERVE_TOL):
    for a, b in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=tol * scale, rtol=0)
        assert np.array_equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_in_vocab_blocks(arch, shape, shapes):
    cfg, net, toks, forced, want = _reference(arch)
    pol = ShardingPolicy()
    one = _serve(cfg, net, make_mesh((1, 1), ("data", "model"), "cpu"),
                 toks, forced, pol, {})
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    record = {}
    got = _serve(cfg, net, mesh, toks, forced, pol, record)
    scale = max(float(np.abs(w).max()) for w in want)
    tol = ARCH_TOL.get(arch, SERVE_TOL)
    _close(got, want, scale, tol)
    _close(got, one, scale, tol)
    rows = B // shape[0]
    assert shapes["decode"] == [{(rows, 1, cfg.vocab // shape[1])}] * N
    assert shapes["prefill"] == [{(rows, 1, cfg.vocab)}]
    total, spanning = _gathers(cfg, mesh, record["params"], pol)
    vocab = _vocab_leaf_gathers(mesh, record["params"])
    assert not any(vocab) or shape[0] > 1
    for mode, n in (("prefill", 1), ("decode", N)):
        fsdp, both_axes = record[mode]
        assert fsdp == [n * (a + v) for a, v in zip(total, vocab)], mode
        if min(shape) > 1:      # on (1, T) every gather is over the axis
            assert both_axes == [n * a for a in spanning], mode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-3-2b",
                                  "internvl2-2b"])
def test_lookup_equals_the_whole_table(arch, shape, dtype):
    """The sharded lookup against ``model.embed_inputs`` on the whole
    table, rank by rank; internvl2's patch embeddings replace the first
    positions of the prefill after the sum."""
    cfg = configs.smoke(arch).scaled(dtype=dtype)
    net = model.init(cfg, 1, "cpu")
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    pol = ShardingPolicy()
    params = steps.place_params(net, sharding.param_shardings(mesh, net,
                                                              pol))
    sm = ShardedModel(cfg, mesh, pol)
    assert sharding.vocab_block(params["embed"].sharding,
                                params["embed"].shape, 0, sm.T, 1) \
        == (cfg.vocab // shape[1], 2 * cfg.vocab // shape[1])
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 12)))
    prefill = {"tokens": toks}
    if cfg.frontend == "vlm":
        prefill["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.n_patches, cfg.d_model)).astype(np.float32))
    for mode, batch in (("prefill", prefill),
                        ("decode", {"tokens": toks[:, :1]})):
        per, _, _ = sm.split_batch(batch)
        with torch.no_grad():
            got = sm._embed(params, per, mode)
            for r, b in enumerate(per):
                assert torch.equal(got[r], model.embed_inputs(
                    cfg, net.embed, b, mode)), (mode, r)


@pytest.mark.parametrize("case", ["vocab126", "whole_embed"])
def test_whole_vocab_cases_match_reference(case, shapes):
    """Smoke granite with a vocab of 126 on (1, 4): the axis does not
    divide it, so the lookup and the head keep the whole vocab on every
    rank.  ``shard_embed_vocab=False`` (smoke granite, tied, and olmoe,
    untied, on (1, 4)): the lookup is from the whole table; decode's
    logits are split as the reference constrains them (a tied table held
    whole gives each rank its slice)."""
    if case == "vocab126":
        runs = [("granite-3-2b", dict(vocab=126), ShardingPolicy(), 126)]
    else:
        pol = ShardingPolicy(shard_embed_vocab=False)
        runs = [("granite-3-2b", {}, pol, 32), ("olmoe-1b-7b", {}, pol, 32)]
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    for arch, scale, pol, width in runs:
        cfg, net, toks, forced, want = _reference(arch, **scale)
        shapes["decode"].clear()
        sm = ShardedModel(cfg, mesh, pol)
        leaf = sharding.param_shardings(mesh, net, pol)["embed"]
        assert sharding.vocab_block(leaf, (cfg.vocab, cfg.d_model), 0, sm.T,
                                    0) is None
        got = _serve(cfg, net, mesh, toks, forced, pol, {})
        _close(got, want, max(float(np.abs(w).max()) for w in want))
        assert shapes["decode"] == [{(B, 1, width)}] * N, arch


def test_train_step_gradients_on_1x2():
    """Smoke olmoe on (1, 2): ``embed`` at P(model, data) looked up by
    vocab block; the step's gradients (AdamW's first moment / (1 - b1))
    against the one-rank step's, within ``grad_ratio``'s gate."""
    cfg = configs.smoke("olmoe-1b-7b").scaled(dtype="float32")
    opt_cfg = optim.OptimConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    batch = SyntheticLMData(cfg, batch=4, seq=32, seed=1).batch_at(0)
    moments = []
    for shape in ((1, 1), (1, 2)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        fn, shards = steps.build_train_step(cfg, mesh, ShardingPolicy(),
                                            opt_cfg)
        state = steps.init_train_state(cfg, opt_cfg, 0, device="cpu",
                                       shardings=shards
                                       if mesh.size > 1 else None)
        if mesh.size > 1:
            assert state.params["embed"].sharding.spec[0] == "model"
        state, _ = fn(state, batch)
        ref = steps.state_to_reference(state)
        moments.append({"/".join(map(str, p)): t.numpy() / (1 - opt_cfg.b1)
                        for p, t in zip(*_paths(ref.opt.m))})
    one, two = moments
    assert one.keys() == two.keys() and "embed" in one
    worst = max(grad_ratio(two[k], one[k]) for k in one)
    assert np.abs(one["embed"]).max() > 0
    assert worst <= 1.0, worst


def _paths(tree, path=()):
    """(paths, leaves) of a nested dict of tensors, in key order."""
    if isinstance(tree, dict):
        ps, ls = [], []
        for k in tree:
            p, leaves = _paths(tree[k], path + (k,))
            ps += p
            ls += leaves
        return ps, ls
    return [path], [tree]
