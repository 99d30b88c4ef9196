"""The port's sharding rule table and placement against the JAX package's.

* ``param_shardings``, ``batch_shardings`` and ``cache_shardings``: for
  every leaf of the ten configs at full size, on the meshes (16, 16),
  (2, 16, 16), (4, 2), (2, 2) and (4, 1), under ``ShardingPolicy()``,
  ``fsdp_axes="all"``, ``tp=False``, ``fsdp_experts=False`` and
  ``shard_embed_vocab=False``, the port's spec equals the reference's
  entry by entry.  The reference's specs come from one JAX subprocess that
  calls its functions on abstract trees (``jax.eval_shape``) with a mesh
  that has only names and sizes (its ``NamedSharding`` replaced by the
  bare spec): no device is needed.  The port's parameter tree holds one
  leaf per unit repeat, whose spec is the reference's without its leading
  ``None``; the port's functions given the reference's stacked layout
  (``model.params_to_reference``) give the reference's specs as they are.
* ``place`` / ``gather`` round-trip bitwise, and the ranks' bytes sum to
  one replica's plus each replicated block's extra copies.
* ``LogicalMesh.reduce_scatter`` and the tiled ``all_gather`` against
  numpy; the differentiable collectives' backward passes are the adjoint
  collectives (``torch.autograd.gradcheck``-style against the sums).
* ``python -m repro_torch.launch.train --mesh 2x2`` with the default
  policy trains smoke granite on 4 CPU ranks.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs, optim
from repro_torch.core.mesh import ad_all_gather, ad_psum, ad_reduce_scatter
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model
from repro_torch.runtime import sharding, steps
from repro_torch.runtime.sharding import ShardingPolicy

ROOT = Path(__file__).resolve().parents[1]

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
POLICIES = {"default": {}, "fsdp_all": {"fsdp_axes": "all"},
            "no_tp": {"tp": False}, "no_fsdp_experts": {"fsdp_experts": False},
            "no_vocab": {"shard_embed_vocab": False}}
# abstract batches and caches: (batch, seq or cache length); 8 rows do not
# split over 16 data ranks, 32 do
BATCHES = ((8, 64), (32, 128))
CACHES = ((2, 64), (32, 96))

_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp
import repro.runtime.sharding as S
from repro import configs
from repro.models import model

S.NamedSharding = lambda mesh, spec: tuple(spec)

class Mesh:
    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def path_str(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {path_str(p): enc(v) for p, v in leaves}

meshes, policies, batches, caches = json.loads(sys.argv[1])
out = {}
for arch in configs.ARCHS:
    cfg = configs.get(arch)
    params = jax.eval_shape(lambda k: model.init(cfg, k),
                            jax.random.PRNGKey(0))
    abatches = []
    for b, s in batches:
        if cfg.frontend == "audio":
            ab = {"embeds": jax.ShapeDtypeStruct((b, s, cfg.d_model),
                                                 jnp.float32)}
        else:
            ab = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
            if cfg.frontend == "vlm":
                ab["patch_embeds"] = jax.ShapeDtypeStruct(
                    (b, 16, cfg.d_model), jnp.float32)
        ab["labels"] = jax.ShapeDtypeStruct((b, s), jnp.int32)
        abatches.append(ab)
    acaches = [jax.eval_shape(lambda: model.init_cache(cfg, b, t))
               for b, t in caches] if cfg.causal else []
    for mname, (shape, names) in meshes.items():
        mesh = Mesh(shape, names)
        for pname, kw in policies.items():
            pol = S.ShardingPolicy(**kw)
            out[f"{arch}|{mname}|{pname}|params"] = flat(
                S.param_shardings(mesh, params, pol))
            for i, ab in enumerate(abatches):
                out[f"{arch}|{mname}|{pname}|batch{i}"] = flat(
                    S.batch_shardings(mesh, ab, pol))
            for i, ac in enumerate(acaches):
                out[f"{arch}|{mname}|{pname}|cache{i}"] = flat(
                    S.cache_shardings(mesh, ac, pol))
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    arg = json.dumps([{k: [list(s), list(n)] for k, (s, n) in
                       MESHES.items()}, POLICIES, BATCHES, CACHES])
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, arg], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, prefix=()):
    """path -> encoded spec, with the reference's path strings."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (i,)))
    else:
        out["/".join(str(p) for p in prefix)] = _enc(tree.spec)
    return out


def _mesh(name):
    shape, names = MESHES[name]
    return make_mesh(shape, names, "meta")


def _abstract_batch(cfg, b, s):
    meta = dict(device="meta")
    if cfg.frontend == "audio":
        ab = {"embeds": torch.empty((b, s, cfg.d_model), **meta)}
    else:
        ab = {"tokens": torch.empty((b, s), dtype=torch.int32, **meta)}
        if cfg.frontend == "vlm":
            ab["patch_embeds"] = torch.empty((b, 16, cfg.d_model), **meta)
    ab["labels"] = torch.empty((b, s), dtype=torch.int32, **meta)
    return ab


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_shardings_match_reference(reference_specs, mesh_name):
    mesh = _mesh(mesh_name)
    n = 0
    for arch in configs.ARCHS:
        net = model.Model(configs.get(arch), device="meta")
        stacked = model.params_to_reference(net)
        for pname, kw in POLICIES.items():
            pol = ShardingPolicy(**kw)
            want = reference_specs[f"{arch}|{mesh_name}|{pname}|params"]
            # the reference's layout: the reference's specs, as they are
            got = _flat(sharding.param_shardings(mesh, stacked, pol))
            assert got == want, (arch, pname)
            # the port's layout: one leaf a repeat, the leading None dropped
            per = _flat(sharding.param_shardings(mesh, net, pol))
            for path, spec in per.items():
                head, _, idx = path.rpartition("/")
                if path.startswith("layers/"):
                    assert idx.isdigit()
                    assert [None] + spec == want[head], (arch, pname, path)
                else:
                    assert spec == want[path], (arch, pname, path)
                n += 1
    assert n > 1000


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_shardings_match_reference(reference_specs,
                                                   mesh_name):
    mesh = _mesh(mesh_name)
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        for pname, kw in POLICIES.items():
            pol = ShardingPolicy(**kw)
            for i, (b, s) in enumerate(BATCHES):
                got = _flat(sharding.batch_shardings(
                    mesh, _abstract_batch(cfg, b, s), pol))
                assert got == reference_specs[
                    f"{arch}|{mesh_name}|{pname}|batch{i}"], (arch, pname)
            if not cfg.causal:
                continue
            for i, (b, t) in enumerate(CACHES):
                got = _flat(sharding.cache_shardings(
                    mesh, model.init_cache(cfg, b, t, device="meta"), pol))
                assert got == reference_specs[
                    f"{arch}|{mesh_name}|{pname}|cache{i}"], (arch, pname)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (4, 1)])
def test_place_and_gather_round_trip(shape):
    cfg = configs.smoke("olmoe-1b-7b")
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    opt_cfg = optim.OptimConfig()
    state = steps.init_train_state(cfg, opt_cfg, 3, device="cpu")
    sh = steps.state_shardings(mesh, steps.abstract_train_state(
        cfg, opt_cfg), ShardingPolicy())
    placed = steps.place_state(state, sh)
    back = steps.gather_state(cfg, placed)
    for a, b in zip(steps.tree_flatten(steps.state_to_reference(state))[0],
                    steps.tree_flatten(steps.state_to_reference(back))[0]):
        assert torch.equal(a, b)
    # every rank's bytes: its blocks; together one replica, plus the
    # extra copies of each block held by more than one rank
    per_rank = sharding.placed_bytes((placed.params, placed.opt), mesh)
    replica = extra = 0
    for leaf in steps.tree_flatten((placed.params, placed.opt.m,
                                    placed.opt.v, placed.opt.master))[0]:
        size = math.prod(leaf.shape) * leaf.blocks[0].element_size()
        replica += size
        extra += size * (leaf.sharding.replicas() - 1)
    for leaf in steps.tree_flatten(placed.params)[0]:
        assert all(b.requires_grad for b in leaf.blocks)
    for leaf in steps.tree_flatten(placed.opt.master)[0]:
        assert not any(b.requires_grad for b in leaf.blocks)
    assert sum(per_rank) == replica + extra
    whole = sum(t.numel() * t.element_size() for t in steps.tree_flatten(
        (model.param_tree(state.params), state.opt.m, state.opt.v,
         state.opt.master))[0])
    assert replica == whole
    # a leaf sharded on both axes of (2, 2) is held once
    if shape == (2, 2):
        wq = placed.params["layers"]["L0_0_attn"]["wq"][0]
        assert wq.sharding.replicas() == 1
        assert tuple(wq.blocks[0].shape) == (32, 32)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _values(mesh, shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape)) for _ in
            range(mesh.size)]


@pytest.mark.parametrize("axis", ["data", "model", ("data", "model")])
def test_reduce_scatter_and_tiled_all_gather(axis):
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    xs = _values(mesh, (8, 3), 1)
    out = mesh.reduce_scatter(xs, axis, dim=0)
    for g in mesh.groups(axis):
        total = sum(xs[q] for q in g)
        k = 8 // len(g)
        for i, r in enumerate(g):
            np.testing.assert_allclose(out[r], total[i * k:(i + 1) * k])
    gathered = mesh.all_gather(out, axis, dim=0, tiled=True)
    psum = mesh.psum(xs, axis)
    for r in range(mesh.size):
        np.testing.assert_allclose(gathered[r], psum[r], rtol=1e-15)
    assert mesh.coll_calls["reduce_scatter"] == [1] * 8
    assert mesh.coll_calls["all_gather"] == [1] * 8
    stacked = mesh.all_gather(xs, axis)      # the untiled form, unchanged
    for g in mesh.groups(axis):
        for r in g:
            assert torch.equal(stacked[r], torch.stack([xs[q] for q in g]))


def test_differentiable_collectives_are_adjoint():
    """For each collective C and random cotangents w, the gradient of
    sum_r <C(x)_r, w_r> is C's adjoint applied to w: all_gather's is a
    reduce-scatter, reduce_scatter's an all-gather, psum's a psum."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    xs = [x.requires_grad_(True) for x in _values(mesh, (4, 2), 2)]
    cases = [(lambda v: ad_all_gather(mesh, v, "model", dim=0),
              lambda w: mesh.reduce_scatter(w, "model", dim=0)),
             (lambda v: ad_reduce_scatter(mesh, v, "data", dim=0),
              lambda w: mesh.all_gather(w, "data", dim=0, tiled=True)),
             (lambda v: ad_psum(mesh, v, ("data", "model")),
              lambda w: mesh.psum(w, ("data", "model")))]
    for fwd, adj in cases:
        ys = fwd(xs)
        ws = _values(mesh, tuple(ys[0].shape), 3)
        total = sum((y * w).sum() for y, w in zip(ys, ws))
        got = torch.autograd.grad(total, xs)
        for g, want in zip(got, adj(ws)):
            np.testing.assert_allclose(g, want, rtol=1e-12)


def test_sharded_model_plans():
    """How each block runs over the model axis, decided from the rule
    table: tensor-parallel attention and MLP, attention over its query
    heads alone where the KV heads do not divide the axis, EP where the
    experts divide the axis, TP experts where they do not, Mamba2 / mLSTM
    / sLSTM blocks tensor-parallel over their heads where the heads divide
    the axis and whole where they do not."""
    from repro_torch.runtime.spmd import ShardedModel
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    pol = ShardingPolicy()
    plans = {a: ShardedModel(configs.smoke(a), mesh, pol).tensor_parallel()
             for a in ("granite-3-2b", "olmoe-1b-7b", "zamba2-2.7b",
                       "mixtral-8x22b")}
    assert set(plans["granite-3-2b"].values()) == {"tp"}
    assert plans["olmoe-1b-7b"] == {"L0_0_attn": "tp", "L0_1_moe": "ep"}
    assert plans["zamba2-2.7b"]["attn"] == plans["zamba2-2.7b"]["mlp"] \
        == "tp"
    assert plans["mixtral-8x22b"]["L0_1_moe"] == "ep"
    wide = make_mesh((1, 8), ("data", "model"), "meta")
    assert ShardedModel(configs.smoke("mixtral-8x22b"), wide,
                        pol).tensor_parallel()["L0_1_moe"] == "tp_experts"
    assert set(ShardedModel(configs.smoke("granite-3-2b"), mesh,
                            ShardingPolicy(fsdp_axes="all"))
               .tensor_parallel().values()) == {"whole"}
    zamba = plans["zamba2-2.7b"]
    assert [k for k in zamba if k.endswith("_mamba2")] == \
        [f"L{i}_0_mamba2" for i in range(6)]
    assert set(zamba.values()) == {"tp"}
    xlstm = ShardedModel(configs.smoke("xlstm-350m"), mesh,
                         pol).tensor_parallel()
    assert xlstm == {"L0_0_mlstm": "tp", "L1_0_mlstm": "tp",
                     "L2_0_mlstm": "tp", "L3_0_slstm": "tp"}
    # 4 heads on an 8-way model axis
    assert set(ShardedModel(configs.smoke("xlstm-350m"), wide, pol)
               .tensor_parallel().values()) == {"whole"}
    # smoke granite's 4 query heads divide a model axis of 4, its 2 KV
    # heads do not: attention over the query heads alone; on 8 neither
    # divides and the attention runs whole
    for shape in ((1, 4), (2, 4)):
        four = make_mesh(shape, ("data", "model"), "meta")
        assert ShardedModel(configs.smoke("granite-3-2b"), four, pol) \
            .tensor_parallel() == {"L0_0_attn": "tp_q", "L0_1_mlp": "tp"}
    assert ShardedModel(configs.smoke("granite-3-2b"), wide, pol) \
        .tensor_parallel() == {"L0_0_attn": "whole", "L0_1_mlp": "tp"}
    # granite-3-2b's 32 query and 8 KV heads on the production mesh's
    # 16-way model axis
    sixteen = make_mesh((1, 16), ("data", "model"), "meta")
    assert ShardedModel(configs.get("granite-3-2b"), sixteen, pol) \
        .tensor_parallel() == {"L0_0_attn": "tp_q", "L0_1_mlp": "tp"}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_train_cli_mesh_2x2_default_policy():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--scale", "smoke", "--steps", "3", "--batch", "4", "--seq", "16",
         "--log-every", "1", "--mesh", "2x2"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ranks=4" in proc.stdout
    losses = [float(line.split("loss=")[1].split()[0])
              for line in proc.stdout.splitlines() if "loss=" in line]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    per_rank = [line for line in proc.stdout.splitlines()
                if line.startswith("[train] train state per rank")]
    assert len(per_rank) == 1 and per_rank[0].count(",") == 3
