"""The port's dry run (``repro_torch.launch.dryrun``), its cost model
(``repro_torch.analysis.op_cost``) and the mesh's collective counters,
against the JAX package's.

* The cost model on ``tests/test_hlo_cost.py``'s known programs, written
  in torch and run on ``meta`` tensors, with that test's own assertions
  and bands.  The hand-written collective module becomes two ``ppermute``
  calls and one ``psum`` of f32[1024] on a 4-rank ``LogicalMesh``.
* The dry run against the reference at smoke size: one JAX subprocess
  (forced host devices) builds the reference's steps for smoke configs on
  a (2, 2) mesh by its ``dryrun.lower_cell``'s own steps (that function
  takes only full-size names) and reads ``memory_analysis`` and
  ``module_cost``.  Per cell: ``params``, ``active_params`` and
  ``tokens`` equal; ``argument_bytes`` a device equal (the reference
  alone passes decode's int32 cache index, 4 bytes); FLOPs within
  :data:`FLOP_BAND`.  The collective operand bytes are held to an
  analytic count only for the port's FSDP gathers and gradient
  reductions (gathered leaf bytes x gathers a step); the reference's
  bytes per kind are printed beside the port's, not gated, because XLA's
  partitioner chooses its own collectives (it moves the same data with
  all-reduces and all-to-alls where the port reduce-scatters).
* Every smoke cell of all ten archs runs on (2, 2), port side only; the
  per-rank argument bytes follow from the rule table's specs (which
  ``tests/test_torch_sharding.py`` holds equal to the reference's); the
  per-rank FLOP excess over one rank's is printed (zamba2 and xlstm
  compute their Mamba2, mLSTM and sLSTM blocks whole on every model
  rank).
* ``make_production_mesh``: the reference's shape, axis names and rank
  order, on ``meta`` with no stream.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.analysis.op_cost import (COLLECTIVE_KINDS, OpCounter,
                                          collective_cost)
from repro_torch.core.mesh import LogicalMesh, ad_all_gather, ad_psum
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model
from repro_torch.models.config import ShapeConfig, applicable_shapes
from repro_torch.runtime import sharding
from repro_torch.runtime.sharding import ShardingPolicy
from repro_torch.runtime.spmd import ShardedModel
from torch_threads import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

# (arch, kind, seq or cache length, global batch): the cells held to the
# reference
CELLS = (("granite-3-2b", "train", 64, 8), ("olmoe-1b-7b", "prefill", 64, 4),
         ("granite-3-2b", "decode", 64, 4))
SMOKE_SHAPES = {"train": (64, 8), "prefill": (64, 4), "decode": (64, 4)}

# The port's FLOPs over the reference's at these cells measured 1.010
# (granite train), 0.936 (olmoe prefill) and 1.069 (granite decode): the
# matmuls agree; the rest is the eager ops against XLA's fused HLO (the
# port's plain attention loops over 128-key tiles, the reference's jnp path
# is chunked; XLA drops or fuses some elementwise work).
FLOP_BAND = (0.9, 1.1)

_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, sys
import jax, jax.numpy as jnp
from repro import configs, optim
from repro.compat import mesh_axis_kwargs
from repro.models import model, inputs
from repro.models.config import ShapeConfig
from repro.runtime.sharding import ShardingPolicy
from repro.runtime import steps
from repro.launch import mesh as meshlib
from repro.analysis.hlo_cost import module_cost

out = {"cells": {}}
for name, mp in (("16x16", False), ("2x16x16", True)):
    m = meshlib.make_production_mesh(multi_pod=mp)
    out[name] = {"shape": [int(s) for s in m.devices.shape],
                 "names": list(m.axis_names),
                 "ids": [int(d.id) for d in m.devices.flat]}
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     **mesh_axis_kwargs(2))
for arch, kind, seq, batch in json.loads(sys.argv[1]):
    cfg = configs.smoke(arch)
    shape = ShapeConfig(kind + "_s", seq, batch, kind)
    opt_cfg = optim.OptimConfig()
    ab = inputs.batch_spec(cfg, shape)
    pol = ShardingPolicy()
    with mesh:
        if kind == "train":
            jitted, _ = steps.build_train_step(cfg, mesh, pol, opt_cfg,
                                               abstract_batch=ab)
            lowered = jitted.lower(steps.abstract_train_state(cfg, opt_cfg),
                                   ab)
        elif kind == "prefill":
            jitted = steps.build_prefill_step(cfg, mesh, pol,
                                              abstract_batch=ab)
            lowered = jitted.lower(steps.abstract_params(cfg), ab)
        else:
            jitted, a_cache = steps.build_decode_step(
                cfg, mesh, pol, batch=batch, cache_len=seq,
                abstract_batch=ab, donate=False)
            lowered = jitted.lower(steps.abstract_params(cfg), a_cache, ab,
                                   jax.ShapeDtypeStruct((), jnp.int32))
    compiled = lowered.compile()
    mem = compiled.memory_analysis()
    mc = module_cost(compiled.as_text(), n_devices=4)
    params = jax.eval_shape(lambda k: model.init(cfg, k),
                            jax.random.PRNGKey(0))
    out["cells"][arch + "|" + kind] = {
        "params": model.param_count(params),
        "active_params": model.active_param_count(params, cfg),
        "tokens": batch * (1 if kind == "decode" else seq),
        "argument_bytes": mem.argument_size_in_bytes,
        "flops": mc.flops, "coll_bytes": mc.coll_bytes,
        "coll_counts": mc.coll_counts}
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE,
                           json.dumps(CELLS)], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def _run(arch, kind, seq, batch, mesh_shape=(2, 2)):
    cfg = configs.smoke(arch)
    mesh = make_mesh(mesh_shape, ("data", "model"), "meta")
    rec = dryrun.run_cell(cfg, ShapeConfig(kind + "_s", seq, batch, kind),
                          multi_pod=False, policy=ShardingPolicy(),
                          mesh=mesh)
    return cfg, mesh, rec


# ---------------------------------------------------------------------------
# the cost model on tests/test_hlo_cost.py's programs
# ---------------------------------------------------------------------------
def _meta(*shape):
    return torch.empty(shape, device="meta")


def _scanned(x, ws):
    for i in range(ws.shape[0]):
        x = torch.tanh(x @ ws[i])
    return x.sum()


def _flops(fn, *args):
    """``fn(*args)``'s cost: one rank's ops issued outside any rank."""
    with OpCounter(1) as counter:
        fn(*args)
    return counter.outside


@pytest.mark.parametrize("L", [3, 8])
def test_forward_scan_flops(L):
    c = _flops(_scanned, _meta(128, 256), _meta(L, 256, 256))
    dots = 2 * 128 * 256 * 256 * L
    assert dots <= c.flops <= 1.1 * dots  # dots + small elementwise


@pytest.mark.parametrize("L", [3, 8])
def test_grad_scan_flops(L):
    """Backward adds 2x the forward matmul cost.  ``lax.scan``'s backward
    body is the same at every step, so the reference's program computes
    the carry's gradient at the first step too; the eager program computes
    it when asked for, so the weights' gradient is taken with the input's."""
    x = _meta(128, 256).requires_grad_(True)
    ws = _meta(L, 256, 256).requires_grad_(True)
    c = _flops(lambda x, ws: torch.autograd.grad(_scanned(x, ws), (ws, x))[0],
               x, ws)
    dots = 3 * 2 * 128 * 256 * 256 * L
    assert 0.95 * dots <= c.flops <= 1.15 * dots


def test_unrolled_matches_scanned():
    def unrolled(x, ws):
        for w in ws.unbind(0):
            x = torch.tanh(torch.matmul(x, w))
        return x.sum()

    L = 6
    x, ws = _meta(64, 128), _meta(L, 128, 128)
    cs, cu = _flops(_scanned, x, ws), _flops(unrolled, x, ws)
    assert abs(cs.flops - cu.flops) / cu.flops < 0.15


def test_bytes_scale_with_trip_count():
    x = _meta(128, 256)
    b4 = _flops(_scanned, x, _meta(4, 256, 256)).bytes
    b8 = _flops(_scanned, x, _meta(8, 256, 256)).bytes
    assert 1.4 < b8 / b4 < 3.5


def test_dot_contracting_dims():
    c = _flops(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
               _meta(4, 32, 64), _meta(4, 64, 16))
    expected = 2 * 4 * 32 * 16 * 64
    assert expected <= c.flops <= 1.05 * expected + 1e4


def test_counter_outputs_are_the_meta_kernels():
    """The counter's cached output metadata equals what the meta kernels
    give, where only a scalar's type tells two calls apart."""
    x = torch.empty(4, 3, dtype=torch.int32, device="meta")
    with OpCounter(1) as counter:
        ints, floats = x * 2, x * 2.0
        again_ints, again_floats = x * 2, x * 2.0
    assert (ints.dtype, floats.dtype) == (torch.int32, torch.float32)
    assert (again_ints.dtype, again_floats.dtype) == \
        (torch.int32, torch.float32)
    assert counter.outside.flops == 4 * 12


def test_collective_counts_and_wire_bytes():
    """The reference test's hand-written module: two collective-permutes
    and one all-reduce of f32[1024] over 4 ranks."""
    mesh = LogicalMesh((4,), ("x",), "cpu")
    xs = [torch.ones(1024) for _ in range(4)]
    ring = [(i, (i + 1) % 4) for i in range(4)]
    cp1 = mesh.ppermute(xs, "x", ring)
    cp2 = mesh.ppermute(cp1, "x", ring)
    mesh.psum(cp2, "x")
    for c in collective_cost(mesh):
        assert c.coll_counts["collective-permute"] == 2
        assert c.coll_counts["all-reduce"] == 1
        assert c.coll_bytes["collective-permute"] == 2 * 4096
        assert c.coll_wire_bytes["collective-permute"] == 2 * 4096
        assert c.coll_wire_bytes["all-reduce"] == pytest.approx(
            4096 * 2 * 3 / 4)
    mesh.reset_counts()
    assert all(c.total_coll_bytes == 0 and not any(c.coll_counts.values())
               for c in collective_cost(mesh))


def test_counters_outermost_all_to_all_and_backward():
    """A collective run inside another counts once, as the outer one;
    ``all_to_all`` counts; the differentiable collectives' backward passes
    count as the adjoint collectives."""
    mesh = LogicalMesh((2, 2), ("data", "model"), "cpu")
    xs = [torch.ones(8, 3) for _ in range(4)]
    with mesh.collective("all_gather") as outer:
        assert outer
        mesh.psum(xs, "model")
    assert mesh.coll_calls["psum"] == [0] * 4
    mesh.all_to_all([torch.ones(2, 5) for _ in range(4)], "data")
    assert mesh.coll_calls["all_to_all"] == [1] * 4
    assert mesh.coll_bytes["all_to_all"] == [40] * 4
    ws = [torch.ones(4, 3, requires_grad=True) for _ in range(4)]
    mesh.reset_counts()
    ys = ad_all_gather(mesh, ws, "model", dim=0)
    zs = ad_psum(mesh, ys, "data")
    sum(z.sum() for z in zs).backward()
    assert mesh.coll_calls["all_gather"] == [1] * 4
    assert mesh.coll_calls["psum"] == [2] * 4           # forward + backward
    assert mesh.coll_calls["reduce_scatter"] == [1] * 4  # all_gather's
    assert mesh.coll_bytes["reduce_scatter"] == [8 * 3 * 4] * 4
    assert mesh.coll_group_bytes[("psum", 2)] == [2 * 8 * 3 * 4] * 4


# ---------------------------------------------------------------------------
# the dry run against the reference
# ---------------------------------------------------------------------------
def _block_bytes(mesh, leaf, spec) -> int:
    n = math.prod(leaf.shape) * leaf.element_size()
    for e in spec:
        if e is not None:
            n //= mesh.axis_size(e)
    return n


def _fsdp_expected(cfg, mesh, policy):
    """(all-gather, reduce-scatter, all-reduce) operand bytes a rank of
    the FSDP weight gathers and gradient reductions of one train step,
    from the placements.  A leaf whose use is not its own block is
    gathered at every use, its block the operand, and at every use of a
    unit's leaf under ``remat="dots"`` again when the unit is recomputed;
    the tied LM head's weight is gathered again in the backward (the
    matmul saves it, and the saved copy is regathered).  Each forward use
    reduces its gradient once, the use's bytes the operand: a
    reduce-scatter where the block is smaller than the use, else (a leaf
    replicated over ranks) an all-reduce."""
    net = ShardedModel(cfg, mesh, policy)
    tree = model.param_tree(model.Model(cfg, device="meta"))
    shards = sharding.param_shardings(mesh, tree, policy)
    T = net.T
    out = [0, 0, 0]

    def add(leaf, sh, keep, n_gather, n_reduce):
        spec = sh.full_spec(leaf.dim())
        split = [d for d, e in enumerate(spec) if e is not None]
        kept = mesh.axis_size(T) if keep is not None and keep in split \
            else 1
        use = math.prod(leaf.shape) * leaf.element_size() // kept
        if not split or split == [keep]:
            out[2] += n_reduce * use
            return
        out[0] += n_gather * _block_bytes(mesh, leaf, spec)
        out[1] += n_reduce * use

    for key, blocks in tree["layers"].items():
        keep = net.keep.get(("layers", key), {})
        for w, parts in blocks.items():
            for leaf, sh in zip(parts, shards["layers"][key][w]):
                add(leaf, sh, keep.get(w), 2, 1)   # forward + recompute
    assert not cfg.tie_embeddings or "lm_head" not in tree
    tied = 1 if cfg.tie_embeddings else 0
    add(tree["embed"], shards["embed"], None, 1 + 2 * tied, 1 + tied)
    add(tree["final_norm"]["scale"], shards["final_norm"]["scale"], None,
        2, 1)
    if "lm_head" in tree:
        add(tree["lm_head"], shards["lm_head"], None, 2, 1)
    return tuple(out)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_cell_matches_reference(cell, reference):
    arch, kind, seq, batch = cell
    cfg, mesh, rec = _run(*cell)
    ref = reference["cells"][f"{arch}|{kind}"]
    assert rec["ok"]
    for k in ("params", "active_params", "tokens"):
        assert rec[k] == ref[k], k
    cache_index = 4 if kind == "decode" else 0   # the reference's int32
    assert rec["memory"]["argument_bytes"] + cache_index \
        == ref["argument_bytes"]
    ratio = rec["cost"]["flops"] / ref["flops"]
    print(f"{arch} {kind}: flops port/reference {ratio:.4f}")
    assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1]
    for k in COLLECTIVE_KINDS:
        print(f"  {k}: port {rec['collectives']['bytes'][k]:.0f} B "
              f"({rec['collectives']['counts'][k]:.0f}), reference "
              f"{ref['coll_bytes'][k]:.0f} B ({ref['coll_counts'][k]:.0f})")
    if kind == "train":
        want = _fsdp_expected(cfg, mesh, ShardingPolicy())
        fsdp = rec["collectives"]["fsdp_bytes"]
        assert (fsdp["all-gather"], fsdp["reduce-scatter"],
                fsdp["all-reduce"]) == want
        assert all(want)


def test_production_mesh_matches_reference(reference):
    for name, mp in (("16x16", False), ("2x16x16", True)):
        mesh = make_production_mesh(multi_pod=mp)
        ref = reference[name]
        assert list(mesh.shape.values()) == ref["shape"]
        assert list(mesh.axis_names) == ref["names"]
        assert mesh.device.type == "meta" and mesh.streams is None
        ids = torch.tensor(ref["ids"]).reshape(ref["shape"])
        for r in (0, 1, 17, mesh.size - 1):
            c = mesh.coords(r)
            assert int(ids[tuple(c[a] for a in mesh.axis_names)]) == r


# ---------------------------------------------------------------------------
# every arch's smoke cells, port side
# ---------------------------------------------------------------------------
def _spec_bytes(mesh, tree, shards, extra_per_elem=0) -> int:
    """One rank's bytes of a parameter tree by the specs alone, plus
    ``extra_per_elem`` bytes an element (AdamW's fp32 m, v and master)."""
    out = 0
    for leaf, sh in zip(sharding_leaves(tree), sharding_leaves(shards)):
        n = _block_bytes(mesh, leaf, sh.full_spec(leaf.dim()))
        out += n + n // leaf.element_size() * extra_per_elem
    return out


def sharding_leaves(tree):
    out = []
    sharding.map_tree(lambda _, x: out.append(x), tree)
    return out


def _batch_block_bytes(mesh, cfg, kind, seq, batch):
    spec = dryrun.batch_spec(cfg, ShapeConfig("s", seq, batch, kind))
    shs = sharding.batch_shardings(mesh, spec, ShardingPolicy())
    return sum(_block_bytes(mesh, t, shs[k].full_spec(t.dim()))
               for k, t in spec.items())


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_smoke_cell_runs(arch):
    cfg = configs.smoke(arch)
    tree = model.param_tree(model.Model(cfg, device="meta"))
    for shape in applicable_shapes(cfg):
        if shape.name == "long_500k":
            continue
        seq, batch = SMOKE_SHAPES[shape.kind]
        _, mesh, rec = _run(arch, shape.kind, seq, batch)
        assert rec["ok"] and rec["n_devices"] == 4
        shards = sharding.param_shardings(mesh, tree, ShardingPolicy())
        want = _batch_block_bytes(mesh, cfg, shape.kind, seq, batch)
        if shape.kind == "train":
            want += _spec_bytes(mesh, tree, shards, 12) + 4   # + step
        else:
            want += _spec_bytes(mesh, tree, shards)
        if shape.kind == "decode":
            cache = model.init_cache(cfg, batch, seq, device="meta")
            want += _spec_bytes(mesh, cache, sharding.cache_shardings(
                mesh, cache, ShardingPolicy()))
        assert max(rec["per_rank"]["argument_bytes"]) == want, shape.kind
        assert rec["memory"]["peak_device_bytes"] == \
            rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
        assert rec["cost"]["flops"] > 0 and rec["cost"]["flops_of"] == \
            "plain"
        if shape.kind == "train":
            one = _run(arch, shape.kind, seq, batch, (1, 1))[2]
            excess = sum(rec["per_rank"]["flops"]) / one["cost"]["flops"]
            print(f"{arch} train: FLOPs summed over the 4 ranks / one "
                  f"rank's = {excess:.3f}; per rank "
                  f"{rec['cost']['flops']:.4e} against "
                  f"{one['cost']['flops'] / 4:.4e} ideal")


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_counts_equal_the_real_steps(shape):
    """What ``chip_smoke.py`` phase D checks on the card, on CPU ranks: the
    dry run's collective calls and operand bytes per kind and rank equal
    those of one real train step of the same cell, and its argument bytes
    a rank equal the placed state's plus the step count's and the rows of
    the batch the step slices for the rank."""
    from repro_torch import optim
    from repro_torch.data import SyntheticLMData
    from repro_torch.runtime import steps
    cfg = configs.smoke("granite-3-2b")
    policy, opt_cfg = ShardingPolicy(), optim.OptimConfig()
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    fn, shards = steps.build_train_step(cfg, mesh, policy, opt_cfg)
    state = steps.init_train_state(cfg, opt_cfg, 0, device="cpu",
                                   shardings=shards)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLMData(cfg, batch=8, seq=64, seed=0).batch_at(0)
             .items()}
    held = sharding.placed_bytes((state.params, state.opt), mesh)
    # each rank's rows of the batch: the views the sharded step slices
    rows, _, _ = ShardedModel(cfg, mesh, policy).split_batch(batch)
    args = [h + 4 + sum(t.numel() * t.element_size() for t in b.values())
            for h, b in zip(held, rows)]
    mesh.reset_counts()
    fn(state, batch)
    real = (mesh.coll_calls, mesh.coll_bytes)
    meta = make_mesh(shape, ("data", "model"), "meta")
    rec = dryrun.run_cell(cfg, ShapeConfig("t", 64, 8, "train"),
                          multi_pod=False, policy=policy, mesh=meta)
    assert (meta.coll_calls, meta.coll_bytes) == real
    assert rec["per_rank"]["argument_bytes"] == args
