"""Tensor parallelism over the heads inside the port's Mamba2, mLSTM and
sLSTM blocks (``runtime/spmd.py``), against the same blocks run whole.

* Each block of smoke zamba2 (Mamba2) and smoke xlstm (mLSTM, sLSTM) in
  fp32, every parameter drawn with numpy from a seed, on CPU meshes (1, 2)
  and (2, 2): each rank computes its heads (``ShardedModel._recurrent``),
  the partial outputs are summed over the model axis, and one rank's copy
  is the loss's input.  Forward within ``FWD_TOL`` of the whole block's
  largest output; the gradient of every parameter leaf within
  ``GRAD_RTOL`` |g| + ``GRAD_LEAF_ATOL`` max|g_leaf| of the whole block's,
  and the input's likewise.  The two differ only in summation order: the
  norm's sum of squares is a sum of per-rank partial sums, the output
  projection's rows are summed over the ranks, and the gradients of the
  leaves every model rank uses whole (B, C, dt, conv, the mLSTM's ``wup``)
  are sums over the ranks.
* The decode caches of those blocks stay in place under TP: a prefill
  and two decode steps on (1, 2) and (2, 2) give the one-rank steps'
  logits, xlstm moves no cache piece between ranks, and zamba2 moves only
  pieces of its Mamba2 conv caches (the conv cache is held whole by every
  model rank; a rank writes back its own channels), never of an SSM state
  or of the shared attention's KV cache.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.mesh import ad_psum
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model
from repro_torch.models.config import MAMBA2, MLSTM, SLSTM
from repro_torch.runtime import sharding, spmd, steps
from repro_torch.runtime.sharding import Placed, ShardingPolicy
from repro_torch.runtime.spmd import ShardedModel
from torch_threads import one_intra_op_thread  # noqa: F401

MESHES = ((1, 2), (2, 2))
BLOCKS = (("zamba2-2.7b", "L0_0_mamba2", MAMBA2),
          ("xlstm-350m", "L0_0_mlstm", MLSTM),
          ("xlstm-350m", "L3_0_slstm", SLSTM))
B, S = 2, 32
FWD_TOL = 1e-5
GRAD_RTOL, GRAD_LEAF_ATOL = 1e-4, 1e-5
SERVE_TOL = 1e-5


def _cfg(arch):
    return configs.smoke(arch).scaled(dtype="float32")


def _randomise(module, seed):
    """Every parameter of ``module`` drawn from a seeded numpy generator:
    N(0, 1/fan_in) for the matrices, N(0, 0.5²) for the vectors (around 1
    for the norm scales and the skip ``D``, around 2 for the mLSTM's
    forget-gate bias), so that a slice taken from the wrong heads shows."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                fan = p.shape[-2]
                v = rng.standard_normal(p.shape) / np.sqrt(fan)
            else:
                v = 0.5 * rng.standard_normal(p.shape)
            if name in ("gn", "D"):
                v = 1.0 + v
            if name in ("bf",):
                v = 2.0 + v
            p.copy_(torch.from_numpy(v.astype(np.float32)))


def _grads(leaf: Placed) -> torch.Tensor:
    return Placed(leaf.sharding, leaf.shape,
                  [b.grad for b in leaf.blocks]).gather()


def _ratio(got, want) -> float:
    bound = GRAD_RTOL * want.abs() + GRAD_LEAF_ATOL * want.abs().max()
    diff = (got - want).abs()
    return float(torch.where(diff == 0, 0.0, diff / bound).max())


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch,name,kind", BLOCKS,
                         ids=[b[2] for b in BLOCKS])
def test_tp_block_matches_whole_block(arch, name, kind, shape):
    cfg = _cfg(arch)
    net = model.init(cfg, 0, "cpu")
    block = net.units[0].blocks[name]
    _randomise(block, 7)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                         .astype(np.float32))

    # the whole block
    block.requires_grad_(True)
    xw = x.clone().requires_grad_(True)
    want = block(xw)
    (want * w).sum().backward()
    want_grads = {k: p.grad.clone() for k, p in block.named_parameters()}

    # the block over the mesh, each rank on its heads
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    sm = ShardedModel(cfg, mesh, ShardingPolicy())
    assert sm.tensor_parallel()[name] == "tp"
    params = steps.place_params(net, sm.shardings)
    tree = params["layers"][name]
    for leaves in tree.values():
        for b in leaves[0].blocks:
            b.requires_grad_(True)
    xs = [x.clone().requires_grad_(True) for _ in range(mesh.size)]
    with mesh.region():
        hs, partial = sm._recurrent(("layers", name), kind,
                                    sm.shell.units[0].blocks[name], tree, 0,
                                    xs, None, False)
        assert partial
        outs = ad_psum(mesh, hs, sm.T)
        (outs[0] * w).sum().backward()
    scale = float(want.detach().abs().max())
    for r in range(mesh.size):
        err = float((outs[r] - want).abs().max())
        assert err <= FWD_TOL * scale, (r, err, scale)
    worst = 0.0
    for k, leaves in tree.items():
        got = _grads(leaves[0])
        assert got.shape == want_grads[k].shape
        worst = max(worst, _ratio(got, want_grads[k]))
    # the input's gradient: the sum over rank 0's model group, whose
    # copies of x each feed that rank's heads
    group = next(g for g in mesh.groups(sm.T) if 0 in g)
    dx = sum(xs[r].grad for r in group)
    worst = max(worst, _ratio(dx, xw.grad))
    print(f"{name} {shape}: max |out - whole| {err:.3g} of {scale:.3g}; "
          f"gradient ratio at most {worst:.3g}")
    assert worst <= 1.0, worst


def _serve(cfg, net, mesh, toks, n_decode):
    """Prefill of ``toks`` and ``n_decode`` greedy decode steps on
    ``mesh`` (one rank: the whole model): each step's logits, and the
    cache pieces every decode step moved between ranks."""
    pol = ShardingPolicy()
    length = toks.shape[1] + n_decode
    prefill = steps.build_prefill_step(cfg, mesh, pol)
    decode, template = steps.build_decode_step(cfg, mesh, pol, batch=B,
                                               cache_len=length)
    if mesh.size == 1:
        params, place = net, (lambda c: model.pad_cache(cfg, c, length))
    else:
        params = steps.place_params(net, sharding.param_shardings(mesh, net,
                                                                  pol))
        cache_sh = sharding.cache_shardings(mesh, template, pol)
        place = (lambda c: sharding.place(model.pad_cache(
            cfg, sharding.gather(c), length), cache_sh))
    logits, cache = prefill(params, {"tokens": toks})
    cache = place(cache)
    outs, moved = [logits], []
    move = spmd._move

    def recorded(mesh_, x, src, dst, out):
        if src != dst:
            moved.append(tuple(x.shape))
        return move(mesh_, x, src, dst, out)
    mesh.reset_counts()
    for i in range(n_decode):
        nxt = logits[:, -1].argmax(-1)[:, None]
        spmd._move = recorded
        try:
            logits, cache = decode(params, cache, {"tokens": nxt},
                                   toks.shape[1] + i)
        finally:
            spmd._move = move
        outs.append(logits)
    return outs, moved


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ("zamba2-2.7b", "xlstm-350m"))
def test_decode_caches_stay_in_place(arch, shape):
    cfg = _cfg(arch)
    net = model.init(cfg, 3, "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (B, 16)))
    want, _ = _serve(cfg, net, make_mesh((1, 1), ("data", "model"), "cpu"),
                     toks, 2)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    assert set(ShardedModel(cfg, mesh, ShardingPolicy()).tensor_parallel()
               .values()) == {"tp"}
    got, moved = _serve(cfg, net, mesh, toks, 2)
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= SERVE_TOL * scale
    sends = sum(mesh.coll_calls["ppermute"])
    if arch == "xlstm-350m":
        assert moved == [] and sends == 0
        return
    # zamba2: only pieces of the conv caches (unit, B rows, K-1, channels),
    # one send counted for each; no SSM state (5-d) or KV-cache piece moves
    K1 = cfg.ssm_conv - 1
    assert moved and all(len(p) == 4 and p[2] == K1 for p in moved), moved
    assert sends == len(moved)
