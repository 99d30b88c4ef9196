"""Train and serve step builders — the port of ``repro/runtime/steps.py``.

Two distribution modes, as in the reference:

* ``auto`` (:func:`build_train_step`): one step with the rule table's
  placements (:func:`state_shardings`).  On a mesh of one rank the state
  is a whole replica (a ``Model`` and its AdamW trees) and the step runs
  eagerly on the mesh's device.  On more ranks the state is placed
  (:func:`init_train_state` with ``shardings=``, or :func:`place_state`):
  every leaf of the parameters and of AdamW's ``m``, ``v`` and ``master``
  is a :class:`~repro_torch.runtime.sharding.Placed` of per-rank blocks,
  and :class:`~repro_torch.runtime.spmd.ShardedModel` runs the forward and
  backward with the FSDP, TP, SP and EP collectives that GSPMD inserts in
  the reference; gradients arrive reduce-scattered onto the blocks,
  the global grad norm is the ``psum`` of every rank's squared blocks
  (a block replicated over an axis counted once), and AdamW runs on each
  rank's blocks.  Both forms accumulate gradients over
  ``policy.microbatches`` (fp32 sums divided by M).
* ``manual`` DP (:func:`build_train_step_manual`): N logical ranks on the
  mesh's data-parallel axes.  Each rank holds a whole replica of the train
  state and runs its forward and backward on its own CUDA stream over its
  slice of the batch (dim 0 split over the DP axes, the reference's
  ``P(D, ...)``); ``core.overlap.sync_grads`` averages the gradients with
  the chosen schedule (fused / bucketed / sentinel) and every rank then
  takes the same optimizer step, so the replicas stay bitwise equal.

The serving steps (:func:`build_prefill_step`, :func:`build_decode_step`)
are thin wrappers over :func:`~repro_torch.models.model.apply` on a mesh
of one rank; on more they run the sharded model on parameters placed by
``param_shardings`` (:func:`place_params`) and decode caches placed by
``cache_shardings``.  :func:`abstract_params` and :func:`abstract_train_state`
give the shapes and dtypes without memory: trees of tensors on the
``meta`` device, the port's ``jax.eval_shape``.

A :class:`TrainState` holds the model itself (``params``, an
``nn.Module`` whose parameters require grad) and the optimizer state over
:func:`~repro_torch.models.model.param_tree`.  Steps update both in place
and return the same state.  :func:`state_to_reference` and
:func:`state_from_reference` convert to and from the reference's layout
(``TrainState(params, OptState(step, m, v, master))`` with stacked
layers), in which checkpoints are written, so either package restores the
other's.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import optim
from ..core import overlap
from ..core.overlap import tree_flatten, tree_unflatten
from ..launch.mesh import axis_size, dp_axes
from ..models import model
from ..models.config import ModelConfig
from .sharding import (P, NamedSharding, Placed, ShardingPolicy,
                       cache_shardings, check_policy, gather, map_tree,
                       param_shardings, place)
from .spmd import ShardedModel

__all__ = ["AUX_COEF", "TrainState", "init_train_state", "build_train_step",
           "build_train_step_manual", "abstract_params",
           "abstract_train_state", "build_prefill_step",
           "build_decode_step", "state_to_reference",
           "state_from_reference", "abstract_reference_state",
           "state_shardings", "place_state", "place_params", "gather_state"]

AUX_COEF = 0.01
GRAD_SYNC_MODES = ("fused", "bucketed", "sentinel")


class TrainState(NamedTuple):
    params: model.Model
    opt: optim.OptState


def init_train_state(cfg: ModelConfig, opt_cfg: optim.OptimConfig,
                     seed: int = 0, *, device=None,
                     shardings: Optional[TrainState] = None) -> TrainState:
    """A model with random weights from ``seed`` (``model.init``), its
    parameters made trainable, and a fresh AdamW state.  With
    ``shardings`` (:func:`state_shardings`, as :func:`build_train_step`
    returns them) the state is placed over their mesh: the same numbers,
    and no whole fp32 tree is ever made (the masters are cast from the
    placed parameters block by block)."""
    if shardings is not None:
        net = model.init(cfg, seed, device if device is not None
                         else shardings.opt.step.mesh.device)
        params = place(model.param_tree(net), shardings.params)
        del net
        return _opt_from_params(params)
    params = model.init(cfg, seed, device)
    params.requires_grad_(True)
    return TrainState(params=params,
                      opt=optim.init(model.param_tree(params)))


def _leaves(tree) -> List[Any]:
    """The leaves in ``tree_flatten``'s order (the optimizer's)."""
    return tree_flatten(tree)[0]


def _opt_from_params(params) -> TrainState:
    """A placed state from placed parameters: zero moments and fp32
    masters, block by block on each rank's stream; the parameter blocks
    made trainable."""
    mesh = _leaves(params)[0].sharding.mesh

    def like(fn):
        def one(_, leaf):
            blocks = []
            for r, b in enumerate(leaf.blocks):
                with mesh.on(r):
                    blocks.append(fn(b))
            return Placed(leaf.sharding, leaf.shape, blocks)
        return map_tree(one, params)

    f32 = torch.float32
    mesh.fork()
    with torch.no_grad():
        m = like(lambda b: torch.zeros(b.shape, dtype=f32, device=b.device))
        v = like(lambda b: torch.zeros(b.shape, dtype=f32, device=b.device))
        master = like(lambda b: b.to(f32, copy=True))
    mesh.join()
    for leaf in _leaves(params):
        for b in leaf.blocks:
            b.requires_grad_(True)
    return TrainState(params=params, opt=optim.OptState(
        step=torch.zeros((), dtype=torch.int32), m=m, v=v, master=master))


def state_shardings(mesh, abstract_state: TrainState,
                    policy: ShardingPolicy) -> TrainState:
    """The rule table's :class:`NamedSharding` of every leaf of a train
    state, as the reference's ``state_shardings``: the parameters by
    ``param_shardings``, ``m``, ``v`` and ``master`` alike, ``step``
    replicated.  ``abstract_state.params`` is a ``Model`` (the port's
    layout, one leaf per unit repeat) or a parameter tree in either
    layout (the reference's stacked one gets the reference's specs)."""
    ps = param_shardings(mesh, abstract_state.params, policy)
    return TrainState(params=ps, opt=optim.OptState(
        step=NamedSharding(mesh, P()), m=ps, v=ps, master=ps))


def place_state(state: TrainState, shardings: TrainState) -> TrainState:
    """A whole train state (a ``Model`` and its AdamW trees) placed by
    ``shardings`` (:func:`state_shardings`); the parameter blocks are
    trainable."""
    params = place(model.param_tree(state.params), shardings.params)
    for leaf in _leaves(params):
        for b in leaf.blocks:
            b.requires_grad_(True)
    opt = state.opt
    return TrainState(params=params, opt=optim.OptState(
        step=opt.step.clone(), m=place(opt.m, shardings.opt.m),
        v=place(opt.v, shardings.opt.v),
        master=place(opt.master, shardings.opt.master)))


def place_params(params: model.Model, shardings) -> Dict[str, Any]:
    """A model's parameter tree (``model.param_tree``) placed by
    ``shardings`` (``param_shardings``): what the sharded serving steps
    take."""
    return place(model.param_tree(params), shardings)


def gather_state(cfg: ModelConfig, state: TrainState, device=None
                 ) -> TrainState:
    """A placed train state made whole again: a ``Model`` holding the
    gathered parameters and the gathered AdamW trees (bitwise)."""
    tree = gather(state.params, device)
    net = model.Model(cfg, device if device is not None
                      else _leaves(tree)[0].device)
    with torch.no_grad():
        for p, t in zip(tree_flatten(model.param_tree(net))[0],
                        tree_flatten(tree)[0]):
            p.copy_(t)
    net.requires_grad_(True)
    return TrainState(params=net, opt=optim.OptState(
        step=state.opt.step.clone(), m=gather(state.opt.m, device),
        v=gather(state.opt.v, device),
        master=gather(state.opt.master, device)))


def _loss_fn(params: model.Model, batch, cfg: ModelConfig,
             remat: Optional[str], **impls):
    """(loss + AUX_COEF * MoE aux, loss)."""
    logits, _, aux = model.apply(params, batch, mode="train", remat=remat,
                                 **impls)
    loss = model.lm_loss(logits, batch["labels"])
    return loss + AUX_COEF * aux, loss


def _as_tensors(batch, device) -> Dict[str, torch.Tensor]:
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _clear_grads(params: model.Model) -> None:
    for p in params.parameters():
        p.grad = None


def _grads(params: model.Model, batch, cfg: ModelConfig,
           remat: Optional[str]):
    """(total, loss, gradient tree): one forward and backward.  The tree
    has :func:`model.param_tree`'s structure; a parameter the loss does
    not reach gets zeros, as ``jax.grad`` gives them."""
    _clear_grads(params)
    total, loss = _loss_fn(params, batch, cfg, remat)
    total.backward()
    leaves, treedef = tree_flatten(model.param_tree(params))
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    return total.detach(), loss.detach(), tree_unflatten(treedef, grads)


def _apply_update(opt_cfg, grads, state: TrainState) -> Tuple[TrainState,
                                                            Dict[str, Any]]:
    _, new_opt, metrics = optim.update(opt_cfg, grads, state.opt,
                                       model.param_tree(state.params))
    _clear_grads(state.params)
    return TrainState(state.params, new_opt), metrics


# ---------------------------------------------------------------------------
# auto mode
# ---------------------------------------------------------------------------
def build_train_step(cfg: ModelConfig, mesh, policy: ShardingPolicy,
                     opt_cfg: optim.OptimConfig, *, abstract_batch=None,
                     donate: bool = True):
    """``(state, batch) -> (state, metrics)`` and the state's shardings
    (:func:`state_shardings`), as the reference returns them.  ``batch``
    holds arrays or tensors; ``metrics`` has ``lr`` (float),
    ``grad_norm``, ``loss`` and ``total_loss`` (0-d tensors).  The state is
    updated in place (``donate`` is moot).  On a mesh of one rank the
    state is whole; on more it is placed by the shardings returned (see
    the module's note) and the batch's rows split over the batch axes."""
    check_policy(mesh, policy)
    shardings = state_shardings(
        mesh, abstract_train_state(cfg, opt_cfg), policy)
    if mesh.size != 1:
        return _sharded_train_step(cfg, mesh, policy, opt_cfg,
                                   shardings), shardings
    M = max(1, policy.microbatches)

    def train_step(state: TrainState, batch):
        batch = _as_tensors(batch, state.params.device)
        if M == 1:
            total, loss, grads = _grads(state.params, batch, cfg,
                                        policy.remat)
        else:
            # gradient accumulation: fp32 sums over the microbatches, then
            # divided by M, as the reference's scan does
            micro = {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])
                     for k, v in batch.items()}
            acc = total = loss = None
            for i in range(M):
                t, l, g = _grads(state.params,
                                 {k: v[i] for k, v in micro.items()}, cfg,
                                 policy.remat)
                g = [x.float() for x in tree_flatten(g)[0]]
                if acc is None:
                    acc, total, loss = g, t.float(), l.float()
                else:
                    acc = [a + b for a, b in zip(acc, g)]
                    total, loss = total + t, loss + l
            treedef = tree_flatten(model.param_tree(state.params))[1]
            grads = tree_unflatten(treedef, [a / M for a in acc])
            total, loss = total / M, loss / M
        state, metrics = _apply_update(opt_cfg, grads, state)
        return state, dict(metrics, loss=loss, total_loss=total)

    return train_step, shardings


def _sharded_grads(net: ShardedModel, params, batch, remat):
    """(total, loss, each leaf's per-rank gradient blocks): one forward
    and backward of every rank over its rows."""
    mesh = net.mesh
    leaves = _leaves(params)
    terms, aux = net.forward(params, batch, mode="train", remat=remat)
    mesh.join()
    owned = [t for t in terms if t is not None]
    loss = owned[0]
    for t in owned[1:]:
        loss = loss + t
    total = loss + AUX_COEF * aux
    flat = [b for leaf in leaves for b in leaf.blocks]
    got = torch.autograd.grad(total, flat, allow_unused=True)
    grads, i = [], 0
    for leaf in leaves:
        n = len(leaf.blocks)
        grads.append([g if g is not None else torch.zeros_like(b)
                      for g, b in zip(got[i:i + n], leaf.blocks)])
        i += n
    return total.detach(), loss.detach(), grads


def _global_norm(mesh, leaves, grads) -> List[torch.Tensor]:
    """Every rank's copy of the whole gradient's norm: the ``psum`` over
    the mesh of each rank's sum of squares over the blocks it is the
    first holder of (a block replicated over an axis counts once)."""
    holders = []            # per leaf: the first rank holding each block
    for leaf in leaves:
        first: Dict[Any, int] = {}
        for r in range(mesh.size):
            first.setdefault(leaf.box(r), r)
        holders.append(set(first.values()))
    local = []
    mesh.fork()
    for r in range(mesh.size):
        with mesh.on(r):
            sq = torch.zeros((), dtype=torch.float32, device=mesh.device)
            for first, g in zip(holders, grads):
                if r in first:
                    sq = sq + torch.sum(torch.square(g[r].float()))
            local.append(sq)
    total = mesh.psum(local, mesh.axis_names)
    out = []
    for r in range(mesh.size):
        with mesh.on(r):
            out.append(torch.sqrt(total[r]))
    return out


def _sharded_train_step(cfg, mesh, policy, opt_cfg, shardings):
    net = ShardedModel(cfg, mesh, policy)
    M = max(1, policy.microbatches)
    decays = optim.decays(model.param_tree(abstract_params(cfg)))

    def block_tree(tree, r):
        return map_tree(lambda _, leaf: leaf.blocks[r], tree)

    def train_step(state: TrainState, batch):
        batch = _as_tensors(batch, mesh.device)
        rows = next(iter(batch.values())).shape[0]
        if rows % M:
            raise ValueError(f"batch of {rows} does not split into "
                             f"{M} microbatches")
        leaves = _leaves(state.params)
        with mesh.region():
            acc = total = loss = None
            for i in range(M):
                mb = {k: v[i * rows // M:(i + 1) * rows // M]
                      for k, v in batch.items()} if M > 1 else batch
                t, l, g = _sharded_grads(net, state.params, mb,
                                         policy.remat)
                if M == 1:
                    acc, total, loss = g, t, l
                    break
                if acc is None:
                    acc = [[b.float() for b in bl] for bl in g]
                    total, loss = t.float(), l.float()
                else:
                    for a, bl in zip(acc, g):
                        for x, y in zip(a, bl):
                            x.add_(y)
                    total, loss = total + t, loss + l
            if M > 1:
                acc = [[b / M for b in bl] for bl in acc]
                total, loss = total / M, loss / M
            gnorm = _global_norm(mesh, leaves, acc)
            treedef = tree_flatten(state.params)[1]
            step = state.opt.step
            mesh.fork()
            for r in range(mesh.size):
                with mesh.on(r):
                    grads_r = tree_unflatten(treedef, [g[r] for g in acc])
                    _, new_opt, metrics = optim.update(
                        opt_cfg, grads_r, optim.OptState(
                            step, block_tree(state.opt.m, r),
                            block_tree(state.opt.v, r),
                            block_tree(state.opt.master, r)),
                        block_tree(state.params, r), grad_norm=gnorm[r],
                        decays=decays)
            del acc
        opt = optim.OptState(new_opt.step, state.opt.m, state.opt.v,
                             state.opt.master)
        return TrainState(state.params, opt), dict(
            lr=metrics["lr"], grad_norm=gnorm[0], loss=loss,
            total_loss=total)

    return train_step


# ---------------------------------------------------------------------------
# manual-DP mode (explicit grad-sync schedule; the paper's Level-B surface)
# ---------------------------------------------------------------------------
def _replica(state: TrainState) -> TrainState:
    """A deep copy of ``state`` made on the current stream."""
    leaves, treedef = tree_flatten(
        (state.opt.m, state.opt.v, state.opt.master))
    m, v, master = tree_unflatten(treedef, [t.clone() for t in leaves])
    return TrainState(copy.deepcopy(state.params),
                      optim.OptState(state.opt.step.clone(), m, v, master))


def build_train_step_manual(cfg: ModelConfig, mesh, policy: ShardingPolicy,
                            opt_cfg: optim.OptimConfig, *,
                            grad_sync: Optional[str] = None,
                            bucket_bytes: int = 4 << 20,
                            compress: Optional[str] = None):
    """Manual data parallelism over the mesh's DP axes with an explicit
    gradient-synchronisation schedule.  Requires ``policy.fsdp == False``.

    Returns ``make(abstract_state, abstract_batch) -> step`` as the
    reference does (the abstract arguments are not needed here).  ``step(
    state, batch)`` copies ``state`` to the other ranks once (on their
    streams; ``step.replicas()`` lists every rank's state), runs each
    rank's forward and backward on its own stream over its slice of
    ``batch``, averages the gradients with ``core.overlap.sync_grads``,
    runs the optimizer on every rank, and returns rank 0's state (the one
    passed in, updated in place) with ``loss`` the mean over ranks and
    ``total_loss``, ``lr`` and ``grad_norm`` rank 0's.  A different state
    passed later is copied to the ranks afresh.
    """
    if policy.fsdp:
        raise ValueError("manual grad-sync mode implies fsdp=False")
    mode = grad_sync or policy.grad_sync
    if mode not in GRAD_SYNC_MODES:
        raise ValueError(f"grad sync mode must be one of {GRAD_SYNC_MODES},"
                         f" got {mode!r}")
    check_policy(mesh, policy)
    D = dp_axes(mesh)
    n_dp = axis_size(mesh, D)

    def make(abstract_state=None, abstract_batch=None):
        held: Dict[str, Any] = {"params": None, "states": None}

        def replicas(state: TrainState):
            if held["params"] is not state.params:
                states = [state]
                with mesh.region():
                    for r in range(1, mesh.size):
                        with mesh.on(r):
                            states.append(_replica(state))
                held["params"], held["states"] = state.params, states
            return held["states"]

        def step(state: TrainState, batch):
            states = replicas(state)
            batch = _as_tensors(batch, state.params.device)
            rows = next(iter(batch.values())).shape[0]
            if rows % n_dp:
                raise ValueError(f"batch of {rows} does not split over "
                                 f"{n_dp} data-parallel ranks")
            per = rows // n_dp
            # Rank r's backward runs on its stream (autograd replays each
            # op's backward on the stream its forward ran on), and
            # sync_grads packs rank r's gradients on that same stream, so
            # stream order alone keeps the reads after the backward.
            totals, losses, grads = [], [], []
            with mesh.region():
                for r in range(mesh.size):
                    i = mesh.axis_index(r, D) if D else 0
                    with mesh.on(r):
                        t, l, g = _grads(
                            states[r].params,
                            {k: v[i * per:(i + 1) * per]
                             for k, v in batch.items()},
                            cfg, policy.remat)
                    totals.append(t)
                    losses.append(l)
                    grads.append(g)
                grads = overlap.sync_grads(grads, mesh=mesh, axes=D,
                                           mode=mode,
                                           bucket_bytes=bucket_bytes,
                                           compress=compress)
                metrics = []
                for r in range(mesh.size):
                    with mesh.on(r):
                        states[r], m = _apply_update(opt_cfg, grads[r],
                                                     states[r])
                    metrics.append(m)
            loss = torch.stack(losses).sum() / len(losses)
            return states[0], dict(metrics[0], loss=loss,
                                   total_loss=totals[0])

        step.replicas = lambda: list(held["states"] or ())
        return step

    return make


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def abstract_params(cfg: ModelConfig) -> model.Model:
    """The model with every parameter on the ``meta`` device: shapes and
    dtypes, no memory (the reference's ``jax.eval_shape`` of ``init``)."""
    return model.Model(cfg, device="meta")


def abstract_train_state(cfg: ModelConfig,
                         opt_cfg: optim.OptimConfig) -> TrainState:
    """:func:`init_train_state`'s shapes and dtypes on the ``meta``
    device: the model of :func:`abstract_params` and its AdamW state."""
    params = abstract_params(cfg)
    return TrainState(params=params,
                      opt=optim.init(model.param_tree(params)))


def _global_logits(net: ShardedModel, logits: List[torch.Tensor], rows,
                   mode: str) -> torch.Tensor:
    """The ranks' logits (their rows, their vocab blocks:
    ``net.logit_vocab(mode)``) as one (B, 1, V) tensor on the caller's
    stream: each distinct (row block, vocab block) piece from its first
    holder, the pieces joined along V, then along B."""
    net.mesh.join()
    seen: Dict[Tuple[Tuple[int, int], Tuple[int, int]], int] = {}
    for r, piece in enumerate(zip(rows, net.logit_vocab(mode))):
        seen.setdefault(tuple(map(tuple, piece)), r)
    row_blocks = sorted({p[0] for p in seen})
    return torch.cat([torch.cat([logits[seen[p]] for p in sorted(seen)
                                 if p[0] == b], dim=-1)
                      for b in row_blocks], dim=0)


def _sharded_prefill(cfg, mesh, policy):
    net = ShardedModel(cfg, mesh, policy)

    def prefill(params, batch):
        batch = _as_tensors(batch, mesh.device)
        B, S = next(iter(batch.values())).shape[:2]
        full = model.init_cache(cfg, B, S, device=mesh.device)
        cache = place(full, cache_shardings(mesh, full, policy))
        del full
        with torch.no_grad(), mesh.region():
            logits = net.forward(params, batch, mode="prefill", cache=cache)
            _, rows, _ = net.split_batch(batch)
            out = _global_logits(net, logits, rows, "prefill")
        return out, cache

    return prefill


def build_prefill_step(cfg: ModelConfig, mesh, policy: ShardingPolicy, *,
                       abstract_batch=None):
    """``(params, batch) -> (last-position logits (B, 1, V), cache)``:
    one prefill pass under ``torch.no_grad``, allocating a cache of the
    prompt's length (grow it with ``model.pad_cache`` for decode).
    ``abstract_batch`` is accepted for the reference's signature.  On a
    mesh of more than one rank ``params`` is placed (:func:`place_params`)
    and so is the cache returned (``cache_shardings``; ``sharding.gather``
    makes it whole)."""
    check_policy(mesh, policy)
    if mesh.size != 1:
        return _sharded_prefill(cfg, mesh, policy)

    def prefill(params: model.Model, batch):
        batch = _as_tensors(batch, params.device)
        with torch.no_grad():
            logits, cache, _ = model.apply(params, batch, mode="prefill")
        return logits, cache

    return prefill


def build_decode_step(cfg: ModelConfig, mesh, policy: ShardingPolicy, *,
                      batch: int, cache_len: int, abstract_batch=None,
                      donate: bool = True):
    """``(step, cache template)`` as the reference returns ``(jitted,
    a_cache)``: ``step(params, cache, batch, cache_index) -> (logits,
    cache)`` runs one decode position under ``torch.no_grad`` and writes
    the cache in place (so ``donate`` is moot); the template is
    ``model.init_cache(cfg, batch, cache_len)`` on the ``meta``
    device.  On a mesh of more than one rank ``params`` is placed
    (:func:`place_params`) and ``cache`` by ``cache_shardings(mesh,
    template, policy)``."""
    check_policy(mesh, policy)
    template = model.init_cache(cfg, batch, cache_len, device="meta")
    if mesh.size != 1:
        net = ShardedModel(cfg, mesh, policy, decode=True)

        def sharded_decode(params, cache, batch_, cache_index):
            batch_ = _as_tensors(batch_, mesh.device)
            with torch.no_grad(), mesh.region():
                logits = net.forward(params, batch_, mode="decode",
                                     cache=cache,
                                     cache_index=int(cache_index))
                _, rows, _ = net.split_batch(batch_)
                out = _global_logits(net, logits, rows, "decode")
            return out, cache

        return sharded_decode, template

    def decode(params: model.Model, cache, batch_, cache_index):
        batch_ = _as_tensors(batch_, params.device)
        with torch.no_grad():
            logits, cache, _ = model.apply(params, batch_, mode="decode",
                                           cache=cache,
                                           cache_index=int(cache_index))
        return logits, cache

    return decode, template


# ---------------------------------------------------------------------------
# the reference's layout (checkpoints)
# ---------------------------------------------------------------------------
def state_to_reference(state: TrainState) -> TrainState:
    """The state in the reference's tree: params as
    ``model.params_to_reference`` lays them out, ``m``, ``v`` and
    ``master`` stacked alike (copies), ``step`` a 0-d int32 tensor."""
    lay = model.to_reference_layout
    if not isinstance(state.params, model.Model):     # placed: gathered
        return TrainState(params=lay(gather(state.params)), opt=optim.OptState(
            step=state.opt.step.clone(), m=lay(gather(state.opt.m)),
            v=lay(gather(state.opt.v)), master=lay(gather(state.opt.master))))
    return TrainState(
        params=model.params_to_reference(state.params),
        opt=optim.OptState(step=state.opt.step.clone(), m=lay(state.opt.m),
                           v=lay(state.opt.v), master=lay(state.opt.master)))


def abstract_reference_state(cfg: ModelConfig) -> TrainState:
    """The reference-layout train state with ``meta`` tensors as leaves:
    the template ``checkpoint.restore_checkpoint`` takes."""
    params = model.params_to_reference(model.Model(cfg, device="meta"))
    leaves, treedef = tree_flatten(params)
    f32 = lambda: tree_unflatten(treedef, [  # noqa: E731
        torch.empty(t.shape, dtype=torch.float32, device="meta")
        for t in leaves])
    return TrainState(params=params, opt=optim.OptState(
        step=torch.zeros((), dtype=torch.int32), m=f32(), v=f32(),
        master=f32()))


def _unstack(ref_tree, like, device):
    """``ref_tree`` (the reference's layout) in ``like``'s structure
    (:func:`model.param_tree`'s), fp32 on ``device``."""
    if isinstance(like, dict):
        return {k: _unstack(ref_tree[k], like[k], device) for k in like}
    t = ref_tree if isinstance(ref_tree, torch.Tensor) else \
        torch.from_numpy(np.array(ref_tree, dtype=np.float32))
    t = t.to(device=device, dtype=torch.float32)
    if isinstance(like, tuple):
        return tuple(t[r].clone() for r in range(len(like)))
    return t.clone()


def _unstack_placed(ref_tree, like):
    """A placed tree in the reference's layout in ``like``'s structure
    (:func:`model.param_tree`'s): each stacked leaf, placed with a
    leading ``None``, cut into one placed leaf a repeat (copies)."""
    if isinstance(like, dict):
        return {k: _unstack_placed(ref_tree[k], like[k]) for k in like}
    if isinstance(like, tuple):
        sh = ref_tree.sharding
        per = NamedSharding(sh.mesh, P(*sh.full_spec(ref_tree.ndim)[1:]))
        return tuple(Placed(per, ref_tree.shape[1:],
                            [b[u].clone() for b in ref_tree.blocks])
                     for u in range(len(like)))
    return ref_tree


def state_from_reference(cfg: ModelConfig, ref_state, *,
                         device=None) -> TrainState:
    """A train state from the reference's layout (a restored checkpoint's
    tree, tensors or arrays): the inverse of :func:`state_to_reference`.
    A tree restored with ``shardings`` (placed leaves) gives the placed
    state in the port's layout, on the same mesh."""
    if isinstance(ref_state.opt.master["final_norm"]["scale"], Placed):
        like = model.param_tree(abstract_params(cfg))
        step = ref_state.opt.step
        if isinstance(step, Placed):
            step = step.blocks[0]
        out = TrainState(
            params=_unstack_placed(ref_state.params, like),
            opt=optim.OptState(
                step=torch.tensor(int(step), dtype=torch.int32),
                m=_unstack_placed(ref_state.opt.m, like),
                v=_unstack_placed(ref_state.opt.v, like),
                master=_unstack_placed(ref_state.opt.master, like)))
        for leaf in _leaves(out.params):
            for b in leaf.blocks:
                b.requires_grad_(True)
        return out
    params = model.params_from_reference(cfg, ref_state.params,
                                         device=device)
    params.requires_grad_(True)
    like = model.param_tree(params)
    dev = params.device
    opt = ref_state.opt
    return TrainState(params=params, opt=optim.OptState(
        step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32),
        m=_unstack(opt.m, like, dev), v=_unstack(opt.v, like, dev),
        master=_unstack(opt.master, like, dev)))
