"""Train and serve step builders — the port of ``repro/runtime/steps.py``.

Two distribution modes, as in the reference:

* ``auto``: one rank (:func:`build_train_step`).  The reference lets GSPMD
  shard a jitted step over a mesh; here the step runs eagerly on the
  mesh's one device, with gradient accumulation over
  ``policy.microbatches`` (fp32 sums divided by M).
* ``manual`` DP (:func:`build_train_step_manual`): N logical ranks on the
  mesh's data-parallel axes.  Each rank holds a whole replica of the train
  state and runs its forward and backward on its own CUDA stream over its
  slice of the batch (dim 0 split over the DP axes, the reference's
  ``P(D, ...)``); ``core.overlap.sync_grads`` averages the gradients with
  the chosen schedule (fused / bucketed / sentinel) and every rank then
  takes the same optimizer step, so the replicas stay bitwise equal.

The serving steps (:func:`build_prefill_step`, :func:`build_decode_step`)
are thin wrappers over :func:`~repro_torch.models.model.apply` on the
mesh's one rank.  :func:`abstract_params` and :func:`abstract_train_state`
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
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import optim
from ..core import overlap
from ..core.overlap import tree_flatten, tree_unflatten
from ..launch.mesh import axis_size, dp_axes
from ..models import model
from ..models.config import ModelConfig
from .sharding import ShardingPolicy, check_policy

__all__ = ["AUX_COEF", "TrainState", "init_train_state", "build_train_step",
           "build_train_step_manual", "abstract_params",
           "abstract_train_state", "build_prefill_step",
           "build_decode_step", "state_to_reference",
           "state_from_reference", "abstract_reference_state"]

AUX_COEF = 0.01
GRAD_SYNC_MODES = ("fused", "bucketed", "sentinel")


class TrainState(NamedTuple):
    params: model.Model
    opt: optim.OptState


def init_train_state(cfg: ModelConfig, opt_cfg: optim.OptimConfig,
                     seed: int = 0, *, device=None) -> TrainState:
    """A model with random weights from ``seed`` (``model.init``), its
    parameters made trainable, and a fresh AdamW state."""
    params = model.init(cfg, seed, device)
    params.requires_grad_(True)
    return TrainState(params=params,
                      opt=optim.init(model.param_tree(params)))


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
    """``(state, batch) -> (state, metrics)`` on the mesh's one rank, and
    ``None`` where the reference returns the state's shardings.  ``batch``
    holds arrays or tensors; ``metrics`` has ``lr`` (float),
    ``grad_norm``, ``loss`` and ``total_loss`` (0-d tensors).  The state is
    updated in place (``donate`` is moot)."""
    check_policy(mesh, policy)
    if mesh.size != 1:
        raise ValueError(f"auto mode runs on one rank, the mesh has "
                         f"{mesh.size}: use build_train_step_manual")
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

    return train_step, None


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


def _serving_policy(mesh, policy: ShardingPolicy) -> None:
    check_policy(mesh, policy)
    if mesh.size != 1:
        raise ValueError(f"the serving steps run on one rank, the mesh has "
                         f"{mesh.size}")


def build_prefill_step(cfg: ModelConfig, mesh, policy: ShardingPolicy, *,
                       abstract_batch=None):
    """``(params, batch) -> (last-position logits (B, 1, V), cache)``:
    one prefill pass under ``torch.no_grad``, allocating a cache of the
    prompt's length (grow it with ``model.pad_cache`` for decode).
    ``abstract_batch`` is accepted for the reference's signature (nothing
    is placed)."""
    _serving_policy(mesh, policy)

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
    device."""
    _serving_policy(mesh, policy)
    template = model.init_cache(cfg, batch, cache_len, device="meta")

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


def state_from_reference(cfg: ModelConfig, ref_state, *,
                         device=None) -> TrainState:
    """A train state from the reference's layout (a restored checkpoint's
    tree, tensors or arrays): the inverse of :func:`state_to_reference`."""
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
