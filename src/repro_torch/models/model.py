"""Composable block-pattern language model — the port of
``repro/models/model.py`` for every block kind of the JAX package
(attention, sliding-window attention, MLP, mixture of experts, Mamba2, the
xLSTM mLSTM and sLSTM blocks and Zamba2's shared attention).

A model is ``cfg.pattern`` (a repeating unit of layers, each a tuple of
blocks) applied ``cfg.repeats`` times, pre-norm with residual connections.
The JAX package scans stacked parameters; here each repeat is one
``nn.Module`` in a ``ModuleList`` and the loop is a Python loop.  Block and
norm names inside a unit are the reference's (``L{li}_{bi}_{kind}``,
``L{li}_{bi}_norm``), so :func:`params_from_reference` maps the JAX tree
one to one.  A ``shared_attn`` entry has neither a norm nor weights of its
own: the one :class:`~repro_torch.models.layers.SharedAttention` of the
model (the reference's ``params["shared"]``) is handed to every unit,
with the embedding output ``x0``.

Three entry modes (:func:`apply`, which returns ``(logits, cache, aux)``
as the reference's does; ``aux`` is the MoE blocks' load-balancing loss
summed over the model, 0 without MoE):

* ``train``   — full sequence, logits for every position;
* ``prefill`` — full sequence, the cache filled, logits for the last
  position only (what ``runtime/steps.py``'s prefill step returns);
* ``decode``  — one token against the fixed-size cache at ``cache_index``.

Training (``runtime/steps.py``) differentiates ``train`` mode through
autograd: the parameters are created with ``requires_grad=False`` (serving
runs under ``torch.inference_mode``) and the train state turns them on.
``remat`` recomputes each unit's activations in the backward, as the
reference's ``jax.checkpoint`` of its scan body does: ``"full"`` keeps only
each unit's input, ``"dots"`` also keeps the outputs of the products with
a weight (``dots_with_no_batch_dims_saveable``).  :func:`lm_loss` is the
reference's loss; :func:`param_tree` lays the parameters out as the
reference's tree with one entry per unit, and :func:`params_to_reference`
stacks them into its layout (the inverse of
:func:`params_from_reference`).

The cache (:func:`init_cache`) is the reference's layout: per attention or
shared-attention entry, k and v of shape (repeats, B, T, Hkv, dh); per
Mamba2 block, the SSD ``state`` (repeats, B, H, P, n) fp32 and the
``conv`` tail (repeats, B, K-1, d_inner + 2n); per mLSTM block ``C``
(repeats, B, H, dh, dh), ``n`` (repeats, B, H, dh) and ``m`` (repeats, B,
H), per sLSTM block ``c``, ``n``, ``h`` and ``m`` (repeats, B, d), all
fp32.  Unlike the JAX package, which returns new arrays, prefill and
decode write it in place.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.mesh import resolve_device
from . import layers as L
from .config import (ModelConfig, ATTN, SWA, MLP, MOE, MAMBA2, MLSTM, SLSTM,
                     SHARED_ATTN)

Cache = Dict[str, Dict[str, torch.Tensor]]
MODES = ("train", "prefill", "decode")
REMATS = (None, "full", "dots")

# Products with a weight (x @ w, 2-D or folded to 2-D): what "dots" saves,
# as jax's dots_with_no_batch_dims_saveable keeps dot_generals without batch
# dimensions (attention's batched products are recomputed).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpointed(fn, remat: Optional[str], *xs):
    """``fn(*xs)``, its activations recomputed in the backward under
    ``remat`` (``torch.utils.checkpoint``, non-reentrant)."""
    if remat is None:
        return fn(*xs)
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    extra = {}
    if remat == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(fn, *xs, use_reentrant=False, **extra)


def _run_unit(unit, x, remat: Optional[str], **kw):
    """``unit(x, **kw)`` under ``remat`` (:func:`checkpointed`)."""
    return checkpointed(functools.partial(unit, **kw), remat, x)


def _block_names(cfg: ModelConfig):
    """(block name, norm name, kind) of every block of the unit, in order;
    the norm name is None for a ``shared_attn`` entry, which has none."""
    return [(f"L{li}_{bi}_{kind}",
             None if kind == SHARED_ATTN else f"L{li}_{bi}_norm", kind)
            for li, layer in enumerate(cfg.pattern)
            for bi, kind in enumerate(layer)]


class Unit(nn.Module):
    """One repeat of ``cfg.pattern``: a norm and a block per entry, except
    the ``shared_attn`` entries, which run the model's shared block."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleDict()
        for name, norm_name, kind in _block_names(cfg):
            if kind == SHARED_ATTN:
                continue
            self.blocks[norm_name] = L.Norm(cfg, device)
            if kind in (ATTN, SWA):
                self.blocks[name] = L.Attention(cfg, device)
            elif kind == MAMBA2:
                self.blocks[name] = L.Mamba2(cfg, device)
            elif kind == MLSTM:
                self.blocks[name] = L.MLSTM(cfg, device)
            elif kind == SLSTM:
                self.blocks[name] = L.SLSTM(cfg, device)
            elif kind == MOE:
                self.blocks[name] = L.MoE(cfg, device)
            elif kind == MLP:
                self.blocks[name] = L.MLPBlock(cfg, device)
            else:               # as the reference's _block_init
                raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")

    def forward(self, x: torch.Tensor, *, x0: torch.Tensor,
                shared: Optional[L.SharedAttention], angles: torch.Tensor,
                mode: str,
                cache: Optional[Dict[str, Dict[str, torch.Tensor]]],
                cache_index: Optional[int], attn_impl: Optional[str],
                ssd_impl: Optional[str], mlstm_impl: Optional[str],
                moe_impl: Optional[str]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x, the unit's MoE aux loss, fp32)."""
        cfg = self.cfg
        decode = mode == "decode"
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for name, norm_name, kind in _block_names(cfg):
            c = cache.get(name) if cache is not None else None
            if kind == SHARED_ATTN:
                x = x + shared(x, x0, angles=angles, cache=c,
                               cache_index=cache_index if decode else None,
                               impl=attn_impl)
                continue
            xin = self.blocks[norm_name](x)
            if kind == MLP:
                h = self.blocks[name](xin)
            elif kind == MOE:
                h, a = self.blocks[name](xin, impl=moe_impl)
                aux = aux + a
            elif kind == MAMBA2:
                h = self.blocks[name](xin, cache=c, decode=decode,
                                      impl=ssd_impl)
            elif kind == MLSTM:
                h = self.blocks[name](xin, cache=c, decode=decode,
                                      impl=mlstm_impl)
            elif kind == SLSTM:
                h = self.blocks[name](xin, cache=c, decode=decode)
            else:
                win = cfg.sliding_window if kind == SWA else None
                h = self.blocks[name](
                    xin, angles=angles, window=win, cache=c,
                    cache_index=cache_index if decode else None,
                    impl=attn_impl)
            x = x + h
        return x, aux


class Model(nn.Module):
    """Embedding, ``cfg.repeats`` units, the shared attention block (where
    the pattern has one), final norm and (untied or audio frontend) an LM
    head ``(d_model, vocab)``.  Weights are allocated uninitialised: use
    :func:`init` or :func:`params_from_reference`."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        dt = cfg.activation_dtype
        if cfg.frontend != "audio":
            self.embed = L._param((cfg.vocab, cfg.d_model), dt, device)
        self.units = nn.ModuleList(Unit(cfg, device)
                                   for _ in range(cfg.repeats))
        self.shared = (L.SharedAttention(cfg, device)
                       if any(SHARED_ATTN in layer for layer in cfg.pattern)
                       else None)
        self.final_norm = L.Norm(cfg, device)
        if not cfg.tie_embeddings or cfg.frontend == "audio":
            self.lm_head = L._param((cfg.d_model, cfg.vocab), dt, device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        head = getattr(self, "lm_head", None)
        return project_out(self.cfg, self.final_norm(x),
                           head if head is not None else self.embed,
                           tied=head is None)

    def forward(self, batch: Mapping[str, torch.Tensor], *,
                mode: str = "train", cache: Optional[Cache] = None,
                cache_index: Optional[int] = None,
                attn_impl: Optional[str] = None,
                ssd_impl: Optional[str] = None,
                mlstm_impl: Optional[str] = None,
                moe_impl: Optional[str] = None,
                remat: Optional[str] = None
                ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
        cfg = self.cfg
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
        if mode == "decode" and (cache is None or cache_index is None):
            raise ValueError("decode needs a cache and a cache_index")
        x = embed_inputs(cfg, getattr(self, "embed", None), batch, mode)
        B, S = x.shape[:2]
        if mode == "decode":
            positions = torch.full((B, S), int(cache_index), device=x.device)
        else:
            positions = torch.arange(S, device=x.device).expand(B, S)
        angles = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        x0 = x
        if mode == "prefill" and cache is None:
            cache = init_cache(cfg, B, S, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for r, unit in enumerate(self.units):
            unit_cache = None if mode == "train" else {
                name: {n: t[r] for n, t in c.items()}
                for name, c in cache.items()}
            x, a = _run_unit(
                unit, x, remat if mode == "train" else None, x0=x0,
                shared=self.shared, angles=angles, mode=mode,
                cache=unit_cache, cache_index=cache_index,
                attn_impl=attn_impl, ssd_impl=ssd_impl,
                mlstm_impl=mlstm_impl, moe_impl=moe_impl)
            aux = aux + a
        if mode == "prefill":
            x = x[:, -1:]
        return self._head(x), (None if mode == "train" else cache), aux


def apply(model: Model, batch: Mapping[str, torch.Tensor], *,
          mode: str = "train", cache: Optional[Cache] = None,
          cache_index: Optional[int] = None,
          attn_impl: Optional[str] = None, ssd_impl: Optional[str] = None,
          mlstm_impl: Optional[str] = None, moe_impl: Optional[str] = None,
          remat: Optional[str] = None
          ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Forward pass; returns ``(logits, cache, aux)``, ``aux`` the MoE
    load-balancing loss summed over blocks (fp32 scalar).  ``attn_impl``
    is handed to ``ops.flash_attention``, ``ssd_impl`` to
    ``ops.mamba2_ssd``, ``mlstm_impl`` to ``ops.mlstm_chunked`` and
    ``moe_impl`` to ``ops.moe_gmm`` (None or "cuda": the kernel on the
    card; "ref": its plain version).  Prefill without a cache
    allocates one of length S; with one, it fills positions [0, S) of it
    and every recurrent block's state (from the zero state, whatever the
    cache held).  ``remat`` (``None``, ``"full"`` or ``"dots"``) applies
    in ``train`` mode."""
    return model(batch, mode=mode, cache=cache, cache_index=cache_index,
                 attn_impl=attn_impl, ssd_impl=ssd_impl,
                 mlstm_impl=mlstm_impl, moe_impl=moe_impl, remat=remat)


def embed_inputs(cfg: ModelConfig, table: Optional[torch.Tensor],
                 batch: Mapping[str, torch.Tensor], mode: str
                 ) -> torch.Tensor:
    """The residual stream's input (B, S, d): the audio frontend's
    ``embeds``, else ``table``'s rows for the tokens, with a VLM's patch
    embeddings in place of the first positions outside decode.  (The
    sharded steps call it on each rank's rows.)"""
    if cfg.frontend == "audio":
        return batch["embeds"].to(cfg.activation_dtype)
    x = table[batch["tokens"]]
    if cfg.frontend == "vlm" and mode != "decode" \
            and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def project_out(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor, *,
                tied: bool) -> torch.Tensor:
    """The logits of the normed ``x``: ``x @ w`` for an LM head (d, V),
    ``x @ w.T`` for the tied embedding (V, d), soft-capped where
    ``cfg.logit_softcap`` is set."""
    logits = x @ w.T if tied else x @ w
    if cfg.logit_softcap > 0:
        cap = cfg.logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's cross-entropy in fp32: log-sum-exp of the fp32
    logits minus the label's logit.  logits (B, S, V); labels (B, S)."""
    lf = logits.float()
    return torch.logsumexp(lf, dim=-1) - torch.gather(
        lf, -1, labels[..., None].long())[..., 0]


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy in fp32 (``repro/models/model.py``
    ``lm_loss``): :func:`token_nll` averaged over the positions, or over
    the ``mask``-weighted positions.  logits (B, S, V); labels (B, S)."""
    nll = token_nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device=None) -> Cache:
    """A zeroed fixed-size cache, as the reference's ``init_cache``: k and v
    of shape (repeats, batch, cache_len, Hkv, dh) in ``cfg.dtype`` for
    every attention and shared-attention entry; for every Mamba2 block the
    SSD ``state`` (repeats, batch, H, P, n) in fp32 and the ``conv`` tail
    (repeats, batch, K-1, d_inner + 2n) in ``cfg.dtype``; for every mLSTM
    block ``C``, ``n`` (zeros) and ``m`` (-1e30), for every sLSTM block
    ``c``, ``h``, ``m`` (zeros) and ``n`` (ones), fp32, as the reference's
    ``mlstm_cache_init`` and ``slstm_cache_init``."""
    device = resolve_device(device)
    dt, R = cfg.activation_dtype, cfg.repeats
    f32 = torch.float32

    def full(shape, value, dtype=f32):
        return torch.full((R, batch) + shape, value, dtype=dtype,
                          device=device)

    def zeros(shape, dtype=dt):
        return full(shape, 0.0, dtype)

    kv = (cache_len, cfg.n_kv_heads, cfg.head_dim)
    H = cfg.n_ssm_heads
    cache: Cache = {}
    for name, _, kind in _block_names(cfg):
        if kind in (ATTN, SWA, SHARED_ATTN):
            cache[name] = {"k": zeros(kv), "v": zeros(kv)}
        elif kind == MAMBA2:
            cache[name] = {
                "state": zeros((H, cfg.d_inner // H, cfg.ssm_state),
                               torch.float32),
                "conv": zeros((cfg.ssm_conv - 1,
                               cfg.d_inner + 2 * cfg.ssm_state))}
        elif kind == MLSTM:
            Hm = cfg.n_heads
            dh = int(cfg.mlstm_proj_factor * cfg.d_model) // Hm
            cache[name] = {"C": zeros((Hm, dh, dh), f32),
                           "n": zeros((Hm, dh), f32),
                           "m": full((Hm,), L.NEG)}
        elif kind == SLSTM:
            d = (cfg.d_model,)
            cache[name] = {"c": zeros(d, f32), "n": full(d, 1.0),
                           "h": zeros(d, f32), "m": zeros(d, f32)}
    return cache


def pad_cache(cfg: ModelConfig, cache: Cache, target_len: int) -> Cache:
    """A prefill cache grown to a fixed decode length, as the reference's
    ``pad_cache``: every attention entry's k and v zero-padded along time
    to ``target_len`` (new tensors); recurrent states pass through."""
    out: Cache = {}
    for name, _, kind in _block_names(cfg):
        if name not in cache:
            continue
        c = cache[name]
        if kind in (ATTN, SWA, SHARED_ATTN):
            out[name] = {n: torch.nn.functional.pad(
                t, (0, 0, 0, 0, 0, max(target_len - t.shape[2], 0)))
                for n, t in c.items()}
        else:
            out[name] = c
    return out


def _fill_normal(p: torch.Tensor, gen: torch.Generator, std: float) -> None:
    """``p`` <- standard normal × ``std``, drawn in fp32 and cast once, as
    the reference's ``_dense_init`` does (one tensor staged at a time)."""
    z = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=p.device)
    p.copy_(z.mul_(std))


# Leaves drawn as constants, and normal leaves whose scale is not
# 1/sqrt(fan_in): the reference's norm_init, mamba2_init and init.  A
# block's own ``CONSTANTS`` (the xLSTM gate biases) take precedence, and
# its ``init_fan_in`` names leaves whose fan-in is not ``shape[0]``.
_CONSTANT = {"scale": 1.0, "bias": 0.0, "dt_bias": 0.0, "A_log": 0.0,
             "conv_b": 0.0, "D": 1.0, "gn": 1.0}
_STD = {"embed": 0.02, "conv_w": 0.1}


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """A model with random weights from a ``torch.Generator`` seeded with
    ``seed``, drawn tensor by tensor straight into ``cfg.dtype``:
    embedding ``N(0, 0.02²)``, projections ``N(0, 1/fan_in)``, norms at
    scale 1 and bias 0; in a Mamba2 block ``dt_bias``, ``A_log`` and
    ``conv_b`` 0, ``D`` and ``gn`` 1, ``conv_w`` ``N(0, 0.1²)``; in an
    mLSTM block ``bi`` 0 and ``bf`` 3, in an sLSTM block ``bf`` 1, the
    other gate biases 0 and the recurrent ``r*`` at fan-in dh; in a MoE
    block the router at fan-in d, the expert ``wg``/``wu`` at fan-in d and
    ``wd`` at fan-in ``moe_d_ff``.  (The JAX
    package draws the same distributions from ``jax.random``, so the
    numbers differ.)"""
    model = Model(cfg, device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    for module in model.modules():
        consts = {**_CONSTANT, **getattr(module, "CONSTANTS", {})}
        fan_in = getattr(module, "init_fan_in", {})
        for leaf, p in module.named_parameters(recurse=False):
            if leaf in consts:
                p.fill_(consts[leaf])
            else:
                fan = fan_in.get(leaf, p.shape[0])
                _fill_normal(p, gen, _STD.get(
                    leaf, 1.0 / math.sqrt(max(fan, 1))))
    return model


@torch.no_grad()
def params_from_reference(cfg: ModelConfig, np_params: Mapping[str, Any], *,
                          device=None) -> Model:
    """A model holding the JAX package's parameters.

    ``np_params`` is the reference's tree (``repro.models.model.init``)
    with numpy leaves (bf16 leaves converted to float32 first: numpy has no
    bfloat16) or tensor leaves (a restored checkpoint's).
    ``params["layers"]`` has a leading ``repeats`` axis, which is unstacked
    into the units (its ``shared_attn`` entries are empty and skipped);
    ``params["shared"]`` has none and goes to the one shared block.  Each
    leaf is cast to the parameter's dtype.
    """
    model = Model(cfg, device)

    def put(p: torch.Tensor, arr) -> None:
        if not isinstance(arr, torch.Tensor):
            arr = torch.tensor(np.asarray(arr))
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"reference leaf of shape {tuple(arr.shape)} "
                             f"for a parameter of shape {tuple(p.shape)}")
        p.copy_(arr.to(p.dtype))

    def put_tree(module: nn.Module, tree: Mapping[str, Any]) -> None:
        for k, v in tree.items():
            if isinstance(v, Mapping):
                put_tree(getattr(module, k), v)
            else:
                put(getattr(module, k), v)

    if "embed" in np_params:
        put(model.embed, np_params["embed"])
    if "shared" in np_params:
        put_tree(model.shared, np_params["shared"])
    if "lm_head" in np_params:
        put(model.lm_head, np_params["lm_head"])
    for k, arr in np_params["final_norm"].items():
        put(getattr(model.final_norm, k), arr)
    for r, unit in enumerate(model.units):
        for block_name, leaves in np_params["layers"].items():
            if not leaves:
                continue            # a shared_attn entry: no weights
            block = unit.blocks[block_name]
            for k, arr in leaves.items():
                put(getattr(block, k), arr[r] if isinstance(
                    arr, torch.Tensor) else np.asarray(arr)[r])
    return model


def _module_tree(module: nn.Module) -> Dict[str, Any]:
    tree: Dict[str, Any] = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        tree[name] = _module_tree(child)
    return tree


def _zip_trees(trees):
    """Trees of one structure -> one tree with a tuple at each leaf."""
    if isinstance(trees[0], Mapping):
        return {k: _zip_trees([t[k] for t in trees]) for k in trees[0]}
    return tuple(trees)


def param_tree(model: Model) -> Dict[str, Any]:
    """The model's parameters in the reference's tree (``embed``,
    ``final_norm``, ``layers``, ``lm_head``, ``shared``, as the model has
    them), with the ``layers`` leaves unstacked: ``tree["layers"][block]
    [leaf]`` is a tuple of the ``cfg.repeats`` units' parameters, and a
    ``shared_attn`` entry an empty dict.  The leaves are the parameters
    themselves, so the tree is what the optimizer updates in place."""
    tree: Dict[str, Any] = {}
    if hasattr(model, "embed"):
        tree["embed"] = model.embed
    tree["final_norm"] = _module_tree(model.final_norm)
    if hasattr(model, "lm_head"):
        tree["lm_head"] = model.lm_head
    if model.shared is not None:
        tree["shared"] = _module_tree(model.shared)
    layers: Dict[str, Any] = {}
    for name, norm_name, kind in _block_names(model.cfg):
        if kind == SHARED_ATTN:
            layers[name] = {}
            continue
        for bn in (norm_name, name):
            layers[bn] = _zip_trees([_module_tree(u.blocks[bn])
                                     for u in model.units])
    tree["layers"] = layers
    return tree


def to_reference_layout(tree):
    """A tree shaped like :func:`param_tree`'s (parameters, or optimizer
    state beside them) in the reference's layout: every per-unit tuple
    stacked along a new leading ``repeats`` axis, every tensor detached.
    The stacked leaves are copies."""
    if isinstance(tree, Mapping):
        return {k: to_reference_layout(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return torch.stack([t.detach() for t in tree])
    return tree.detach()


def params_to_reference(model: Model) -> Dict[str, Any]:
    """The model's parameters as the reference's params tree (tensors, in
    the parameters' dtypes): the inverse of :func:`params_from_reference`,
    with the units re-stacked into ``params["layers"]``."""
    return to_reference_layout(param_tree(model))


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def active_param_count(model: Model) -> int:
    """Parameters touched per token (``repro/models/model.py``
    ``active_param_count``): every MoE block's expert weights scaled by
    top_k / n_experts, its router and everything else counted whole."""
    cfg = model.cfg
    total = 0
    for name, p in model.named_parameters():
        size = p.numel()
        if "_moe" in name and not name.endswith("router"):
            size = size * cfg.top_k // max(cfg.n_experts, 1)
        total += size
    return total
