"""Composable block-pattern language model — the port of
``repro/models/model.py`` for the block kinds ported so far (attention,
sliding-window attention, MLP).

A model is ``cfg.pattern`` (a repeating unit of layers, each a tuple of
blocks) applied ``cfg.repeats`` times, pre-norm with residual connections.
The JAX package scans stacked parameters; here each repeat is one
``nn.Module`` in a ``ModuleList`` and the loop is a Python loop.  Block and
norm names inside a unit are the reference's (``L{li}_{bi}_{kind}``,
``L{li}_{bi}_norm``), so :func:`params_from_reference` maps the JAX tree
one to one.

Three entry modes (:func:`apply`):

* ``train``   — full sequence, logits for every position;
* ``prefill`` — full sequence, k/v written into the cache, logits for the
  last position only (what ``runtime/steps.py``'s prefill step returns);
* ``decode``  — one token against the fixed-size cache at ``cache_index``.

The KV cache (:func:`init_cache`) is the reference's layout: per attention
block, k and v of shape (repeats, B, T, Hkv, dh).  Unlike the JAX package,
which returns new arrays, prefill and decode write it in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.mesh import resolve_device
from . import layers as L
from .config import ModelConfig, ATTN, SWA, MLP

Cache = Dict[str, Dict[str, torch.Tensor]]
MODES = ("train", "prefill", "decode")


def _block_names(cfg: ModelConfig):
    """(block name, norm name, kind) of every block of the unit, in order."""
    return [(f"L{li}_{bi}_{kind}", f"L{li}_{bi}_norm", kind)
            for li, layer in enumerate(cfg.pattern)
            for bi, kind in enumerate(layer)]


class Unit(nn.Module):
    """One repeat of ``cfg.pattern``: a norm and a block per entry."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleDict()
        for name, norm_name, kind in _block_names(cfg):
            self.blocks[norm_name] = L.Norm(cfg, device)
            self.blocks[name] = (L.Attention(cfg, device)
                                 if kind in (ATTN, SWA)
                                 else L.MLPBlock(cfg, device))

    def forward(self, x: torch.Tensor, *, angles: torch.Tensor, mode: str,
                cache: Optional[Dict[str, Dict[str, torch.Tensor]]],
                cache_index: Optional[int],
                impl: Optional[str]) -> torch.Tensor:
        cfg = self.cfg
        for name, norm_name, kind in _block_names(cfg):
            xin = self.blocks[norm_name](x)
            if kind == MLP:
                h = self.blocks[name](xin)
            else:
                win = cfg.sliding_window if kind == SWA else None
                c = cache.get(name) if cache is not None else None
                h = self.blocks[name](
                    xin, angles=angles, window=win, cache=c,
                    cache_index=cache_index if mode == "decode" else None,
                    impl=impl)
            x = x + h
        return x


class Model(nn.Module):
    """Embedding, ``cfg.repeats`` units, final norm and (untied or audio
    frontend) an LM head ``(d_model, vocab)``.  Weights are allocated
    uninitialised: use :func:`init` or :func:`params_from_reference`."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        L.check_supported(cfg)
        self.cfg = cfg
        device = resolve_device(device)
        dt = cfg.activation_dtype
        if cfg.frontend != "audio":
            self.embed = L._param((cfg.vocab, cfg.d_model), dt, device)
        self.units = nn.ModuleList(Unit(cfg, device)
                                   for _ in range(cfg.repeats))
        self.final_norm = L.Norm(cfg, device)
        if not cfg.tie_embeddings or cfg.frontend == "audio":
            self.lm_head = L._param((cfg.d_model, cfg.vocab), dt, device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        head = getattr(self, "lm_head", None)
        logits = x @ head if head is not None else x @ self.embed.T
        if self.cfg.logit_softcap > 0:
            cap = self.cfg.logit_softcap
            logits = torch.tanh(logits / cap) * cap
        return logits

    def forward(self, batch: Mapping[str, torch.Tensor], *,
                mode: str = "train", cache: Optional[Cache] = None,
                cache_index: Optional[int] = None,
                attn_impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg = self.cfg
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if mode == "decode" and (cache is None or cache_index is None):
            raise ValueError("decode needs a cache and a cache_index")
        if cfg.frontend == "audio":
            x = batch["embeds"].to(cfg.activation_dtype)
            B, S = x.shape[:2]
        else:
            tokens = batch["tokens"]
            B, S = tokens.shape
            x = self.embed[tokens]
            if cfg.frontend == "vlm" and mode != "decode" \
                    and "patch_embeds" in batch:
                pe = batch["patch_embeds"].to(x.dtype)
                x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        if mode == "decode":
            positions = torch.full((B, S), int(cache_index), device=x.device)
        else:
            positions = torch.arange(S, device=x.device).expand(B, S)
        angles = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        if mode == "prefill" and cache is None:
            cache = init_cache(cfg, B, S, device=x.device)
        for r, unit in enumerate(self.units):
            unit_cache = None if mode == "train" else {
                name: {n: t[r] for n, t in c.items()}
                for name, c in cache.items()}
            x = unit(x, angles=angles, mode=mode, cache=unit_cache,
                     cache_index=cache_index, impl=attn_impl)
        if mode == "prefill":
            x = x[:, -1:]
        return self._head(x), (None if mode == "train" else cache)


def apply(model: Model, batch: Mapping[str, torch.Tensor], *,
          mode: str = "train", cache: Optional[Cache] = None,
          cache_index: Optional[int] = None,
          attn_impl: Optional[str] = None
          ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Forward pass; returns ``(logits, cache)``.  ``attn_impl`` is handed
    to ``ops.flash_attention`` (None or "cuda": the kernel on the card;
    "ref": its plain version).  Prefill without a cache allocates one of
    length S; with one, it fills positions [0, S) of it."""
    return model(batch, mode=mode, cache=cache, cache_index=cache_index,
                 attn_impl=attn_impl)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device=None) -> Cache:
    """A zeroed fixed-size KV cache for every attention block: k and v of
    shape (repeats, batch, cache_len, Hkv, dh) in ``cfg.dtype``."""
    device = resolve_device(device)
    shape = (cfg.repeats, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {name: {n: torch.zeros(shape, dtype=cfg.activation_dtype,
                                  device=device) for n in ("k", "v")}
            for name, _, kind in _block_names(cfg) if kind in (ATTN, SWA)}


def _fill_normal(p: torch.Tensor, gen: torch.Generator, std: float) -> None:
    """``p`` <- standard normal × ``std``, drawn in fp32 and cast once, as
    the reference's ``_dense_init`` does (one tensor staged at a time)."""
    z = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=p.device)
    p.copy_(z.mul_(std))


@torch.no_grad()
def init(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """A model with random weights from a ``torch.Generator`` seeded with
    ``seed``, drawn tensor by tensor straight into ``cfg.dtype``:
    embedding ``N(0, 0.02²)``, projections ``N(0, 1/fan_in)``, norms at
    scale 1 and bias 0.  (The JAX package draws the same distributions from
    ``jax.random``, so the numbers differ.)"""
    model = Model(cfg, device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        elif leaf == "embed":
            _fill_normal(p, gen, 0.02)
        else:
            _fill_normal(p, gen, 1.0 / math.sqrt(max(p.shape[0], 1)))
    return model


@torch.no_grad()
def params_from_reference(cfg: ModelConfig, np_params: Mapping[str, Any], *,
                          device=None) -> Model:
    """A model holding the JAX package's parameters.

    ``np_params`` is the reference's tree (``repro.models.model.init``)
    with numpy leaves (bf16 leaves converted to float32 first: numpy has no
    bfloat16).  ``params["layers"]`` has a leading ``repeats`` axis, which
    is unstacked into the units; each leaf is cast to the parameter's dtype.
    """
    model = Model(cfg, device)

    def put(p: torch.Tensor, arr) -> None:
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"reference leaf of shape {arr.shape} for a "
                             f"parameter of shape {tuple(p.shape)}")
        p.copy_(torch.tensor(arr).to(p.dtype))

    if "embed" in np_params:
        put(model.embed, np_params["embed"])
    if "lm_head" in np_params:
        put(model.lm_head, np_params["lm_head"])
    for k, arr in np_params["final_norm"].items():
        put(getattr(model.final_norm, k), arr)
    for r, unit in enumerate(model.units):
        for block_name, leaves in np_params["layers"].items():
            block = unit.blocks[block_name]
            for k, arr in leaves.items():
                put(getattr(block, k), np.asarray(arr)[r])
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
