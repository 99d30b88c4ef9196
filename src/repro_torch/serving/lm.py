"""LM adapter: the real model path behind the serving engine — the port of
``repro/serving/lm.py``.

Each request runs batch-1 greedy decoding with its own fixed-size
``(prompt_len + gen_len)`` cache — k/v of every attention block, the SSD
state and conv tail of every Mamba2 block, the (C, n, m) of every mLSTM
block and the (c, n, h, m) of every sLSTM block — which prefill fills in
place and each decode step extends in place.  (MoE blocks keep no
state.)  One card holds the model whole, so there
is no mesh and no sharding policy.

Device work stays un-synchronised, and the adapter hands the engine the
completion handle itself.  On the card every request's work — its cache,
its activations, its kernels — goes on a CUDA stream of its own, and the
engine's ``tac.as_handle(tok)`` would record its event on the *engine
thread's* current stream, which covers none of that work.  So each step
copies its token into pinned host memory with ``non_blocking=True`` on
the request's stream and returns ``tac.ArrayHandle(host_tok,
inputs=[dev_tok])`` (the ``tac.transfer`` pattern) recorded inside the
stream's context; ``as_handle`` passes it through unchanged.  The event
leg binds it with ``tac.iwait``; the blocking leg waits on it and hands
:meth:`LMAdapter.detok` the host token.

``Request.prompt`` is an integer seed; the prompt tokens come from
``prompt_tokens(req)``, by default ``numpy.random.default_rng(seed)``,
which keeps the two completion legs (and re-admissions after eviction)
bit-identical.  (The JAX package draws them from ``jax.random`` under
that seed; tests feed those tokens in.)
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..core import tac
from ..core.mesh import resolve_device
from ..models import model as model_lib
from ..models.config import ModelConfig
from .request import Request

__all__ = ["LMAdapter"]


class LMAdapter:
    """Batch-1 greedy-decode adapter over a :class:`repro_torch.models
    .model.Model` (``params``) on ``device`` (the CUDA device unless
    named).  ``attn_impl`` goes to the prefill attention, ``ssd_impl`` to
    the prefill SSD scan, ``mlstm_impl`` to the prefill mLSTM scan and
    ``moe_impl`` to the MoE expert products of prefill and decode (None:
    the Hopper kernel on the card; "ref": its plain version)."""

    def __init__(self, cfg: ModelConfig, params: model_lib.Model, *,
                 prompt_len: int, gen_len: int, device=None,
                 attn_impl: Optional[str] = None,
                 ssd_impl: Optional[str] = None,
                 mlstm_impl: Optional[str] = None,
                 moe_impl: Optional[str] = None,
                 prompt_tokens: Optional[Callable[[Request],
                                                  torch.Tensor]] = None
                 ) -> None:
        self.cfg = cfg
        want = resolve_device(device)
        if params.device.type != want.type or want.index not in (
                None, params.device.index):
            raise ValueError(f"LMAdapter: the model is on {params.device}, "
                             f"the adapter on {want}")
        self.device = params.device
        self.model = params
        self.prompt_len = prompt_len
        self.total_len = prompt_len + gen_len
        self.attn_impl = attn_impl
        self.ssd_impl = ssd_impl
        self.mlstm_impl = mlstm_impl
        self.moe_impl = moe_impl
        self._prompt_tokens = prompt_tokens
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)     # the weights are ready

    def prompt_tokens(self, req: Request) -> torch.Tensor:
        """The prompt of ``req``: from ``prompt_tokens=`` when given, else
        seeded by ``req.prompt``.  (A method: one of the adapter's bound
        methods stored on the adapter would be a reference cycle, alive
        until the cyclic collector runs.)"""
        if self._prompt_tokens is not None:
            return self._prompt_tokens(req)
        rng = np.random.default_rng(int(req.prompt))
        return torch.from_numpy(
            rng.integers(0, self.cfg.vocab, (1, self.prompt_len)))

    def _on(self, stream: Optional[torch.cuda.Stream]):
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    def _token(self, logits: torch.Tensor) -> Tuple[tac.ArrayHandle,
                                                    torch.Tensor]:
        """The greedy token of the last position, on the device, and its
        completion handle over a pinned host copy (on the current stream,
        which is the request's)."""
        tok = torch.argmax(logits[:, -1], dim=-1)
        if tok.is_cuda:
            host = torch.empty(tok.shape, dtype=tok.dtype, pin_memory=True)
            host.copy_(tok, non_blocking=True)
            return tac.ArrayHandle(host, inputs=[tok]), tok
        return tac.ArrayHandle(tok), tok

    # -- the adapter protocol -----------------------------------------------
    def warmup(self) -> None:
        """One prefill and one decode step outside any timed region (on the
        card: the kernel build and the allocator's first blocks)."""
        req = Request(rid=-1, prompt=0, gen_len=2)
        _, state = self.prefill(req)
        handle, _ = self.decode(req, state, 1)
        handle.wait()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, req: Request) -> Tuple[Any, Any]:
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        with self._on(stream), torch.inference_mode():
            tokens = self.prompt_tokens(req).to(self.device)
            cache = model_lib.init_cache(self.cfg, 1, self.total_len,
                                         device=self.device)
            logits, cache, _ = model_lib.apply(
                self.model, {"tokens": tokens}, mode="prefill", cache=cache,
                attn_impl=self.attn_impl, ssd_impl=self.ssd_impl,
                mlstm_impl=self.mlstm_impl, moe_impl=self.moe_impl)
            handle, tok = self._token(logits)
        return handle, (stream, cache, tok)

    def decode(self, req: Request, state: Any,
               step: int) -> Tuple[Any, Any]:
        stream, cache, prev = state
        with self._on(stream), torch.inference_mode():
            logits, cache, _ = model_lib.apply(
                self.model, {"tokens": prev[:, None]}, mode="decode",
                cache=cache, cache_index=self.prompt_len + step - 1,
                moe_impl=self.moe_impl)
            handle, tok = self._token(logits)
        return handle, (stream, cache, tok)

    def detok(self, req: Request, step: int, tok: Any) -> int:
        """The token id: from the completed handle (event leg) or the host
        tensor it produced (blocking leg)."""
        if isinstance(tok, tac.AsyncHandle):
            tok = tok.result
        return int(tok.reshape(-1)[0])
