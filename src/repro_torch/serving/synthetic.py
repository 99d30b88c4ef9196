"""Synthetic model adapter: async device queue, deterministic tokens — the
port of ``repro/serving/synthetic.py``.

The test stand-in for the LM adapter
(:class:`repro_torch.serving.lm.LMAdapter`): device micro-steps run on a
**device queue** — a thread pool standing in for the accelerator's
streams — and return :class:`concurrent.futures.Future`\\ s, so the
engine's handles are push-capable
(:class:`repro_torch.core.tac.FutureHandle` → the continuation engine is
notified at completion, zero polls) and the device latency is genuinely
asynchronous: it costs wall-clock but no CPU, exactly like a kernel
executing on an accelerator while the host runs tasks.

That asymmetry is what separates the two completion legs: the
blocking-sentinel leg parks a *worker* inside every device wait, so at
most ``num_workers`` requests make progress; the event-bound leg frees
the worker at dispatch (``tac.iwait``) and every admitted request's
chain advances at device latency.  Host detokenisation is sha256 work
(GIL-releasing, cache-resident).

Tokens are a pure function of ``(prompt seed, step)`` — the two legs
must emit bit-identical streams, and an evicted request re-generates
the same tokens after re-admission.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import time
from typing import Any, Tuple

import numpy as np
import torch

from ..core.mesh import resolve_device
from .request import Request

__all__ = ["SyntheticAdapter", "token_at"]


def token_at(seed: int, step: int) -> int:
    """The deterministic token stream: pure in (seed, step)."""
    return (seed + 31 * step + 7) % 997


class SyntheticAdapter:
    """Deterministic adapter with tunable device/host cost.

    ``dev_ms`` is the device latency of one micro-step (slept on the
    device-queue thread — off-CPU, like an accelerator); ``dim`` sizes
    the real computation dispatched with it on ``device`` (the CUDA
    device unless named); ``host_rounds`` sizes the sha256 host work of
    one detokenisation; ``streams`` is the device queue's concurrency
    (how many micro-steps the "device" overlaps).  ``request.prompt`` is
    the integer seed.
    """

    def __init__(self, *, dev_ms: float = 4.0, host_rounds: int = 8,
                 dim: int = 64, streams: int = 16, device=None) -> None:
        self.dev_ms = dev_ms
        self.host_rounds = host_rounds
        self.dim = dim
        self.device = resolve_device(device)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=streams, thread_name_prefix="synth-device")
        w = np.linalg.qr(np.random.default_rng(0)
                         .standard_normal((dim, dim)))[0]
        self._w = torch.as_tensor(w, dtype=torch.float32, device=self.device)
        self._host_buf = bytes(range(256)) * 256    # 64 KiB, L2-resident

    def _step(self, vec: torch.Tensor, seed: int,
              step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        vec = torch.tanh(vec @ self._w)
        s = torch.tensor([seed, step], dtype=torch.int64, device=self.device)
        tok = (s[0] + 31 * s[1] + 7) % 997
        return tok.to(torch.int32), vec

    def _device(self, seed: int, vec: torch.Tensor,
                step: int) -> Tuple[np.ndarray, torch.Tensor]:
        """One micro-step on the device queue: latency + computation."""
        time.sleep(self.dev_ms * 1e-3)      # accelerator time, off-CPU
        tok, vec = self._step(vec, seed, step)
        return tok.cpu().numpy(), vec       # future done == value ready

    # -- the adapter protocol -----------------------------------------------
    def warmup(self) -> None:
        """Run the step once (outside any timed region)."""
        vec = torch.zeros((self.dim,), dtype=torch.float32,
                          device=self.device)
        self._step(vec, 0, 0)[0].cpu()

    def prefill(self, req: Request) -> Tuple[Any, Any]:
        """Dispatch the prompt pass; returns (first-token future, state)."""
        seed = int(req.prompt)
        vec = torch.full((self.dim,), (seed % 13) / 13.0,
                         dtype=torch.float32, device=self.device)
        fut = self._pool.submit(self._device, seed, vec, 0)
        return fut, (seed, fut)

    def decode(self, req: Request, state: Any,
               step: int) -> Tuple[Any, Any]:
        """Dispatch one decode micro-step; returns (token future, state).

        The previous step's future is resolved here — by chain ordering
        it is already complete (the event leg released the chain at
        device completion; the blocking leg waited on it)."""
        seed, prev = state
        _, vec = prev.result()
        fut = self._pool.submit(self._device, seed, vec, step)
        return fut, (seed, fut)

    def detok(self, req: Request, step: int, tok: Any) -> int:
        """Host detokenisation: sha256 host work + the token value."""
        if hasattr(tok, "result"):          # event leg: completed future
            tok = tok.result()
        if isinstance(tok, tuple):          # (token, state-vector) pair
            tok = tok[0]
        h = hashlib.sha256()
        for _ in range(self.host_rounds):
            h.update(self._host_buf)
        assert h.digest()
        return int(np.asarray(tok))

    def close(self) -> None:
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "SyntheticAdapter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
