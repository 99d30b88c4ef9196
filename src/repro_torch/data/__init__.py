"""Data pipeline: deterministic synthetic token stream + async prefetch.

The port of ``repro/data/__init__.py``.

* :class:`SyntheticLMData` — batches are a pure function of (seed, step),
  drawn with numpy exactly as the reference draws them, so both packages
  see bitwise the same stream and a restarted job replays it from the
  checkpointed step.

* :class:`Prefetcher` — double-buffered prefetch built on the paper's
  machinery: batch k+1 is produced by a task on the host
  :class:`~repro_torch.core.TaskRuntime` while step k runs on the device;
  the training loop *waits task-aware* (``tac.wait``) on the prefetch
  handle instead of blocking a worker.  :func:`to_device` is the
  host-to-device put: pinned host memory, a ``non_blocking`` copy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core import TaskRuntime, tac
from ..models.config import ModelConfig

__all__ = ["SyntheticLMData", "Prefetcher", "to_device"]


class SyntheticLMData:
    """Deterministic synthetic LM batches (token ids + next-token labels)."""

    def __init__(self, cfg: ModelConfig, *, batch: int, seq: int,
                 seed: int = 0) -> None:
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        cfg = self.cfg
        out: Dict[str, np.ndarray] = {}
        if cfg.frontend == "audio":
            out["embeds"] = rng.standard_normal(
                (self.batch, self.seq, cfg.d_model), dtype=np.float32
            ).astype(np.dtype(cfg.dtype) if cfg.dtype != "bfloat16"
                     else np.float32)
            out["labels"] = rng.integers(
                0, cfg.vocab, (self.batch, self.seq), dtype=np.int32)
            return out
        # token stream with a learnable structure (repeat-shift pattern) so
        # small models can actually reduce loss on it
        toks = rng.integers(0, cfg.vocab, (self.batch, self.seq + 1),
                            dtype=np.int32)
        toks[:, 2::2] = toks[:, 1:-1:2]  # every even position repeats
        out["tokens"] = toks[:, :-1]
        out["labels"] = toks[:, 1:]
        if cfg.frontend == "vlm":
            out["patch_embeds"] = rng.standard_normal(
                (self.batch, cfg.n_patches, cfg.d_model),
                dtype=np.float32)
        return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """Each array as a tensor on ``device``.  For a CUDA device the array is
    staged in pinned host memory and copied ``non_blocking`` on the current
    stream, so the copy overlaps whatever runs before it there; the pinned
    block is not reused before the copy has read it (PyTorch's host
    allocator records the copy)."""
    device = torch.device(device)
    out = {}
    for k, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


class Prefetcher:
    """Double-buffered prefetch driven by the host task runtime."""

    def __init__(self, data: SyntheticLMData, *, start_step: int = 0,
                 device_put_fn=None, depth: int = 2) -> None:
        self.data = data
        self.device_put_fn = device_put_fn or (lambda x: x)
        self.runtime = TaskRuntime(num_workers=max(1, depth))
        self.runtime.start()
        self._pending: Dict[int, tac.EventHandle] = {}
        self.depth = depth
        for s in range(start_step, start_step + depth):
            self._issue(s)

    def _issue(self, step: int) -> None:
        handle = tac.EventHandle()

        def produce():
            batch = self.data.batch_at(step)
            handle.complete(self.device_put_fn(batch))

        self.runtime.submit(produce, name=f"prefetch@{step}")
        self._pending[step] = handle

    def get(self, step: int) -> Any:
        """Batch for ``step`` (task-aware wait), prefetching step+depth."""
        if step not in self._pending:
            self._issue(step)
        handle = self._pending.pop(step)
        self._issue(step + self.depth)
        return tac.wait(handle)

    def close(self) -> None:
        self.runtime.close()
