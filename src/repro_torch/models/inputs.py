"""Model input construction — the port of ``repro/models/inputs.py``'s
``make_batch``.

Per the assignment, the ``[audio]``/``[vlm]`` frontends are stubs: the
batch carries precomputed frame/patch embeddings.  The numbers come from a
``torch.Generator``, so they differ from ``jax.random``'s
for the same seed; a test that needs the reference's inputs feeds them in.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.mesh import resolve_device
from .config import ModelConfig


def make_batch(cfg: ModelConfig, *, batch: int, seq: int,
               kind: str = "train", seed: int = 0,
               device=None) -> Dict[str, torch.Tensor]:
    """A concrete random batch from a ``torch.Generator`` seeded with
    ``seed``: ``tokens`` (int64) or audio ``embeds``, vlm ``patch_embeds``
    outside decode, and ``labels`` for training."""
    device = resolve_device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    dt = cfg.activation_dtype

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device).to(dt)

    def ints(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=generator,
                             device=device)

    if cfg.frontend == "audio":
        out = {"embeds": normal(batch, seq, cfg.d_model)}
    else:
        out = {"tokens": ints(batch, seq)}
        if cfg.frontend == "vlm" and kind != "decode":
            out["patch_embeds"] = normal(batch, cfg.n_patches, cfg.d_model)
    if kind == "train":
        out["labels"] = ints(batch, seq)
    return out
