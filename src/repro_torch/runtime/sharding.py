"""Sharding policy — the part of ``repro/runtime/sharding.py`` that the
train steps take.

:class:`ShardingPolicy` keeps the reference's fields and defaults.  On the
port's logical mesh a step holds whole replicas: FSDP, tensor and sequence
parallelism (the reference's rule table, ``param_shardings`` and
``Constrainer``) are not ported yet, so :func:`check_policy` refuses them
on a mesh of more than one rank; on one rank they place nothing and are
accepted, as the reference's rules drop every axis of size 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ShardingPolicy", "check_policy"]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Knobs for the distribution strategy (the reference's fields)."""
    fsdp: bool = True              # shard params over the data axes
    tp: bool = True                # tensor parallelism over 'model'
    sp: bool = True                # sequence-shard residuals over 'model'
    ep: bool = True                # experts over 'model'
    remat: Optional[str] = "dots"  # None | "full" | "dots"
    grad_sync: str = "auto"        # auto | fused | bucketed | sentinel
    shard_embed_vocab: bool = True
    microbatches: int = 1          # gradient accumulation (activation mem ÷M)
    fsdp_axes: str = "data"
    fsdp_experts: bool = True
    gather_expert_weights: bool = False


def check_policy(mesh, policy: ShardingPolicy) -> None:
    """Refuse a placement the logical mesh cannot make: FSDP, TP or SP on
    a mesh of more than one rank."""
    if mesh.size > 1:
        asked = [name for name in ("fsdp", "tp", "sp")
                 if getattr(policy, name)]
        if asked:
            raise NotImplementedError(
                f"sharding {', '.join(asked)} over a {mesh.size}-rank "
                f"logical mesh is not ported; pass fsdp=False, tp=False, "
                f"sp=False (manual data parallelism holds whole replicas)")
    if policy.microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got "
                         f"{policy.microbatches}")
