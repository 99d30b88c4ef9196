"""Multi-pod dry run: place and step every (arch × shape × mesh) cell on
the ``meta`` device — the port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell for the single-pod (16×16)
and multi-pod (2×16×16) production meshes and reads XLA's analyses.  The
port has no compiler: it builds the cell's step with ``runtime.steps``
(``build_train_step``, ``build_prefill_step`` or ``build_decode_step``)
on :func:`~repro_torch.launch.mesh.make_production_mesh`, places the
abstract arguments by the rule table (``runtime.sharding``), and runs one
step on ``meta`` tensors, every logical rank's work as the card would run
it, under :class:`~repro_torch.analysis.op_cost.OpCounter`.  Per cell it
records the reference's keys:

* ``memory`` — bytes per device, a stated model: ``argument_bytes`` the
  rank's placed arguments (state or parameters, cache) plus its block of
  the batch, the largest rank's; ``output_bytes`` the outputs counted the
  same way (a tensor not placed over the ranks counted on every rank);
  ``alias_bytes`` the outputs that are arguments updated in place;
  ``temp_bytes`` the peak of the storages the rank's operations create
  during the step, outputs included while they live (``OpCounter``'s
  tracker); ``peak_device_bytes`` = argument + temp, as in the reference.
  No allocator, caching or fragmentation is modelled.
* ``cost`` — the per-device FLOPs and bytes of the rank with the most
  FLOPs (``op_cost``'s counts: the plain versions' operations, as
  ``"flops_of": "plain"`` says), with each rank's share of what no rank
  issues added.  ``xla_flops`` and ``xla_bytes`` are null: there is no
  XLA.  ``spread`` gives [min, max] over the ranks.
* ``collectives`` — counts, operand bytes and ring-model wire bytes per
  kind from the mesh's counters (``core.mesh``), of the rank with the
  most wire bytes; ``fsdp_bytes`` the part of the operand bytes that
  gathers weights and reduces their gradients (FSDP).

``lower_s`` is the seconds to build the step and place the arguments,
``compile_s`` the seconds of the counted ``meta`` step, ``analyze_s`` the
seconds to reduce the counts to the record.  The reference's
``parse_collectives`` reads HLO text, and its ``--save-hlo`` writes it:
neither has a counterpart here.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
  python -m repro_torch.launch.dryrun --all --multi-pod
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from .. import configs, optim
from ..analysis.op_cost import (COLLECTIVE_KINDS, KIND_OF, Cost,
                                OpCounter, collective_cost)
from ..models import model
from ..models.config import (ModelConfig, ShapeConfig, applicable_shapes,
                             shape_by_name)
from ..core.mesh import nbytes
from ..runtime import steps
from ..runtime.sharding import (Placed, ShardingPolicy, batch_shardings,
                                cache_shardings, map_tree, place,
                                placed_bytes)
from . import mesh as meshlib

__all__ = ["TRAIN_MICROBATCHES", "default_policy_for", "batch_spec",
           "Cell", "lower_cell", "run_cell", "iter_cells", "main"]

# Per-arch gradient-accumulation defaults for the train_4k cells, the
# reference's table (chosen there so the activation live-set fits 16 GiB
# of v5e HBM; tokens a step unchanged).
TRAIN_MICROBATCHES = {
    "mixtral-8x22b": 16,
    "deepseek-coder-33b": 8,
    "phi3-medium-14b": 4,
    "starcoder2-15b": 4,
    "zamba2-2.7b": 4,
    "xlstm-350m": 4,
    "olmoe-1b-7b": 2,
    "hubert-xlarge": 2,
}


def _policy_from_args(args) -> ShardingPolicy:
    return ShardingPolicy(
        fsdp=not args.no_fsdp, tp=not args.no_tp, sp=not args.no_sp,
        ep=not args.no_ep, remat=args.remat,
        shard_embed_vocab=not args.no_vocab_shard,
        microbatches=args.microbatches,
        fsdp_axes="all" if args.fsdp_all else "data",
        fsdp_experts=not args.no_fsdp_experts,
        gather_expert_weights=args.gather_expert_weights)


def default_policy_for(arch: str, shape_name: str,
                       base: ShardingPolicy) -> ShardingPolicy:
    if shape_by_name(shape_name).kind == "train":
        canonical = configs.get(arch).name   # dashed form
        mb = TRAIN_MICROBATCHES.get(canonical, 1)
        if base.microbatches == 1 and mb > 1:
            return dataclasses.replace(base, microbatches=mb)
    return base


def batch_spec(cfg: ModelConfig, shape: ShapeConfig
               ) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this cell (the
    reference's ``inputs.batch_spec``: int32 tokens and labels)."""
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len

    def sd(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")
    dt = cfg.activation_dtype
    if cfg.frontend == "audio":
        batch = {"embeds": sd((B, S, cfg.d_model), dt)}
    else:
        batch = {"tokens": sd((B, S), torch.int32)}
        if cfg.frontend == "vlm" and shape.kind != "decode":
            batch["patch_embeds"] = sd((B, cfg.n_patches, cfg.d_model), dt)
    if shape.kind == "train":
        batch["labels"] = sd((B, S), torch.int32)
    return batch


@dataclasses.dataclass
class Cell:
    """One built cell: ``run()`` takes the step once; ``args`` are its
    arguments (placed trees, the batch); ``mesh`` the cell's mesh."""
    run: Callable[[], Any]
    args: Tuple[Any, ...]
    batch: Dict[str, torch.Tensor]
    mesh: Any
    policy: ShardingPolicy


def lower_cell(arch: Union[str, ModelConfig],
               shape_name: Union[str, ShapeConfig], mesh,
               policy: ShardingPolicy,
               opt_cfg: Optional[optim.OptimConfig] = None
               ) -> Tuple[Cell, Dict[str, Any]]:
    """Build one (arch, shape, mesh) cell and place its abstract
    arguments.  ``arch`` and ``shape_name`` are names or config objects
    (the tests pass smoke configs).  Returns (cell, meta)."""
    cfg = configs.get(arch) if isinstance(arch, str) else arch
    shape = shape_by_name(shape_name) if isinstance(shape_name, str) \
        else shape_name
    opt_cfg = opt_cfg or optim.OptimConfig()
    batch = batch_spec(cfg, shape)

    if shape.kind == "train":
        step, shardings = steps.build_train_step(cfg, mesh, policy, opt_cfg)
        a_state = steps.abstract_train_state(cfg, opt_cfg)
        if mesh.size > 1:
            state = steps.place_state(a_state, shardings)
        else:
            state = a_state
            state.params.requires_grad_(True)
        args: Tuple[Any, ...] = (state,)
        run = lambda: step(state, batch)  # noqa: E731
    elif shape.kind == "prefill":
        step = steps.build_prefill_step(cfg, mesh, policy)
        params = _params(cfg, mesh, policy)
        args = (params,)
        run = lambda: step(params, batch)  # noqa: E731
    else:
        step, template = steps.build_decode_step(
            cfg, mesh, policy, batch=shape.global_batch,
            cache_len=shape.seq_len)
        params = _params(cfg, mesh, policy)
        cache = place(template, cache_shardings(mesh, template, policy)) \
            if mesh.size > 1 else template
        args = (params, cache)
        index = shape.seq_len - 1
        run = lambda: step(params, cache, batch, index)  # noqa: E731

    net = steps.abstract_params(cfg)
    meta = {
        "arch": arch if isinstance(arch, str) else cfg.name,
        "shape": shape.name,
        "params": model.param_count(net),
        "active_params": model.active_param_count(net),
        "kind": shape.kind,
        "tokens": shape.global_batch * (1 if shape.kind == "decode"
                                        else shape.seq_len),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
    }
    return Cell(run, args, batch, mesh, policy), meta


def _params(cfg, mesh, policy):
    net = steps.abstract_params(cfg)
    if mesh.size == 1:
        return net
    from ..runtime.sharding import param_shardings
    return steps.place_params(net, param_shardings(mesh, net, policy))


# ---------------------------------------------------------------------------
# bytes a rank holds
# ---------------------------------------------------------------------------
def _leaves(tree) -> List[Any]:
    """The placed leaves and tensors of ``tree`` (a model's parameters
    for a model)."""
    out: List[Any] = []

    def add(_, x):
        if isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
        elif isinstance(x, (Placed, torch.Tensor)):
            out.append(x)
    map_tree(add, tree)
    return out


def held_bytes(tree, mesh) -> List[int]:
    """Bytes each rank holds of ``tree``: its blocks of every placed leaf
    (``placed_bytes``), and every tensor not placed over the ranks in
    full."""
    whole = sum(nbytes(x) for x in _leaves(tree)
                if isinstance(x, torch.Tensor))
    return [b + whole for b in placed_bytes(tree, mesh)]


def batch_bytes(mesh, batch, policy) -> List[int]:
    """Bytes of each rank's block of the batch (``batch_shardings``)."""
    shs = batch_shardings(mesh, batch, policy)
    out = [0] * mesh.size
    for k, t in batch.items():
        blk = shs[k].block_shape(tuple(t.shape))
        n = t.element_size()
        for d in blk:
            n *= d
        for r in range(mesh.size):
            out[r] += n
    return out


def _storages(tree) -> set:
    keys = set()
    for leaf in _leaves(tree):
        for t in (leaf.blocks if isinstance(leaf, Placed) else [leaf]):
            keys.add(t.untyped_storage()._cdata)
    return keys


def _aliased(outputs, args, n_ranks: int) -> List[int]:
    """Bytes of ``outputs`` (per rank) whose storage is an argument's."""
    keys = _storages(args)
    out = [0] * n_ranks
    for leaf in _leaves(outputs):
        blocks = leaf.blocks if isinstance(leaf, Placed) else None
        for r in range(n_ranks):
            t = blocks[r] if blocks is not None else leaf
            if t.untyped_storage()._cdata in keys:
                out[r] += nbytes(t)
    return out


def _adopt(counter: OpCounter, tree) -> None:
    for leaf in _leaves(tree):
        if isinstance(leaf, Placed):
            for r, b in enumerate(leaf.blocks):
                counter.adopt(r, [b])
        else:
            counter.adopt(-1, [leaf])


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------
def measure(cell: Cell, meta: Dict[str, Any], *, mesh_name: str,
            lower_s: float) -> Dict[str, Any]:
    """Run ``cell``'s step once under the counter and make its record."""
    mesh = cell.mesh
    n = mesh.size
    t1 = time.time()
    mesh.reset_counts()
    with torch.enable_grad(), OpCounter(n) as counter:
        _adopt(counter, cell.args)
        outputs = cell.run()
    t2 = time.time()
    costs: List[Cost] = []
    colls = collective_cost(mesh)
    for r in range(n):
        c = Cost()
        c.add(counter.costs[r])
        c.add(counter.outside)
        c.add(colls[r])
        costs.append(c)
    args_b = [a + b for a, b in zip(held_bytes(cell.args, mesh),
                                    batch_bytes(mesh, cell.batch,
                                                cell.policy))]
    out_b = held_bytes(outputs, mesh)
    alias_b = _aliased(outputs, cell.args, n)
    temp_b = counter.peak_bytes[:n]
    top = max(range(n), key=lambda r: costs[r].flops)
    ctop = max(range(n), key=lambda r: costs[r].total_wire_bytes)
    peak = [a + t for a, t in zip(args_b, temp_b)]
    c, cc = costs[top], costs[ctop]
    t3 = time.time()

    def spread(xs):
        return [min(xs), max(xs)]
    rec = dict(meta)
    rec.update({
        "mesh": mesh_name,
        "n_devices": n,
        "lower_s": round(lower_s, 2),
        "compile_s": round(t2 - t1, 2),
        "analyze_s": round(t3 - t2, 2),
        "memory": {
            "argument_bytes": max(args_b),
            "output_bytes": max(out_b),
            "temp_bytes": max(temp_b),
            "alias_bytes": max(alias_b),
            "peak_device_bytes": max(peak),
            "outside_peak_bytes": counter.peak_bytes[n],
        },
        "cost": {"flops": c.flops, "bytes_accessed": c.bytes,
                 "vmem_resident_bytes": c.vmem_bytes, "xla_flops": None,
                 "xla_bytes": None, "flops_of": "plain",
                 "bytes_by_op": dict(sorted(c.bytes_by_op.items(),
                                            key=lambda kv: -kv[1]))},
        "collectives": {
            "bytes": dict(cc.coll_bytes),
            "wire_bytes": dict(cc.coll_wire_bytes),
            "counts": dict(cc.coll_counts),
            "total_bytes": cc.total_coll_bytes,
            "total_wire_bytes": cc.total_wire_bytes,
            "fsdp_bytes": {KIND_OF[k]: per[ctop] for (k, _), per
                           in mesh.coll_tag_bytes.items()},
        },
        "spread": {
            "flops": spread([x.flops for x in costs]),
            "bytes_accessed": spread([x.bytes for x in costs]),
            "wire_bytes": spread([x.total_wire_bytes for x in costs]),
            "argument_bytes": spread(args_b),
            "temp_bytes": spread(temp_b),
        },
        "per_rank": {
            "flops": [x.flops for x in costs],
            "argument_bytes": args_b,
            "coll_bytes": {k: [x.coll_bytes[k] for x in costs]
                           for k in COLLECTIVE_KINDS},
            "coll_counts": {k: [x.coll_counts[k] for x in costs]
                            for k in COLLECTIVE_KINDS},
        },
        "n_ops": counter.n_ops,
        "ok": True,
    })
    return rec


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape.values())


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             policy: ShardingPolicy, mesh=None) -> Dict[str, Any]:
    """One cell's record on the production mesh (or ``mesh``)."""
    mesh = mesh if mesh is not None else \
        meshlib.make_production_mesh(multi_pod=multi_pod)
    if isinstance(arch, str) and isinstance(shape_name, str):
        policy = default_policy_for(arch, shape_name, policy)
    t0 = time.time()
    cell, meta = lower_cell(arch, shape_name, mesh, policy)
    rec = measure(cell, meta, mesh_name=mesh_name(mesh),
                  lower_s=time.time() - t0)
    mem, sp = rec["memory"], rec["spread"]
    print(f"[dryrun] {rec['arch']} × {rec['shape']} × {rec['mesh']}: "
          f"lower {rec['lower_s']}s, meta step {rec['compile_s']}s "
          f"({rec['n_ops']} ops), "
          f"temp {mem['temp_bytes'] / 2**30:.2f} GiB/dev, "
          f"peak {mem['peak_device_bytes'] / 2**30:.2f} GiB/dev, "
          f"flops/dev {rec['cost']['flops']:.3e} "
          f"(ranks {sp['flops'][0]:.3e}..{sp['flops'][1]:.3e}), "
          f"coll {rec['collectives']['total_wire_bytes'] / 2**20:.1f} "
          f"MiB wire/dev "
          f"({int(sum(rec['collectives']['counts'].values()))} ops)",
          flush=True)
    return rec


def iter_cells():
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        for shape in applicable_shapes(cfg):
            yield arch, shape.name


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--remat", default="dots", choices=["none", "full",
                                                       "dots"])
    p.add_argument("--no-fsdp", action="store_true")
    p.add_argument("--no-tp", action="store_true")
    p.add_argument("--no-sp", action="store_true")
    p.add_argument("--no-ep", action="store_true")
    p.add_argument("--no-vocab-shard", action="store_true")
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--fsdp-all", action="store_true",
                   help="pure-FSDP: params+batch over every mesh axis")
    p.add_argument("--no-fsdp-experts", action="store_true",
                   help="expert weights skip FSDP (replicated over data)")
    p.add_argument("--gather-expert-weights", action="store_true")
    args = p.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        p.error("name --arch and --shape, or pass --all")
    if args.remat == "none":
        args.remat = None
    policy = _policy_from_args(args)

    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            try:
                results.append(run_cell(arch, shape, multi_pod=mp,
                                        policy=policy))
            except Exception as e:  # noqa: BLE001 - report and continue
                failures += 1
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "mesh": "2x16x16" if mp else "16x16",
                                "ok": False, "error": repr(e)})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {len(results)} records to {args.out}")
    print(f"[dryrun] {len(results) - failures}/{len(results)} cells OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
