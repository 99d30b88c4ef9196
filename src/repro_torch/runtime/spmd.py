"""The port's model over a logical mesh — what GSPMD makes of the
reference's auto-mode steps, written out.

:class:`ShardedModel` runs :mod:`repro_torch.models.model` with its
parameters placed by :func:`~repro_torch.runtime.sharding.param_shardings`
(:class:`~repro_torch.runtime.sharding.Placed` leaves: one block a rank)
over the mesh's logical ranks, each rank's work issued on its own stream,
and gives the single-device model's numbers up to summation order:

* **FSDP** over the data axes: a leaf's blocks are gathered just before
  the block that uses it runs (:class:`_Use`, one autograd node over every
  rank) and the gathered copies are not kept for the backward: a
  saved-tensor hook drops them and gathers again when the backward needs
  them, as GSPMD re-gathers inside its scan.  The backward of a use sums
  each rank's gradient into the blocks it was gathered from (a
  reduce-scatter over the gathered axes and a sum over the axes the leaf
  is replicated on), so every block receives the whole gradient of its
  part of the leaf.
* **TP** over the model axis, Megatron-style, for attention (the shared
  attention too), MLPs and MoE: a rank keeps its column blocks of
  ``wq``/``wk``/``wv`` (its heads; the heads must divide the axis) and
  ``wg``/``wu`` (its ``d_ff`` slice) and its row blocks of ``wo``/``wd``,
  so its block output is a partial sum, added over the model axis by a
  ``psum``.
* **SP** when ``policy.sp`` (the reference's ``Constrainer.residual``):
  between blocks a rank holds its sequence slice of the residual; the
  normed input is all-gathered over the model axis before a block and the
  block's partial output reduce-scattered after it (a replicated output is
  sliced).
* **EP** when the experts divide the model axis: every model rank routes
  and dispatches its tokens as ``layers.MoE`` does, runs ``ops.moe_gmm`` on
  its ``E / T`` experts, and the experts' outputs are all-gathered along E
  before the combine, which is then bitwise the one-rank combine.  When E
  does not divide, the rule table shards the experts' ffn dimension and
  the expert products are tensor-parallel (partial sums).
* Mamba2, mLSTM and sLSTM blocks store their weights by the rule table
  but gather every block at use and compute the block whole on every model
  rank: the same numbers, without tensor parallelism inside them.

Every loss term is counted on one rank only: the LM head runs on the
rank's slice of the sequence (the reference's sequence-sharded logits) and
its batch rows, and the MoE load-balancing loss, whose means run over the
whole batch (a ``psum`` over the data ranks), on rank 0.  The backward of
every collective is its adjoint (``core.mesh.ad_*``), so the sum of the
ranks' losses differentiates to the single-device gradient.

Decode caches are placed by ``cache_shardings``: a block reads and
writes its cache in place where the rank's block is exactly what the
block computes on (KV heads over the model axis for a tensor-parallel
attention), and otherwise gathers what it needs first and writes its part
back after.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from ..core.mesh import ad_all_gather, ad_psum, ad_reduce_scatter, nbytes
from ..launch.mesh import axis_size
from ..models import layers as L
from ..models import model
from ..models.config import (ATTN, MAMBA2, MLP, MLSTM, MOE, SHARED_ATTN,
                             SLSTM, SWA, ModelConfig)
from .sharding import (Constrainer, NamedSharding, Placed, ShardingPolicy,
                       _policy_axes, _slice, batch_axes, batch_shardings,
                       param_shardings)

__all__ = ["ShardedModel"]

Box = Tuple[Tuple[int, int], ...]


def _inside(inner: Box, outer: Box) -> bool:
    return all(a >= c and b <= d for (a, b), (c, d) in zip(inner, outer))


def _overlap(a: Box, b: Box) -> Optional[Box]:
    out = tuple((max(x, y), min(u, v)) for (x, u), (y, v) in zip(a, b))
    return None if any(lo >= hi for lo, hi in out) else out


def _shift(box: Box, origin: Box) -> Box:
    return tuple((a - o, b - o) for (a, b), (o, _) in zip(box, origin))


def _move(mesh, x: torch.Tensor, src: int, dst: int,
          out: torch.Tensor) -> None:
    """A cache piece copied from rank ``src`` into ``out`` of rank
    ``dst``'s; between two ranks, a point-to-point send counted as a
    ``ppermute`` of the piece on the sender."""
    with mesh.collective("ppermute") as outer:
        mesh._transfer(x, src, dst, out=out)
    if outer and src != dst:
        mesh.count("ppermute", src, nbytes(x), 2)


# ---------------------------------------------------------------------------
# a placed leaf at use
# ---------------------------------------------------------------------------
class _UsePlan:
    """Where each rank's copy of a leaf placed by ``sharding`` with
    ``shape`` comes from at use.  ``keep`` names the dimension (if any) on
    which a rank keeps its own block of the model axis; every other
    dimension is whole at use."""

    def __init__(self, sharding: NamedSharding, shape: Tuple[int, ...],
                 keep: Optional[int]) -> None:
        mesh = sharding.mesh
        self.mesh = mesh
        self.boxes = [sharding.box(r, shape) for r in range(mesh.size)]
        self.use = [tuple(b if d == keep else (0, shape[d])
                          for d, b in enumerate(box))
                    for box in self.boxes]
        # rank r's use is assembled from one holder of each distinct block
        # inside it (r itself when it holds that block)
        self.sources: List[List[Tuple[int, Box]]] = []
        for r in range(mesh.size):
            seen: Dict[Box, int] = {}
            for q in [r] + [q for q in range(mesh.size) if q != r]:
                box = self.boxes[q]
                if box not in seen and _inside(box, self.use[r]):
                    seen[box] = q
            self.sources.append([(q, _shift(b, self.use[r]))
                                 for b, q in seen.items()])
        # rank r's block gathers the gradient of every use that holds it
        self.sinks = [[(q, _shift(self.boxes[r], self.use[q]))
                       for q in range(mesh.size)
                       if _inside(self.boxes[r], self.use[q])]
                      for r in range(mesh.size)]
        self.trivial = all(len(s) == 1 and s[0][0] == r
                           and self.use[r] == self.boxes[r]
                           for r, s in enumerate(self.sources))

    def assemble(self, blocks: Sequence[torch.Tensor], r: int
                 ) -> torch.Tensor:
        """Rank ``r``'s use, on its stream, from the holders' blocks: rank
        ``r``'s part of an all-gather over the holders (counted as one,
        its own block the operand)."""
        mesh = self.mesh
        shape = tuple(b - a for a, b in self.use[r])
        with mesh.collective("all_gather") as outer:
            with mesh.on(r):
                out = torch.empty(shape, dtype=blocks[r].dtype,
                                  device=blocks[r].device)
            for q, box in self.sources[r]:
                mesh._transfer(blocks[q], q, r, out=_slice(out, box))
        if outer:
            mesh.count("all_gather", r, nbytes(blocks[r]),
                       len(self.sources[r]), "fsdp")
        return out

    def reduce(self, grads: Sequence[torch.Tensor], r: int) -> torch.Tensor:
        """Rank ``r``'s block of the gradient: the sum, in rank order, of
        its part of every use's gradient.  Over more than one use it is
        rank ``r``'s part of a reduce-scatter (an all-reduce where the
        block is the whole use), its use's gradient the operand."""
        mesh = self.mesh
        sinks = self.sinks[r]
        kind = "psum" if self.use[r] == self.boxes[r] else "reduce_scatter"
        total = None
        with mesh.collective(kind) as outer:
            for q, box in sinks:
                got = mesh._transfer(_slice(grads[q], box), q, r)
                with mesh.on(r):
                    total = got if total is None else total.add_(got)
        if outer and len(sinks) > 1:
            mesh.count(kind, r, nbytes(grads[r]), len(sinks), "fsdp")
        return total


class _Use(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan: _UsePlan, *blocks):
        ctx.plan, ctx.dtype = plan, blocks[0].dtype
        mesh = plan.mesh
        if plan.trivial:
            return tuple(b.view_as(b) for b in blocks)
        return tuple(plan.assemble(blocks, r) for r in range(mesh.size))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *gs):
        plan = ctx.plan
        mesh = plan.mesh
        mesh.fork()
        gs = [g if g is not None else torch.zeros(
            tuple(b - a for a, b in plan.use[r]), dtype=ctx.dtype,
            device=mesh.device) for r, g in enumerate(gs)]
        out = [plan.reduce(gs, r) for r in range(mesh.size)]
        mesh.join()
        return (None,) + tuple(out)


def _pack(t: torch.Tensor):
    """Saved-tensor hook: a gathered weight (or a view of one) is saved
    as the recipe to gather it again."""
    base = t if hasattr(t, "_spmd_regather") else t._base
    recipe = getattr(base, "_spmd_regather", None) if base is not None \
        else None
    if recipe is None:
        return t
    return recipe, tuple(t.shape), t.stride(), t.storage_offset()


def _unpack(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    (plan, blocks, r), shape, stride, offset = packed
    return plan.assemble(blocks, r).as_strided(shape, stride, offset)


def drop_gathered_weights():
    """A context in which the autograd graph keeps no gathered weight:
    each is gathered again in the backward (see the module's note)."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


# ---------------------------------------------------------------------------
# the sharded model
# ---------------------------------------------------------------------------
_TP_ATTN = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
_TP_MLP = {"wg": 1, "wu": 1, "wd": 0}
_EP = {"wg": 0, "wu": 0, "wd": 0}
_TP_EXPERTS = {"wg": 2, "wu": 2, "wd": 1}


class ShardedModel:
    """``cfg``'s model over ``mesh`` under ``policy``: the forward of the
    train, prefill and decode modes on placed parameters (see the module's
    note).  ``shardings`` is ``param_shardings`` of the port's parameter
    tree (``model.param_tree``'s layout); the block modules of a ``meta``
    model give the computations, run with each rank's tensors through
    ``torch.func.functional_call``."""

    def __init__(self, cfg: ModelConfig, mesh, policy: ShardingPolicy, *,
                 decode: bool = False) -> None:
        self.cfg, self.mesh, self.policy = cfg, mesh, policy
        self.shell = model.Model(cfg, device="meta")
        self.shardings = param_shardings(mesh, self.shell, policy)
        self.constrain = Constrainer(mesh, policy, decode=decode)
        self.D = batch_axes(mesh, policy)
        _, T = _policy_axes(mesh, policy)
        self.T = T if T is not None and axis_size(mesh, T) > 1 else None
        self.nT = axis_size(mesh, self.T)
        self.keep = self._keep_dims()
        # the use plans, one per (sharding, shape, kept dimension)
        self._plans: Dict[Tuple[Any, ...], _UsePlan] = {}

    # -- plans ----------------------------------------------------------------
    def _spec_has(self, sh: NamedSharding, dim: int) -> bool:
        spec = sh.full_spec(dim + 1)
        return self.T is not None and spec[dim] == self.T

    def _fits(self, shards: Dict[str, Any], dims: Dict[str, int]) -> bool:
        """Whether every weight of ``dims`` has the model axis on its
        dimension (a GeLU MLP has no ``wg``)."""
        for k, d in dims.items():
            if k not in shards:
                if k == "wg":
                    continue
                return False
            sh = shards[k][0] if isinstance(shards[k], tuple) else shards[k]
            if not self._spec_has(sh, d):
                return False
        return True

    def _keep_dims(self) -> Dict[Tuple[str, ...], Dict[str, int]]:
        """Per block (its path in the parameter tree), the dimension each
        weight keeps on the model axis at use; an empty dict computes the
        block whole on every model rank."""
        cfg = self.cfg
        out: Dict[Tuple[str, ...], Dict[str, int]] = {}
        heads_ok = self.T is not None and cfg.n_heads % self.nT == 0 \
            and cfg.n_kv_heads % self.nT == 0
        sh = self.shardings
        for name, _, kind in model._block_names(cfg):
            if kind in (ATTN, SWA):
                out[("layers", name)] = _TP_ATTN if heads_ok and self._fits(
                    sh["layers"][name], _TP_ATTN) else {}
            elif kind == MLP:
                out[("layers", name)] = _TP_MLP if self._fits(
                    sh["layers"][name], _TP_MLP) else {}
            elif kind == MOE:
                s = sh["layers"][name]
                out[("layers", name)] = _EP if self._fits(s, _EP) else \
                    _TP_EXPERTS if self._fits(s, _TP_EXPERTS) else {}
        if "shared" in sh:
            out[("shared", "attn")] = _TP_ATTN if heads_ok and self._fits(
                sh["shared"]["attn"], _TP_ATTN) else {}
            out[("shared", "mlp")] = _TP_MLP if self._fits(
                sh["shared"]["mlp"], _TP_MLP) else {}
        return out

    def tensor_parallel(self) -> Dict[str, str]:
        """How each block kind runs over the model axis: ``"tp"``,
        ``"ep"``, ``"tp_experts"`` or ``"whole"`` (for the docs and
        tests)."""
        out = {}
        for (_, name), keep in self.keep.items():
            out[name] = ("ep" if keep is _EP else "tp_experts"
                         if keep is _TP_EXPERTS else "tp" if keep
                         else "whole")
        return out

    # -- weights at use -------------------------------------------------------
    def _use(self, leaf: Placed, keep: Optional[int] = None
             ) -> List[torch.Tensor]:
        key = (leaf.sharding, leaf.shape, keep)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = _UsePlan(leaf.sharding, leaf.shape,
                                               keep)
        out = list(_Use.apply(plan, *leaf.blocks))
        if not plan.trivial:
            for r, t in enumerate(out):
                t._spmd_regather = (plan, leaf.blocks, r)
        return out

    def _use_tree(self, tree: Dict[str, Any], keep: Dict[str, int],
                  repeat: Optional[int] = None) -> List[Dict[str, Any]]:
        """A block's (or norm's) leaves at use, one dict per rank."""
        per_rank: List[Dict[str, Any]] = [{} for _ in range(self.mesh.size)]
        for k, leaf in tree.items():
            if isinstance(leaf, tuple):
                leaf = leaf[repeat]
            for r, t in enumerate(self._use(leaf, keep.get(k))):
                per_rank[r][k] = t
        return per_rank

    # -- activations ----------------------------------------------------------
    def _t(self, r: int) -> int:
        return self.mesh.axis_index(r, self.T) if self.T else 0

    def _sp(self, shape) -> bool:
        return self.T is not None and \
            self.constrain.residual(shape)[1] == self.T

    def _seq_slice(self, x: torch.Tensor, r: int, dim: int = 1
                   ) -> torch.Tensor:
        n = x.shape[dim] // self.nT
        return x.narrow(dim, self._t(r) * n, n)

    def _gather_seq(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return ad_all_gather(self.mesh, xs, self.T, dim=1)

    def _to_residual(self, hs: List[torch.Tensor], partial: bool,
                     sp: bool) -> List[torch.Tensor]:
        """A block's per-rank outputs (whole sequence) in the residual's
        layout: partial sums added over the model axis, and under SP only
        the rank's sequence slice."""
        if partial:
            if sp:
                return ad_reduce_scatter(self.mesh, hs, self.T, dim=1)
            return ad_psum(self.mesh, hs, self.T)
        if sp:
            return [self._seq_slice(h, r) for r, h in enumerate(hs)]
        return hs

    def _per_rank(self, fn, *args) -> List[Any]:
        mesh = self.mesh
        out = []
        for r in range(mesh.size):
            with mesh.on(r):
                out.append(fn(r, *(a[r] for a in args)))
        return out

    # -- caches ---------------------------------------------------------------
    def _cache_plan(self, leaf: Placed, u: int, r: int, rows: Tuple[int, int],
                    heads: Optional[Tuple[int, int]]) -> Box:
        """Rank ``r``'s use box of a cache leaf (R, B, ...) in unit ``u``:
        its batch rows, its heads when given (dim 3), the rest whole."""
        box = [(u, u + 1), rows] + [(0, n) for n in leaf.shape[2:]]
        if heads is not None:
            box[3] = heads
        return tuple(box)

    def _cache_uses(self, cache: Dict[str, Placed], u: int, rows, heads):
        """Each rank's use of one block's cache in unit ``u`` (a dict of
        tensors) and what to write back after the block: in-place views
        where a rank's block is exactly its use, else gathered copies."""
        mesh = self.mesh
        uses: List[Dict[str, torch.Tensor]] = [{} for _ in range(mesh.size)]
        backs = []
        for k, leaf in cache.items():
            for r in range(mesh.size):
                use = self._cache_plan(leaf, u, r, rows[r],
                                       heads[r] if k in ("k", "v") and
                                       heads is not None else None)
                own = leaf.box(r)
                if _inside(use, own) and use[1:] == own[1:]:
                    uses[r][k] = leaf.blocks[r][u]
                    continue
                with mesh.on(r):
                    t = torch.empty(tuple(b - a for a, b in use),
                                    dtype=leaf.dtype, device=mesh.device)
                done = set()
                for q in [r] + list(range(mesh.size)):
                    ov = _overlap(use, leaf.box(q))
                    if ov is None or ov in done:
                        continue
                    done.add(ov)
                    _move(mesh, _slice(leaf.blocks[q],
                                       _shift(ov, leaf.box(q))), q, r,
                          _slice(t, _shift(ov, use)))
                uses[r][k] = t[0]
                backs.append((leaf, r, use, t))
        return uses, backs

    def _write_back(self, backs) -> None:
        mesh = self.mesh
        for leaf, r, use, t in backs:
            for q in range(mesh.size):
                ov = _overlap(use, leaf.box(q))
                if ov is not None:
                    _move(mesh, _slice(t, _shift(ov, use)), r, q,
                          _slice(leaf.blocks[q], _shift(ov, leaf.box(q))))

    # -- blocks ---------------------------------------------------------------
    def _norm(self, tree, repeat, xs, module) -> List[torch.Tensor]:
        ws = self._use_tree(tree, {}, repeat)
        return self._per_rank(
            lambda r, w, x: functional_call(module, w, (x,)), ws, xs)

    def _attention(self, key, module, tree, repeat, xin, *, angles, window,
                   caches, cache_index):
        keep = self.keep[key]
        ws = self._use_tree(tree, keep, repeat)
        cs = caches if caches is not None else [None] * self.mesh.size
        hs = self._per_rank(lambda r, w, x, c: functional_call(
            module, w, (x,), dict(angles=angles, window=window, cache=c,
                                  cache_index=cache_index)),
            ws, xin, cs)
        return hs, bool(keep)

    def _mlp(self, key, module, tree, repeat, xin):
        keep = self.keep[key]
        ws = self._use_tree(tree, keep, repeat)
        hs = self._per_rank(lambda r, w, x: functional_call(module, w, (x,)),
                            ws, xin)
        return hs, bool(keep)

    def _moe(self, key, module: L.MoE, tree, repeat, xin, rows_split):
        cfg, mesh = self.cfg, self.mesh
        keep = self.keep[key]
        ws = self._use_tree(tree, keep, repeat)
        E = cfg.n_experts

        def dispatch(r, w, x):
            return module.dispatch(x, router=w["router"])
        plans = self._per_rank(dispatch, ws, xin)
        if keep is _EP:
            n = E // self.nT

            def local(r, w, p):
                xe = p[0].narrow(0, self._t(r) * n, n)
                return module.experts(xe, w["wg"], w["wu"], w["wd"])
            ye = ad_all_gather(mesh, self._per_rank(local, ws, plans),
                               self.T, dim=0)
        else:
            ye = self._per_rank(lambda r, w, p: module.experts(
                p[0], w["wg"], w["wu"], w["wd"]), ws, plans)
        hs = self._per_rank(lambda r, y, p, x: module.combine(y, p[1], x),
                            ye, plans, xin)
        # the load-balancing loss's means run over the whole batch
        parts = self._per_rank(lambda r, p: module.aux_parts(p[2], p[3]),
                               plans)
        p_sum = [p[0] for p in parts]
        c_sum = [p[1] for p in parts]
        n_rows = xin[0].shape[0] * xin[0].shape[1]
        if rows_split and self.D and axis_size(mesh, self.D) > 1:
            p_sum = ad_psum(mesh, p_sum, self.D)
            with torch.no_grad():
                c_sum = mesh.psum(c_sum, self.D)
            n_rows *= axis_size(mesh, self.D)
        aux = self._per_rank(lambda r, p, c: E * (
            (p / n_rows) * (c / n_rows)).sum(), p_sum, c_sum)
        return hs, keep is _TP_EXPERTS, aux

    def _shared(self, tree, xs, x0s, sp, *, angles, caches, cache_index):
        """Zamba2's shared block: concat(x, x0) @ win, attention and an
        MLP, each with its residual; returns its output in the residual's
        layout."""
        shell = self.shell.shared
        win = self._use_tree({"win": tree["win"]}, {})
        h = self._per_rank(lambda r, w, x, x0: torch.cat([x, x0], dim=-1)
                           @ w["win"], win, xs, x0s)
        if sp:
            h = self._gather_seq(h)
        a_in = self._norm(tree["norm"], None, h, shell.norm)
        a, partial = self._attention(("shared", "attn"), shell.attn,
                                     tree["attn"], None, a_in,
                                     angles=angles, window=None,
                                     caches=caches, cache_index=cache_index)
        if partial:
            a = ad_psum(self.mesh, a, self.T)
        h = self._per_rank(lambda r, x, y: x + y, h, a)
        m_in = self._norm(tree["norm2"], None, h, shell.norm2)
        m, partial = self._mlp(("shared", "mlp"), shell.mlp, tree["mlp"],
                               None, m_in)
        m = self._to_residual(m, partial, sp)
        if sp:
            h = [self._seq_slice(x, r) for r, x in enumerate(h)]
        return self._per_rank(lambda r, x, y: x + y, h, m)

    def _unit(self, params, u: int, xs, x0s, *, sp, angles, mode, cache,
              cache_index, rows, heads, rows_split):
        cfg, mesh = self.cfg, self.mesh
        layers = params["layers"]
        unit = self.shell.units[0]
        decode = mode == "decode"
        aux = [torch.zeros((), dtype=torch.float32, device=mesh.device)
               for _ in range(mesh.size)]
        for name, norm_name, kind in model._block_names(cfg):
            backs = []
            caches = None
            if cache is not None and name in cache:
                key = ("shared", "attn") if kind == SHARED_ATTN \
                    else ("layers", name)
                hd = heads if self.keep.get(key) else None
                caches, backs = self._cache_uses(cache[name], u, rows, hd)
            if kind == SHARED_ATTN:
                hs = self._shared(params["shared"], xs, x0s, sp,
                                  angles=angles, caches=caches,
                                  cache_index=cache_index if decode else None)
                self._write_back(backs)
                xs = self._per_rank(lambda r, x, h: x + h, xs, hs)
                continue
            xin = self._norm(layers[norm_name], u, xs, unit.blocks[norm_name])
            if sp:
                xin = self._gather_seq(xin)
            module = unit.blocks[name]
            tree = layers[name]
            partial = False
            if kind in (ATTN, SWA):
                hs, partial = self._attention(
                    ("layers", name), module, tree, u, xin, angles=angles,
                    window=cfg.sliding_window if kind == SWA else None,
                    caches=caches, cache_index=cache_index if decode
                    else None)
            elif kind == MLP:
                hs, partial = self._mlp(("layers", name), module, tree, u,
                                        xin)
            elif kind == MOE:
                hs, partial, a = self._moe(("layers", name), module, tree,
                                           u, xin, rows_split)
                aux = self._per_rank(lambda r, x, y: x + y, aux, a)
            else:
                ws = self._use_tree(tree, {}, u)
                cs = caches if caches is not None else [None] * mesh.size
                hs = self._per_rank(lambda r, w, x, c: functional_call(
                    module, w, (x,), dict(cache=c, decode=decode)),
                    ws, xin, cs)
            self._write_back(backs)
            hs = self._to_residual(hs, partial, sp)
            xs = self._per_rank(lambda r, x, h: x + h, xs, hs)
        return xs, aux

    # -- the model ------------------------------------------------------------
    def _embed(self, params, batch, mode):
        cfg = self.cfg
        table = self._use(params["embed"]) if "embed" in params \
            else [None] * self.mesh.size
        return self._per_rank(lambda r, e, b: model.embed_inputs(
            cfg, e, b, mode), table, batch)

    def _head(self, params, xs) -> List[Optional[torch.Tensor]]:
        norm = self._norm(params["final_norm"], None, xs,
                          self.shell.final_norm)
        tied = "lm_head" not in params
        ws = self._use(params["embed" if tied else "lm_head"])
        return self._per_rank(lambda r, w, x: model.project_out(
            self.cfg, x, w, tied=tied), ws, norm)

    def split_batch(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[List[Dict[str, torch.Tensor]],
                               List[Tuple[int, int]], bool]:
        """Each rank's rows of ``batch`` (views; ``batch_shardings``), the
        rows as (start, stop), and whether the rows are split at all."""
        shs = batch_shardings(self.mesh, batch, self.policy)
        mesh = self.mesh
        out = [{k: _slice(v, shs[k].box(r, v.shape)) for k, v in
                batch.items()} for r in range(mesh.size)]
        key = next(iter(batch))
        rows = [shs[key].box(r, batch[key].shape)[0]
                for r in range(mesh.size)]
        return out, rows, shs[key].spec[0] is not None

    def forward(self, params, batch: Dict[str, torch.Tensor], *,
                mode: str, cache=None, cache_index: Optional[int] = None,
                remat: Optional[str] = None):
        """One pass of every rank over its rows of ``batch`` (the caller
        brackets it with ``mesh.region()``).

        ``mode="train"``: returns (each rank's loss term, or None where it
        owns no position: its positions' summed NLL over all of the
        batch's positions; the aux loss on rank 0 (0-d fp32)).
        ``"prefill"`` / ``"decode"``: returns each rank's last-position
        logits (its rows, whole vocab) and fills ``cache`` (placed by
        ``cache_shardings``; prefill fills positions [0, S) of it)."""
        cfg, mesh = self.cfg, self.mesh
        per, rows, rows_split = self.split_batch(batch)
        x = self._embed(params, per, mode)
        B, S = x[0].shape[:2]
        sp = mode != "decode" and self._sp(
            (B * axis_size(mesh, self.D) if rows_split else B, S,
             cfg.d_model))
        if mode == "decode":
            positions = torch.full((B, S), int(cache_index),
                                   device=mesh.device)
        else:
            positions = torch.arange(S, device=mesh.device).expand(B, S)
        angles = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        if sp:
            x = [self._seq_slice(t, r) for r, t in enumerate(x)]
        x0 = x
        heads = None
        if cfg.n_kv_heads % self.nT == 0 and self.T is not None:
            k = cfg.n_kv_heads // self.nT
            heads = [(self._t(r) * k, (self._t(r) + 1) * k)
                     for r in range(mesh.size)]
        aux = [torch.zeros((), dtype=torch.float32, device=mesh.device)
               for _ in range(mesh.size)]
        hook = drop_gathered_weights() if mode == "train" and \
            torch.is_grad_enabled() else None
        if hook is not None:
            hook.__enter__()
        try:
            for u in range(cfg.repeats):
                run = self._unit_fn(params, u, x0, sp, angles, mode, cache,
                                    cache_index, rows, heads,
                                    rows_split)
                out = model.checkpointed(
                    run, remat if mode == "train" else None, *x)
                x = list(out[:mesh.size])
                aux = self._per_rank(lambda r, a, b: a + b, aux,
                                     list(out[mesh.size:]))
            if mode != "train":
                if sp:
                    x = self._gather_seq(x)
                x = [t[:, -1:] for t in x]
                return self._head(params, x)
            return self._loss(params, x, per, sp, rows_split, aux)
        finally:
            if hook is not None:
                hook.__exit__(None, None, None)

    def _unit_fn(self, params, u, x0, sp, angles, mode, cache, cache_index,
                 rows, heads, rows_split):
        def run(*xs):
            out, aux = self._unit(params, u, list(xs), x0, sp=sp,
                                  angles=angles,
                                  mode=mode, cache=cache,
                                  cache_index=cache_index,
                                  rows=rows, heads=heads,
                                  rows_split=rows_split)
            return tuple(out) + tuple(aux)
        return run

    def _loss(self, params, xs, per, sp, rows_split, aux):
        """Each rank's loss term over the positions it owns (its sequence
        slice of its rows), and rank 0's aux loss."""
        cfg, mesh = self.cfg, self.mesh
        S_full = per[0]["labels"].shape[1]
        B_all = per[0]["labels"].shape[0] * (
            axis_size(mesh, self.D) if rows_split else 1)
        n_tok = B_all * S_full
        logits_spec = self.constrain.logits((B_all, S_full, 1))
        seq_split = self.T is not None and logits_spec[1] == self.T
        owners = []
        for r in range(mesh.size):
            owns = (rows_split or mesh.axis_index(r, self.D) == 0
                    if self.D else True)
            owners.append(owns and (seq_split or self._t(r) == 0))
        hs, labels = [], []
        for r, x in enumerate(xs):
            lab = per[r]["labels"]
            if seq_split:
                lab = self._seq_slice(lab, r)
                if not sp:
                    x = self._seq_slice(x, r)
            elif sp:
                raise AssertionError("sequence-sharded residual without "
                                     "sequence-sharded logits")
            hs.append(x)
            labels.append(lab)
        logits = self._head(params, hs)

        def nll(r, z, lab):
            if not owners[r]:
                return None
            return model.token_nll(z, lab).sum() / n_tok
        terms = self._per_rank(nll, logits, labels)
        return terms, aux[0]
