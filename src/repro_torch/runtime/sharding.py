"""Sharding policy: parameter rules, activation layouts, batch and cache
specs, and the placement of trees over a logical mesh — the port of
``repro/runtime/sharding.py``.

The policy implements DP (+hierarchical pod-DP), FSDP (params/optimizer
sharded over the data axes), TP (heads / ffn / experts over the model axis),
SP (residual-stream sequence sharding over the model axis between blocks)
and EP (MoE experts over the model axis), with the reference's rule table,
candidates and fitting: every preferred spec is validated against the
actual dimension sizes, and axes that do not divide a dimension are dropped
(never padded).

The port's own pieces:

* :class:`P` is a tuple with one entry per dimension: an axis name, a tuple
  of names (the dimension split over their product, the first axis major)
  or ``None``.  :class:`NamedSharding` pairs it with a
  :class:`~repro_torch.core.mesh.LogicalMesh`.
* The rules match the port's leaf paths.  :func:`repro_torch.models.model
  .param_tree` holds one leaf per unit repeat (``layers/L0_1_moe/wg`` is a
  tuple of ``cfg.repeats`` tensors): the repeat index is stripped before
  matching and each part gets the reference's spec without its leading
  ``None`` (the reference stacks the repeats along a leading dimension).  A
  tree in the reference's layout (``model.params_to_reference``) gets the
  reference's specs as they are, leading ``None`` included.
* :func:`place` splits every leaf of a tree into its per-rank blocks by
  mesh coordinates (:class:`Placed`: one tensor per rank, a replicated
  dimension whole on every rank that shares the block); :func:`gather` is
  its inverse.
* :class:`Constrainer` gives the activation layouts that the reference
  installs as ``with_sharding_constraint`` hooks, as specs: the sharded
  steps (``runtime/spmd.py``) read them to decide where the residual is
  sequence-sharded and how logits are split.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..launch.mesh import axis_size, dp_axes, tp_axis

__all__ = ["ShardingPolicy", "check_policy", "P", "NamedSharding", "Placed",
           "batch_axes", "param_shardings", "batch_shardings",
           "cache_shardings", "Constrainer", "place", "gather",
           "map_tree", "placed_bytes", "vocab_block"]


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
    # "data": classic FSDP over the data axes (model axis = TP).
    # "all":  pure-FSDP — params AND batch shard over every mesh axis; no
    #         tensor parallelism.
    fsdp_axes: str = "data"
    fsdp_experts: bool = True      # False: expert weights skip FSDP
    gather_expert_weights: bool = False  # reshard expert weights at use


def check_policy(mesh, policy: ShardingPolicy) -> None:
    """What the reference asserts of a policy: ``microbatches`` at least
    1.  (Manual data parallelism also refuses ``fsdp=True``:
    ``steps.build_train_step_manual``.)"""
    if policy.microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got "
                         f"{policy.microbatches}")
    if policy.fsdp_axes not in ("data", "all"):
        raise ValueError(f"fsdp_axes must be 'data' or 'all', got "
                         f"{policy.fsdp_axes!r}")


# ---------------------------------------------------------------------------
# specs and shardings
# ---------------------------------------------------------------------------
class P(tuple):
    """A partition spec: one entry per dimension, an axis name, a tuple of
    names or ``None`` (replicated); trailing dimensions left out are
    replicated.  As jax's ``PartitionSpec``, a one-name tuple is kept as
    the name and an empty one as ``None``."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (canon(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a logical mesh: rank ``r`` holds, along each dimension
    with an entry, the block at its :meth:`LogicalMesh.axis_index` over
    that entry's axes."""
    mesh: Any
    spec: P

    def full_spec(self, ndim: int) -> Tuple:
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the spec splits over."""
        return tuple(a for e in self.spec for a in _entry_axes(e))

    def block_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(n // axis_size(self.mesh, e) if e is not None else n
                     for n, e in zip(shape, self.full_spec(len(shape))))

    def box(self, rank: int, shape: Sequence[int]
            ) -> Tuple[Tuple[int, int], ...]:
        """Rank ``rank``'s block as (start, stop) along every dimension."""
        out = []
        for n, e in zip(shape, self.full_spec(len(shape))):
            if e is None:
                out.append((0, n))
                continue
            k = n // axis_size(self.mesh, e)
            i = self.mesh.axis_index(rank, _entry_axes(e))
            out.append((i * k, (i + 1) * k))
        return tuple(out)

    def replicas(self) -> int:
        """How many ranks hold each block (the product of the axes the
        spec leaves out)."""
        return self.mesh.size // axis_size(self.mesh, self.axes() or ())


def _slice(t: torch.Tensor, box) -> torch.Tensor:
    for d, (a, b) in enumerate(box):
        if (a, b) != (0, t.shape[d]):
            t = t.narrow(d, a, b - a)
    return t


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
# (path regex, candidate specs) — first matching rule wins; within a rule the
# first candidate whose partitioned dims all divide is used, else the first
# candidate with non-dividing axes dropped.  `F` is the FSDP axes tuple (or
# None), `T` the tensor axis (or None).
def _param_rules(F, T, policy: ShardingPolicy):
    E = T if policy.ep else None   # expert axis
    V = T if policy.shard_embed_vocab else None
    FE = F if policy.fsdp_experts else None   # FSDP axes for expert weights
    return [
        (r"embed$",                [P(V, F)]),
        (r"lm_head$",              [P(F, T)]),
        # moe (leading expert dim) — must precede the generic mlp rules.
        # EP proper when E divides the model axis (olmoe: 64 experts);
        # otherwise tensor-parallel experts (mixtral: 8 experts on a 16-way
        # axis -> shard the ffn dim instead).
        (r"router$",               [P(F, None)]),
        (r"_moe/w[gu]$",           [P(E, FE, None), P(None, FE, T)]),
        (r"_moe/wd$",              [P(E, None, FE), P(None, T, FE)]),
        # attention
        (r"w[qkv]$",               [P(F, T)]),
        (r"wo$",                   [P(T, F)]),
        # mlp
        (r"w[gu]$",                [P(F, T)]),
        (r"wd$",                   [P(T, F)]),
        # mamba2
        (r"w[zx]$",                [P(F, T)]),
        (r"w[BC]$",                [P(F, None)]),
        (r"wdt$",                  [P(F, None)]),
        (r"out$",                  [P(T, F)]),
        (r"conv_[wb]$",            [P()]),
        # xlstm
        (r"wup$",                  [P(F, T)]),
        (r"r[ifzo]$",              [P(T, None, None)]),
        (r"w[ifzo]$",              [P(F, T)]),
        (r"wd2$",                  [P(T, F)]),
        (r"b[ifzo]$",              [P()]),
        # norms / scalars / everything small
        (r".*",                    [P()]),
    ]


def _divides(spec: P, shape: Tuple[int, ...], mesh) -> bool:
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        if i >= len(shape) or shape[i] <= 0 \
                or shape[i] % axis_size(mesh, entry) != 0:
            return False
    return True


def _fit_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop partition axes that don't divide their dimension."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        size = axis_size(mesh, entry)
        if i < len(shape) and shape[i] % size == 0 and shape[i] > 0:
            out.append(entry)
        else:
            out.append(None)
    # trailing dims unspecified -> replicated
    return P(*out)


def vocab_block(sh: NamedSharding, shape: Sequence[int], dim: int, T,
                rank: int) -> Optional[Tuple[int, int]]:
    """Rank ``rank``'s block [lo, hi) of the vocab dimension ``dim`` of a
    leaf placed by ``sh`` with ``shape`` (``embed``'s 0, ``lm_head``'s 1),
    or None where the spec does not put the model axis ``T`` on it."""
    if T is None or sh.full_spec(len(shape))[dim] != T:
        return None
    return sh.box(rank, shape)[dim]


def _fit_candidates(specs, shape: Tuple[int, ...], mesh) -> P:
    """First candidate that divides cleanly; else first candidate fitted."""
    for spec in specs:
        full = P(*(tuple(spec) + (None,) * (len(shape) - len(spec))))
        if _divides(full, shape, mesh):
            return full
    spec = specs[0]
    full = P(*(tuple(spec) + (None,) * (len(shape) - len(spec))))
    return _fit_spec(full, shape, mesh)


def batch_axes(mesh, policy: Optional[ShardingPolicy] = None):
    """Axes carrying the batch dim (all axes under pure-FSDP)."""
    D = dp_axes(mesh)
    if policy is not None and policy.fsdp_axes == "all" and tp_axis(mesh):
        D = D + (tp_axis(mesh),)
    return D


def _policy_axes(mesh, policy: ShardingPolicy):
    F = dp_axes(mesh)
    T = tp_axis(mesh)
    if policy.fsdp_axes == "all" and T is not None:
        F = F + (T,)
        T = None            # pure-FSDP: the model axis carries data
    if not policy.fsdp:
        F = None
    if not policy.tp:
        T = None
    return F, T


# ---------------------------------------------------------------------------
# trees (module-level recursion: a recursive closure would be a reference
# cycle holding the leaves until the cyclic collector ran)
# ---------------------------------------------------------------------------
def _is_leaf(t) -> bool:
    return not isinstance(t, (dict, list, tuple))


def map_tree(fn: Callable, tree, *rest, path: Tuple = ()):
    """``tree`` with every leaf ``x`` replaced by ``fn(path, x, *the
    matching leaves of rest)``; ``path`` is the tuple of keys (dict keys,
    named-tuple fields, sequence indices).  Named tuples keep their
    type."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest),
                            path=path + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        kids = [map_tree(fn, c, *(r[i] for r in rest), path=path + (i,))
                for i, c in enumerate(tree)]
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else type(tree)(kids)
    return fn(path, tree, *rest)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _param_tree_of(abstract_params):
    """A parameter tree from a model (``model.param_tree``) or a tree."""
    if isinstance(abstract_params, torch.nn.Module):
        from ..models import model
        return model.param_tree(abstract_params)
    return abstract_params


def param_shardings(mesh, abstract_params, policy: ShardingPolicy):
    """:class:`NamedSharding` of every leaf of a parameter tree:
    ``model.param_tree``'s layout (or a ``Model``), whose layer leaves are
    per-repeat tuples, or the reference's layout with stacked layers (as
    ``model.params_to_reference`` gives it)."""
    F, T = _policy_axes(mesh, policy)
    rules = _param_rules(F, T, policy)

    def assign(path, leaf):
        per_repeat = bool(path) and path[0] == "layers" and \
            isinstance(path[-1], int)
        s = _path_str(path[:-1] if per_repeat else path)
        stacked = not per_repeat and ("layers/" in s
                                      or s.startswith("layers"))
        for pat, candidates in rules:
            if re.search(pat, s):
                break
        shape = tuple(leaf.shape)
        if stacked:
            candidates = [P(None, *c) for c in candidates]  # unit-repeat dim
        return NamedSharding(mesh, _fit_candidates(candidates, shape, mesh))

    return map_tree(assign, _param_tree_of(abstract_params))


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------
def batch_shardings(mesh, abstract_batch,
                    policy: Optional[ShardingPolicy] = None):
    """Tokens & friends: batch dim over the DP axes (all axes for
    pure-FSDP policies)."""
    D = batch_axes(mesh, policy)

    def assign(path, leaf):
        spec = P(D, *([None] * (len(leaf.shape) - 1)))
        return NamedSharding(mesh, _fit_spec(spec, tuple(leaf.shape), mesh))

    return map_tree(assign, abstract_batch)


def cache_shardings(mesh, abstract_cache, policy: ShardingPolicy):
    """Decode caches: batch over DP where divisible, heads over TP.

    Leaf layouts (leading dim = unit repeats), the reference's and the
    port's (``model.init_cache``):
      attn k/v      (R, B, T, Hkv, dh) -> P(None, D, None, T, None)
      mamba2 state  (R, B, H, P, N)    -> P(None, D, T, None, None)
      mamba2 conv   (R, B, K, C)       -> P(None, D, None, T)
      mlstm C       (R, B, H, d, d)    -> P(None, D, T, None, None)
      mlstm n       (R, B, H, d)       -> P(None, D, T, None)
      mlstm m       (R, B, H)          -> P(None, D, T)
      slstm c/n/h/m (R, B, d)          -> P(None, D, T)
    A KV cache whose heads do not divide the model axis is sharded over
    time instead (the flash-decode layout).
    """
    D = dp_axes(mesh)
    T = tp_axis(mesh) if policy.tp else None

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd >= 3:
            spec = [None, D] + [None] * (nd - 2)
            if nd >= 4:
                s = _path_str(path)
                if "_attn" in s or "_swa" in s or "_shared" in s:
                    if shape[nd - 2] % axis_size(mesh, T or ()) == 0 \
                            and T is not None:
                        spec[nd - 2] = T
                    else:
                        spec[2] = T
                else:
                    spec[2] = T
            else:
                spec[2] = T
        else:
            spec = [None] * nd
        return NamedSharding(mesh, _fit_spec(P(*spec), shape, mesh))

    return map_tree(assign, abstract_cache)


# ---------------------------------------------------------------------------
# activation layouts
# ---------------------------------------------------------------------------
class Constrainer:
    """The reference's activation constraints, as the specs they fit to.

    The reference installs these as ``with_sharding_constraint`` hooks and
    GSPMD moves data to match; the port's sharded steps place activations
    themselves and read the two specs that decide a layout: ``residual``
    says whether the residual stream is sequence-sharded between blocks
    (SP), ``logits`` how the loss's logits are split and whether
    decode's are split over the vocab.  (Where the
    reference constrains heads, ffn columns and experts, the port's
    blocks follow their weights' shardings.)  Each method takes a shape
    and returns the fitted spec.
    """

    def __init__(self, mesh, policy: ShardingPolicy, *,
                 decode: bool = False):
        self.mesh = mesh
        self.policy = policy
        self.D = batch_axes(mesh, policy)
        _, self.T = _policy_axes(mesh, policy)
        self.decode = decode

    def _c(self, shape, *spec) -> P:
        return _fit_spec(P(*spec), tuple(shape), self.mesh)

    def residual(self, shape) -> P:         # (B, S, d)
        if len(shape) != 3:
            return P(*([None] * len(shape)))
        if self.policy.sp and not self.decode:
            return self._c(shape, self.D, self.T, None)
        return self._c(shape, self.D, None, None)

    def logits(self, shape) -> P:           # (B, S, V)
        if self.decode:
            return self._c(shape, self.D, None, self.T)
        return self._c(shape, self.D, self.T, None)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
class Placed:
    """A tensor placed over a logical mesh: ``blocks[r]`` is rank ``r``'s
    block (its own tensor: ranks that share a block hold equal copies),
    ``shape`` the whole tensor's."""

    __slots__ = ("sharding", "shape", "blocks")

    def __init__(self, sharding: NamedSharding, shape: Sequence[int],
                 blocks: List[torch.Tensor]) -> None:
        self.sharding = sharding
        self.shape = tuple(shape)
        self.blocks = blocks

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def box(self, rank: int):
        return self.sharding.box(rank, self.shape)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor, on ``device`` (the blocks' by default),
        made on the current stream after every rank's stream."""
        mesh = self.sharding.mesh
        b0 = self.blocks[0]
        out = torch.empty(self.shape, dtype=b0.dtype,
                          device=device if device is not None else b0.device)
        mesh.join()
        with torch.no_grad():
            done = set()
            for r, blk in enumerate(self.blocks):
                box = self.box(r)
                if box in done:
                    continue
                done.add(box)
                _slice(out, box).copy_(blk)
        return out

    def __repr__(self) -> str:
        return (f"Placed({self.shape}, {self.dtype}, "
                f"{self.sharding.spec!r})")


def _place_leaf(t: torch.Tensor, sh: NamedSharding,
                dtype: Optional[torch.dtype] = None) -> Placed:
    mesh = sh.mesh
    t = t.detach()
    shape = tuple(t.shape)
    for n, e in zip(shape, sh.full_spec(len(shape))):
        if e is not None and n % axis_size(mesh, e):
            raise ValueError(f"{sh.spec!r} does not divide {shape}")
    blocks = []
    mesh.fork()
    with torch.no_grad():
        for r in range(mesh.size):
            with mesh.on(r):
                blk = torch.empty(sh.block_shape(shape),
                                  dtype=dtype or t.dtype, device=mesh.device)
                blk.copy_(_slice(t, sh.box(r, shape)))
            blocks.append(blk)
    mesh.join()
    return Placed(sh, shape, blocks)


def place(tree, shardings, *, dtype: Optional[torch.dtype] = None):
    """Every tensor of ``tree`` split into its per-rank blocks by the
    :class:`NamedSharding` at the same place in ``shardings`` (a tree of
    the same structure): a :class:`Placed` leaf each, the blocks on the
    mesh's device (each made on its rank's stream), in ``dtype`` when
    given (arrays are taken as tensors)."""
    return map_tree(lambda _, leaf, sh: _place_leaf(
        torch.as_tensor(leaf), sh, dtype), tree, shardings)


def gather(placed, device=None):
    """The inverse of :func:`place`: every :class:`Placed` leaf as the
    whole tensor (bitwise the one placed)."""
    return map_tree(lambda _, leaf: leaf.gather(device)
                    if isinstance(leaf, Placed) else leaf, placed)


def placed_bytes(tree, mesh) -> List[int]:
    """Bytes every rank holds in the :class:`Placed` leaves of ``tree``."""
    out = [0] * mesh.size
    leaves: List[Any] = []
    map_tree(lambda _, x: leaves.append(x), tree)
    for leaf in leaves:
        if isinstance(leaf, Placed):
            for r, b in enumerate(leaf.blocks):
                out[r] += b.numel() * b.element_size()
    return out
