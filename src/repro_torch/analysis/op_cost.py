"""Per-rank cost of one eager step over logical ranks — the port's
counterpart of ``repro/analysis/hlo_cost.py``.

The reference re-derives per-device costs from compiled HLO text.  The
port has no HLO: a step is the sequence of aten operations that its
Python executes, and :class:`OpCounter` (a ``TorchDispatchMode``) sees
every one of them, the backward's and every recomputation's included.
Eager execution runs every loop iteration, so the reference's loop
multiplication comes free.  Per operation:

* **flops** — ``mm``/``bmm``/``addmm``/``baddbmm``/``convolution`` at 2 x
  output elements x the contracted size; the aten names of the
  reference's ``_ELEMENTWISE`` opcodes at 1 flop an output element;
  reductions at 1 flop an input element.  A few aten operations that XLA
  expresses as several HLO ops count as that many (softmax 5 an element,
  ``silu`` 2: :data:`_COMPOUND`).  Everything else (copies, gathers,
  concatenations, casts) does no flops, as in the reference.
* **bytes** — Σ (operand + result bytes) of every operation: the unfused
  eager count, which (unlike the reference's XLA figure) is what an eager
  step really moves.  Views, ``empty`` and metadata operations move 0
  bytes, as ``_NO_BYTES`` does; an operation that only writes its output
  (``fill_``, ``zero_``, ``copy_``'s destination) does not read it.
* **collectives** — from the mesh's counters
  (``core.mesh.LogicalMesh.coll_bytes``), not from the operations: the
  copies and adds that carry a collective on one device are tallied in
  ``bytes_by_op`` under the collective's name and do no flops.  Wire
  bytes use the reference's ring model (:func:`wire_factor`) with ``g``
  the group the call ran over.

**Attribution.**  Each operation belongs to the rank whose work issues
it: :func:`repro_torch.core.mesh.current_rank` where the step says so
(``LogicalMesh.on``, a transfer's receiver), else the rank that made the
storages it reads (the backward, which autograd runs outside any rank's
scope, reads the activations its rank's forward made) when they all
come from one rank (in the backward, inputs made outside every rank do
not count: they are the gradients that crossed the ranks' sum).  An
operation with neither (the optimizer's step
count, the sum of the ranks' loss terms and the seed of its gradient,
the caller's concatenation of the ranks' logits) is counted in
``outside`` and added to every rank's figure, as every device of the
reference runs it.

**Memory.**  Every storage an operation creates on the ``meta`` device is
charged to its rank from its creation until it is freed (a weakref
finalizer on the storage): ``peak_bytes[r]`` is rank ``r``'s largest
live total during the counted region, above the storages that existed
before it (the arguments).  This is a model: no allocator, caching,
fragmentation or stream reuse is modelled.

**Speed.**  On ``meta`` tensors an aten operation's output metadata is a
function of its inputs' metadata and its other arguments, so
:class:`OpCounter` computes it once per distinct call and makes later
outputs with ``empty_strided`` (operations that return a fresh tensor),
or returns ``self`` (in-place operations), instead of running the meta
kernel again: the same program, counted the same, many times faster.
Views and everything else run as they are.

**What the FLOPs are of.**  The kernel entry points route by
``t.is_cuda`` (``kernels/ops.py``), so on ``meta`` tensors the plain
versions of ``kernels/ref.py`` run and their operations are the ones
counted (the plain attention's key-tile loop, for one), as the
reference's CPU-compiled HLO counts its jnp path.  The records say so
(``"flops_of": "plain"``).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.mesh import current_collective, current_rank

__all__ = ["COLLECTIVE_KINDS", "KIND_OF", "Cost", "OpCounter",
           "wire_factor", "collective_cost"]

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# the mesh's collectives by their HLO names
KIND_OF = {"psum": "all-reduce", "all_gather": "all-gather",
           "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
           "ppermute": "collective-permute"}

# the reference's _ELEMENTWISE opcodes by their aten names (in-place and
# out= forms share the name)
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "pow", "maximum", "minimum", "max",
    "min", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not", "neg", "abs",
    "sign", "eq", "ne", "lt", "le", "gt", "ge", "where", "masked_fill",
    "exp", "expm1", "log", "log1p", "tanh", "sigmoid", "sqrt", "rsqrt",
    "sin", "cos", "tan", "atan2", "floor", "ceil", "round", "trunc",
    "clamp", "clamp_min", "clamp_max", "remainder", "fmod",
    "__lshift__", "__rshift__", "bitwise_left_shift", "bitwise_right_shift",
    "isfinite", "erf", "reciprocal", "square", "exp2", "log2", "softplus",
    "relu",
}

# aten operations that XLA writes as several HLO ops: flops an element
_COMPOUND = {
    "silu": 2, "silu_backward": 4, "gelu": 8, "gelu_backward": 12,
    "sigmoid_backward": 3, "tanh_backward": 3, "threshold_backward": 1,
    "_softmax": 5, "_log_softmax": 5, "_softmax_backward_data": 4,
    "_log_softmax_backward_data": 4, "logsumexp": 4, "addcmul": 2,
    "addcdiv": 2, "lerp": 3, "hardtanh_backward": 2,
}

_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "prod", "argmax", "argmin", "any",
    "all", "norm", "linalg_vector_norm", "var", "std", "var_mean", "cumsum",
    "cumprod", "logcumsumexp",
}

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot",
           "addmv", "convolution"}

# operations that move no bytes (the reference's _NO_BYTES): allocation,
# metadata and aliasing; views are recognised from their schemas
_NO_BYTES = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "set_",
    "resize_", "_local_scalar_dense", "record_stream", "_unsafe_view",
}

# in-place operations that only write ``self``
_WRITE_ONLY = {"fill_", "zero_", "normal_", "uniform_", "random_",
               "bernoulli_", "exponential_", "copy_"}


def wire_factor(kind: str, g: int) -> float:
    """The reference's ring model (``hlo_cost._wire_factor``)."""
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (g - 1) / g
    return 1.0  # collective-permute


@dataclasses.dataclass
class Cost:
    """The reference's ``hlo_cost.Cost``: one device's FLOPs, bytes and
    collectives.  ``vmem_bytes`` is always 0: nothing of the port is
    VMEM-resident."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    coll_wire_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    coll_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    vmem_bytes: float = 0.0

    def _tally(self, op: str, nbytes: float) -> None:
        self.bytes += nbytes
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + nbytes

    def add(self, other: "Cost") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        self.vmem_bytes += other.vmem_bytes
        for k, v in other.bytes_by_op.items():
            self.bytes_by_op[k] = self.bytes_by_op.get(k, 0.0) + v
        for k in COLLECTIVE_KINDS:
            self.coll_bytes[k] += other.coll_bytes[k]
            self.coll_wire_bytes[k] += other.coll_wire_bytes[k]
            self.coll_counts[k] += other.coll_counts[k]

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.coll_wire_bytes.values())


def collective_cost(mesh) -> List[Cost]:
    """Every rank's collective counts, operand bytes and ring-model wire
    bytes from ``mesh``'s counters (since its last ``reset_counts``)."""
    out = [Cost() for _ in range(mesh.size)]
    for name, kind in KIND_OF.items():
        for r in range(mesh.size):
            out[r].coll_counts[kind] = float(mesh.coll_calls[name][r])
            out[r].coll_bytes[kind] = float(mesh.coll_bytes[name][r])
    for (name, g), per in mesh.coll_group_bytes.items():
        kind = KIND_OF[name]
        for r, b in enumerate(per):
            out[r].coll_wire_bytes[kind] += b * wire_factor(kind, g)
    return out


# ---------------------------------------------------------------------------
# the dispatch mode
# ---------------------------------------------------------------------------
def _tensors(xs, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors in the sequence ``xs`` (nested sequences too)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


def _sig(xs) -> tuple:
    """A hashable stand-in for the sequence ``xs``: a (``meta``) tensor's
    dtype, shape and strides, a nested sequence's stand-in, else the value
    with its type (``2`` and ``2.0`` promote differently)."""
    return tuple((x.dtype, x.shape, x.stride())
                 if isinstance(x, torch.Tensor) else
                 _sig(x) if isinstance(x, (list, tuple)) else (type(x), x)
                 for x in xs)


_FRESH, _SELF, _RUN = 0, 1, 2


def _kind(func) -> int:
    """How an operation's outputs relate to its arguments: all fresh
    tensors, ``self`` written in place and returned, or anything else
    (views, ``out=``, non-tensor results), which always runs."""
    schema = func._schema
    rets = schema.returns
    if not rets or schema.is_mutable and not func._overloadpacket.__name__ \
            .endswith("_"):
        return _RUN
    if any(str(r.type) not in ("Tensor", "List[Tensor]") for r in rets):
        return _RUN
    if all(r.alias_info is None for r in rets):
        return _RUN if schema.is_mutable else _FRESH
    if len(rets) == 1 and rets[0].alias_info.is_write and schema.arguments \
            and schema.arguments[0].alias_info is not None \
            and schema.arguments[0].alias_info.is_write:
        return _SELF
    return _RUN


def _views(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class OpCounter(TorchDispatchMode):
    """Counts every aten operation run under it, per rank of a mesh of
    ``n_ranks`` (see the module's note): ``costs[r]`` and ``outside`` are
    :class:`Cost` (FLOPs and bytes only; :func:`collective_cost` gives the
    collectives), ``peak_bytes[r]`` the largest bytes rank ``r``'s new
    storages held at once, ``n_ops`` the operations counted.  ``adopt``
    tells it which rank holds each argument before the step runs."""

    def __init__(self, n_ranks: int) -> None:
        super().__init__()
        self.n = n_ranks
        self.costs = [Cost() for _ in range(n_ranks)]
        self.outside = Cost()
        self.live = [0] * (n_ranks + 1)       # the last slot: outside
        self.peak_bytes = [0] * (n_ranks + 1)
        self.n_ops = 0
        self._owner: Dict[int, int] = {}      # storage -> rank
        self._kinds: Dict[Any, int] = {}
        self._cache: Dict[Any, Any] = {}

    # -- storages -------------------------------------------------------------
    def adopt(self, rank: int, tensors: Sequence[torch.Tensor]) -> None:
        """Rank ``rank`` holds ``tensors`` (arguments: not charged)."""
        for t in tensors:
            self._owner.setdefault(t.untyped_storage()._cdata, rank)

    def _free(self, key: int, slot: int, nbytes: int) -> None:
        self._owner.pop(key, None)
        self.live[slot] -= nbytes

    def _charge(self, outs: List[torch.Tensor], slot: int) -> None:
        rank = slot if slot < self.n else -1
        for t in outs:
            if not t.is_meta:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._owner:
                continue
            self._owner[key] = rank
            nb = st.nbytes()
            self.live[slot] += nb
            if self.live[slot] > self.peak_bytes[slot]:
                self.peak_bytes[slot] = self.live[slot]
            weakref.finalize(st, self._free, key, slot, nb)

    def _rank_of(self, ins: List[torch.Tensor]) -> Optional[int]:
        r = current_rank()
        if r is not None:
            return r
        # in the backward, an input made outside any rank (a gradient that
        # left the rank's scope) does not decide; in the forward it does
        backward = torch._C._current_autograd_node() is not None
        owner = self._owner
        found = None
        for t in ins:
            if t.is_meta:
                q = owner.get(t.untyped_storage()._cdata)
                if q is None or q < 0 and backward:
                    continue
                if q < 0 or found is not None and q != found:
                    return None                 # across ranks: outside
                found = q
        return found

    # -- running --------------------------------------------------------------
    def _run(self, func, kind, ins, args, kwargs):
        if kind == _RUN or not all(t.is_meta for t in ins):
            return func(*args, **kwargs)
        key = (func, _sig(args), _sig(sorted(kwargs.items()))
               if kwargs else None)
        hit = self._cache.get(key)
        if hit is not None:
            return args[0] if kind == _SELF else _make(hit)
        out = func(*args, **kwargs)
        if all(t.is_meta for t in _outs(out)):
            self._cache[key] = True if kind == _SELF else _meta_of(out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._kinds.get(func)
        if info is None:
            info = self._kinds[func] = (
                _kind(func), _views(func), func._overloadpacket.__name__)
        kind, views, name = info
        ins = _tensors(args, _tensors(
            [v for k, v in kwargs.items() if k != "out"], [])
            if kwargs else [])
        out = self._run(func, kind, ins, args, kwargs)
        outs = _outs(out)
        r = self._rank_of(ins)
        slot = self.n if r is None else r
        cost = self.outside if r is None else self.costs[r]
        self.n_ops += 1
        if views:
            return out
        self._charge(outs, slot)
        if name in _NO_BYTES:
            return out
        if name in _WRITE_ONLY and ins:
            ins = ins[1:]
        nb = sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
        coll = current_collective()
        if coll is not None:
            cost._tally(KIND_OF[coll], nb)
            return out
        cost._tally(name, nb)
        cost.flops += _flops(name, ins, outs)
        return out


def _outs(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    return _tensors(out, []) if isinstance(out, (list, tuple)) else []


def _meta_of(out):
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype)
    return [_meta_of(t) for t in out]


def _make(meta):
    if isinstance(meta, tuple):
        shape, stride, dtype = meta
        return torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    return [_make(m) for m in meta]


def _flops(name: str, ins: List[torch.Tensor],
           outs: List[torch.Tensor]) -> float:
    base = name.rstrip("_")
    if name.startswith("_foreach_"):
        base = name[len("_foreach_"):].rstrip("_")
    if base in _MATMUL:
        out_elems = sum(t.numel() for t in outs)
        if base == "convolution":
            w = ins[1]
            return 2.0 * out_elems * (w.numel() // max(w.shape[0], 1))
        a = ins[1] if base in ("addmm", "baddbmm", "addbmm", "addmv") \
            else ins[0]
        return 2.0 * out_elems * a.shape[-1]
    if base in ("max", "min") and len(ins) == 1:
        return float(ins[0].numel())        # the reductions of that name
    if base in _ELEMENTWISE:
        return float(sum(t.numel() for t in outs))
    if base in _COMPOUND:
        return float(_COMPOUND[base] * sum(t.numel() for t in outs))
    if base in _REDUCTIONS:
        return float(ins[0].numel()) if ins else 0.0
    return 0.0
