"""CollectiveOptions — one coherent keyword spec for collective tuning.

One frozen dataclass names every tuning knob of the collective stack
once; it is accepted as ``options=`` by every entry point of the stack —
:class:`repro_torch.core.collectives.Collectives` (constructor and the seven
collectives), :func:`repro_torch.core.lowering.allreduce` /
:func:`~repro_torch.core.lowering.lower_allreduce`, and
:func:`repro_torch.core.overlap.sync_grads`.  The host Collectives'
``hierarchy=`` (constructor) stays as a shim for ``hierarchical=`` that
raises :class:`DeprecationWarning`; the Level-B entry points take only the
canonical names.

Canonical spellings (each knob means the same thing at every layer):

========================  ====================================================
``algorithm``             wire schedule (``"ring"``/``"doubling"``/
                          ``"native"``/``"auto"``; ``None`` = per-op default)
``segments``              ring pipelining factor (``> 1`` overlaps combine of
                          segment *k* with transport of segment *k+1*)
``hierarchical``          pod/intra size of the composed two-tier allreduce
                          (host tiers: consecutive-rank pod size; Level-B
                          grad sync: truthy selects the two-axis schedule,
                          the axes carry the sizes)
``stage_impl``            fused between-round stage tier (``"cuda"`` = the
                          hand-written kernels, ``"ref"`` = their plain
                          PyTorch versions; ``None`` = the plain add)
``stage_wire``            ring *transport* dtype per round (``"bf16"``/
                          ``"int8"``; needs ``stage_impl``)
``reduce_dtype``          dtype policy a gradient leaf is *presented* to the
                          collective in (``"fp32"``/``"leaf"``; grad sync
                          only)
========================  ====================================================
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, List, Optional

__all__ = ["CollectiveOptions", "renamed_kwarg"]


def renamed_kwarg(old: str, old_value: Any, new: str,
                  new_value: Any) -> Any:
    """Back-compat shim for a renamed keyword.

    Returns the effective value: the old spelling (with a
    ``DeprecationWarning``) when given, else the new one.  Passing both
    spellings with different values is a :class:`TypeError` — silently
    preferring either would mask a caller bug.
    """
    if old_value is None:
        return new_value
    warnings.warn(
        f"{old}= is deprecated; spell it {new}= (see "
        f"repro_torch.core.options.CollectiveOptions)",
        DeprecationWarning, stacklevel=3)
    if new_value is not None and new_value != old_value:
        raise TypeError(f"both {old}= (deprecated) and {new}= given with "
                        f"different values: {old_value!r} vs {new_value!r}")
    return old_value


@dataclasses.dataclass(frozen=True)
class CollectiveOptions:
    """The consolidated collective tuning spec (see module docstring).

    Pass an instance as ``options=`` to any entry point of the stack;
    explicit keyword arguments override the corresponding field.  Fields
    a given entry point cannot honour must be left at their defaults —
    a set-but-unconsumable field is a :class:`ValueError`, never a
    silent drop (a dropped ``segments=4`` would fake pipelining).
    """

    algorithm: Optional[str] = None
    segments: int = 1
    hierarchical: Optional[int] = None
    stage_impl: Optional[str] = None
    stage_wire: Optional[str] = None
    reduce_dtype: Optional[str] = None

    def take(self, **explicit: Any) -> List[Any]:
        """Merge ``explicit`` keyword values over this spec.

        Returns the effective values in keyword order; an explicit
        ``None`` (or, for ``segments``, the default ``1``) defers to the
        field.  Fields set to non-default here but NOT consumed by the
        caller raise — the entry point cannot honour them.
        """
        out = []
        for name, val in explicit.items():
            field_val = getattr(self, name)
            if name == "segments":
                out.append(field_val if val in (None, 1) else val)
            else:
                out.append(field_val if val is None else val)
        leftovers = [
            f.name for f in dataclasses.fields(self)
            if f.name not in explicit
            and getattr(self, f.name) != f.default]
        if leftovers:
            raise ValueError(
                f"CollectiveOptions field(s) {leftovers} are not "
                f"applicable to this entry point (consumable here: "
                f"{sorted(explicit)})")
        return out

    @staticmethod
    def merge(options: Optional["CollectiveOptions"],
              **explicit: Any) -> List[Any]:
        """:meth:`take` on ``options`` (or a default spec when None)."""
        return (options or CollectiveOptions()).take(**explicit)
