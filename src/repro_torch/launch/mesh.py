"""Mesh construction for the production pods and local logical meshes —
the port of ``repro/launch/mesh.py``.

The reference builds jax device meshes; here a mesh is a
:class:`~repro_torch.core.mesh.LogicalMesh`, logical ranks on one device,
each with its own CUDA stream on a card.  The reference's production mesh
is a TPU pod (256 or 512 chips); :func:`make_production_mesh` gives the
same shape and axes as logical ranks on the ``meta`` device, where the dry
run (``launch/dryrun.py``) places and steps a cell without memory.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..core.mesh import LogicalMesh

__all__ = ["make_production_mesh", "make_mesh", "local_mesh", "dp_axes",
           "tp_axis", "axis_size"]


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> LogicalMesh:
    """The assigned production mesh, as logical ranks.

    Single pod: (16, 16) over ("data", "model") — 256 ranks.
    Multi-pod:  (2, 16, 16) over ("pod", "data", "model") — 512 ranks.
    On ``meta`` (the default) no stream is made and nothing is allocated.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(shape, axes, device)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device=None) -> LogicalMesh:
    """A custom mesh (tests, manual data parallelism)."""
    return LogicalMesh(tuple(shape), tuple(axes), device)


def local_mesh(data: Optional[int] = None, model: int = 1,
               device=None) -> LogicalMesh:
    """A ("data", "model") mesh over the local device: one rank unless
    ``data`` or ``model`` asks for more logical ranks."""
    data = data if data is not None else 1
    return make_mesh((data, model), ("data", "model"), device)


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes carrying the batch (hierarchical DP: pod composes with data)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def tp_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    return mesh.axis_size(axes)
