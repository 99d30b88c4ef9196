"""Mesh construction for local logical meshes — the port of
``repro/launch/mesh.py``.

The reference builds jax device meshes; here a mesh is a
:class:`~repro_torch.core.mesh.LogicalMesh`, logical ranks on one device,
each with its own CUDA stream.  The reference's production mesh is a TPU
pod (256 or 512 chips) and has no counterpart on one card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..core.mesh import LogicalMesh

__all__ = ["make_mesh", "local_mesh", "dp_axes", "tp_axis", "axis_size"]


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
