"""The current mesh, so model code can take its sharded path.

Port of ``repro/distributed/mesh_utils.py``. The launcher (``train()``,
``Engine``) sets the active mesh with ``use_mesh``; layers that split
their work (tensor-parallel projections, the vocab-parallel embedding and
loss, the MoE dispatches) read it with ``get_mesh``.
Without an active mesh every layer takes its local path, which is what the
single-device tests run. A mesh is a ``launch.mesh.Mesh`` or anything with
a ``shape`` mapping of axis name to size.
"""
from __future__ import annotations

import contextlib
from typing import Optional

__all__ = ["dp_axes", "get_mesh", "has_axis", "use_mesh"]

_CURRENT: list = [None]


def get_mesh():
    """The active mesh, or None."""
    return _CURRENT[0]


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (or None: no mesh) the active one inside the block."""
    prev = _CURRENT[0]
    _CURRENT[0] = mesh
    try:
        yield mesh
    finally:
        _CURRENT[0] = prev


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of ``mesh`` that exist, outermost first."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def has_axis(mesh: Optional[object], name: str) -> bool:
    return mesh is not None and name in mesh.shape
