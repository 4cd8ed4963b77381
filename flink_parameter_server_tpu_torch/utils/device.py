"""Device selection shared by the port's entry points.

The port runs on the card unless the caller asks for the CPU: every
entry point takes a ``device`` argument whose default is ``"cuda"``.
Asking for ``cuda`` on a machine without a card raises — nothing drops
to the CPU quietly.  The parameter server's paths take a ``dp × ps``
``DeviceMesh`` (:mod:`..parallel.mesh`) whose device type matches the
device (:func:`check_mesh`); the dense LM takes a mesh with a ``dp`` axis
and its model-parallel axes (``models/transformer.check_lm_mesh``).
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain CPU path"
        )
    return dev


def check_mesh(mesh: Optional[Any], device: DeviceLike = None, *, ps_axis: str = "ps") -> None:
    """Accept ``None`` or a torch ``DeviceMesh`` with a ``ps_axis`` axis
    whose device type matches ``device`` (when given).  Any other mesh (a
    JAX mesh, a mesh without the ``ps`` axis) raises: the parameter
    server's tables are row-blocked over ``ps`` (ROADMAP Queue 1 #9 ported
    that layout; the model-parallel axes are the LM's)."""
    if mesh is None:
        return
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or ps_axis not in (mesh.mesh_dim_names or ()):
        raise NotImplementedError(
            f"the torch port's meshes are torch DeviceMeshes with a {ps_axis!r} "
            f"axis (parallel.mesh.make_mesh), got {type(mesh).__name__}; the table's "
            f"layout is the ps row blocks of ROADMAP Queue 1 #9"
        )
    if device is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(
            f"device {device} does not match the mesh's device type {mesh.device_type!r}"
        )


def mesh_resolve_device(mesh: Optional[Any], device: DeviceLike = None) -> torch.device:
    """``device`` for an entry point that takes a mesh: with a mesh and no
    device, this rank's device on it; otherwise :func:`resolve_device`,
    checked against the mesh."""
    check_mesh(mesh, device)
    if mesh is not None and device is None:
        from ..parallel.mesh import mesh_device

        return mesh_device(mesh)
    return resolve_device(device)


__all__ = ["DeviceLike", "resolve_device", "check_mesh", "mesh_resolve_device"]
