"""Device-mesh construction for the parameter server.

Counterpart of ``flink_parameter_server_tpu/parallel/mesh.py``.  The
reference system's two parallelism knobs map onto named mesh axes:

  * ``workerParallelism`` → the ``dp`` axis: each microbatch is split
    across it in contiguous slices, one a worker.
  * ``psParallelism``     → the ``ps`` axis: the parameter table is
    row-blocked across it.

The dense LM's data parallelism takes a 1-D ``("dp",)`` mesh
(:func:`make_dp_mesh`), the layout of the reference's ZeRO-1 and FSDP
tests, or the ``(dp, ps)`` one with ``ps`` 1.  Expert parallelism takes
the reference's ``("dp", "ep")`` mesh: ``make_mesh(dp, ep,
axis_names=("dp", "ep"))``, or ``single_device_mesh(axis_names=("dp",
"ep"))`` for one rank; the second axis is named, the layout is the same.
Tensor, sequence and pipeline parallelism take meshes of any number of
axes (the reference's ``("dp", "sp")``, ``("dp", "pp")``, ``("dp", "sp",
"tp")``, ``("dp", "pp", "sp")``): :func:`make_nd_mesh`, whose rank ``r``
sits at the row-major coordinates of ``r``, as
``np.array(devices).reshape(shape)`` lays the reference's devices out.

The reference drives every device from one process through ``shard_map``.
The port runs one process per device, as PyTorch does on several cards:
the mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, row-major ``(dp, ps)``, so global rank
``d * ps + p`` sits at ``(d, p)``.  Each rank runs what ``shard_map``'s
body runs; :func:`axis_index` plays ``axis_index`` and the collectives of
:mod:`.collectives` run on :func:`axis_group`.  The group's backend is NCCL
for ``cuda`` meshes and gloo for ``cpu`` ones (:mod:`.multihost`).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"
PS_AXIS = "ps"


def axis_size(mesh: Any, axis: str) -> int:
    """Size of the named axis; 1 without a mesh or without that axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh: Any, axis: str) -> int:
    """This rank's coordinate on the named axis (``lax.axis_index``); 0
    without a mesh or without that axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return int(mesh.get_local_rank(axis))


def axis_group(mesh: Any, axis: str):
    """The process group of this rank's line along the named axis."""
    return mesh.get_group(axis)


def require_axis(mesh: Any, axis: str, what: str) -> None:
    """Raise ``ValueError`` naming ``axis`` unless ``mesh`` has it (the
    reference's ``dp_axis=... not in mesh axes`` refusal)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        raise ValueError(f"{what}: dp_axis={axis!r} not in mesh axes {names}")


def mesh_device(mesh: Any) -> torch.device:
    """The device this rank's tensors live on: the current card of a
    ``cuda`` mesh, the CPU for a ``cpu`` one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(
    worker_parallelism: Optional[int] = None,
    ps_parallelism: Optional[int] = None,
    *,
    device_type: str = "cuda",
    axis_names: Tuple[str, str] = (DP_AXIS, PS_AXIS),
):
    """A ``dp × ps`` mesh over every rank of the default process group
    (``axis_names`` renames the two axes: ``("dp", "ep")`` is the expert
    parallel mesh, global rank ``d * ep + e`` at ``(d, e)``).

    Defaults as the reference's: every rank is used; if only one degree is
    given the other takes the rest; if neither, all ranks go to ``dp``.
    The group comes up from a launcher's environment if it is not up yet
    (:func:`.multihost.initialize`); without one, this raises."""
    from .multihost import initialize

    initialize(device_type=device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: launch with torchrun, or call "
            "parallel.multihost.initialize(init_method, world_size, rank) first "
            "(single_device_mesh() makes the 1 x 1 mesh in a plain process)"
        )
    n = dist.get_world_size()
    dp, ps = worker_parallelism, ps_parallelism
    if dp is None and ps is None:
        dp, ps = n, 1
    elif dp is None:
        if n % ps:
            raise ValueError(f"{n} ranks do not split into ps={ps}")
        dp = n // ps
    elif ps is None:
        if n % dp:
            raise ValueError(f"{n} ranks do not split into dp={dp}")
        ps = n // dp
    if dp * ps != n:
        raise ValueError(
            f"worker_parallelism({dp}) * ps_parallelism({ps}) != world size ({n})"
        )
    return make_nd_mesh((dp, ps), axis_names, device_type=device_type)


def make_nd_mesh(shape: Sequence[int], axis_names: Sequence[str], *, device_type: str = "cuda"):
    """A mesh of ``len(shape)`` named axes over every rank of the default
    process group (the product of ``shape`` must be the world size):
    global rank ``r`` sits at the row-major coordinates of ``r`` in
    ``shape``, the layout of the reference's ``Mesh(np.array(devices)
    .reshape(shape), axis_names)``.  :func:`axis_size`, :func:`axis_index`
    and :func:`axis_group` work on every axis.  The group comes up as
    :func:`make_mesh`'s does."""
    from torch.distributed.device_mesh import init_device_mesh

    from .multihost import initialize

    shape, axis_names = tuple(int(k) for k in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
        raise ValueError(f"make_nd_mesh: shape {shape} needs as many distinct axis names, got {axis_names}")
    initialize(device_type=device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_nd_mesh needs a process group: launch with torchrun, or call "
            "parallel.multihost.initialize(init_method, world_size, rank) first"
        )
    n = dist.get_world_size()
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not hold the world size ({n})")
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def make_dp_mesh(dp: Optional[int] = None, *, device_type: str = "cuda"):
    """The 1-D data-parallel mesh ``("dp",)`` over every rank of the
    default process group (``dp``, when given, must be the world size):
    the reference's ``Mesh(devices, ("dp",))``.  The group comes up as
    :func:`make_mesh`'s does."""
    from .multihost import initialize

    initialize(device_type=device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_dp_mesh needs a process group: launch with torchrun, or call "
            "parallel.multihost.initialize(init_method, world_size, rank) first"
        )
    n = dist.get_world_size()
    if dp is not None and dp != n:
        raise ValueError(f"dp={dp} != world size ({n})")
    return make_nd_mesh((n,), (DP_AXIS,), device_type=device_type)


def single_device_mesh(
    *, device_type: str = "cuda", axis_names: Sequence[str] = (DP_AXIS, PS_AXIS)
):
    """The one-rank mesh with ``axis_names`` (each of size 1; two by
    default: the 1 × 1 mesh).  In a plain process it brings up a one-rank
    group first, over an in-memory store (NCCL for ``cuda``, gloo for
    ``cpu``)."""
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device())
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    if dist.get_world_size() != 1:
        raise ValueError(
            f"single_device_mesh needs a world of one rank, not {dist.get_world_size()}"
        )
    return make_nd_mesh((1,) * len(axis_names), axis_names, device_type=device_type)


__all__ = [
    "DP_AXIS",
    "PS_AXIS",
    "axis_group",
    "axis_index",
    "axis_size",
    "make_dp_mesh",
    "make_mesh",
    "make_nd_mesh",
    "mesh_device",
    "require_axis",
    "single_device_mesh",
]
