"""Multi-host (multi-process) scale-out.

Counterpart of ``flink_parameter_server_tpu/parallel/multihost.py``.  The
reference system scales out by adding TaskManagers; the JAX package by one
process per host under ``jax.distributed``.  The port runs one process per
device under ``torch.distributed``, and the same named-axis code spans
hosts: every path addresses ranks by mesh axis, not by host.

Axis-layout rule, kept from the reference: the ``ps`` axis is laid out
inside a host, so pulls and pushes ride the host's links (NVLink), and
``dp`` across hosts, so only the microbatch's delta exchange crosses the
network.  Launchers number ranks host-major (torchrun: ``node_rank *
nproc_per_node + local_rank``), so a row-major ``(dp, ps)`` mesh keeps a
``ps`` row inside one host iff ``ps`` divides the ranks per host.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import DP_AXIS, PS_AXIS, make_mesh

# the variables a launcher (torchrun) sets for every rank
_LAUNCH_ENV = ("RANK", "WORLD_SIZE")


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device_type: str = "cuda",
    timeout_s: Optional[float] = None,
) -> bool:
    """Bring up the default process group (idempotent); returns True if a
    group is up afterwards.

    With explicit arguments (``init_method`` such as
    ``tcp://host:port``, ``world_size``, ``rank``) it always initialises.
    With none it initialises from the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) when the launcher
    set it, and is a no-op in a plain single process; deciding reads only
    ``os.environ``.  A ``cuda`` rank takes the card ``LOCAL_RANK`` names,
    else ``rank % device_count``.  ``backend`` defaults to NCCL for
    ``cuda`` and gloo for ``cpu``; gloo on ``cuda`` tensors is a valid
    choice (it stages them through the host)."""
    if dist.is_initialized():
        return True
    explicit = init_method is not None or world_size is not None or rank is not None
    if not explicit and not all(os.environ.get(k) for k in _LAUNCH_ENV):
        return False
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if device_type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else rank % torch.cuda.device_count())
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank, **kwargs
    )
    return True


def make_multihost_mesh(
    *,
    dp: Optional[int] = None,
    ps: int = 1,
    ranks: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
    axis_names: Tuple[str, str] = (DP_AXIS, PS_AXIS),
):
    """Global mesh over every rank with the host-aware layout: ``ps``
    within hosts, ``dp`` across them.

    ``ranks`` (global ranks in row-major ``(dp, ps)`` order) places them
    explicitly and skips the layout check, as the reference's ``devices=``
    does.  The ranks a host holds are the launcher's ``LOCAL_WORLD_SIZE``,
    else the whole world (one host)."""
    from torch.distributed.device_mesh import DeviceMesh

    initialize(device_type=device_type)
    n = dist.get_world_size()
    if dp is None:
        if n % ps:
            raise ValueError(f"{n} ranks do not split into ps={ps}")
        dp = n // ps
    if dp * ps != n:
        raise ValueError(f"dp({dp}) * ps({ps}) != world size ({n})")
    if ranks is not None:
        grid = torch.tensor(list(ranks), dtype=torch.int).reshape(dp, ps)
        return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE") or n)
    if per_host % ps and per_host != n:
        raise ValueError(
            f"ps axis ({ps}) must divide the ranks per host ({per_host}) so "
            f"parameter-shard rows stay inside one host and pulls stay off "
            f"the network"
        )
    return make_mesh(dp, ps, device_type=device_type, axis_names=axis_names)


def process_local_batch_slice(global_batch: int) -> slice:
    """Which rows of a global batch this process loads: each process feeds
    only its own share (the ingestion edge stays local, like the reference
    system's per-TaskManager source splits).  A plain process loads all."""
    p = dist.get_rank() if dist.is_initialized() else 0
    n = dist.get_world_size() if dist.is_initialized() else 1
    per = global_batch // n
    if per * n != global_batch:
        raise ValueError(f"global batch {global_batch} does not split over {n} processes")
    return slice(p * per, (p + 1) * per)


__all__ = [
    "initialize",
    "make_multihost_mesh",
    "process_local_batch_slice",
]
