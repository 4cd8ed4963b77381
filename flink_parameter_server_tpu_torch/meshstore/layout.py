"""Layout for the device-mesh store backend: n row blocks over devices.

Counterpart of ``flink_parameter_server_tpu/meshstore/layout.py``.  The
reference lays the whole parameter table out as ONE global array
``jax.NamedSharding(mesh, P("shard"))`` over a 1-D device mesh: row
blocks of ``mesh_row_block`` rows per device, exactly the split
:meth:`~..core.store.StoreSpec.rows_per_shard` computes (ceil, rounded
to the 8-row window).  The reference is single-controller (one process
drives every device), and so is the port's mesh store: the "mesh" is a
:class:`StoreLayout`, a list of ``n`` devices, and block ``i`` (rows
``[i·R, (i+1)·R)``, ``R = mesh_row_block(capacity, n)``) lives on
``devices[i]`` as its own tensor, all driven from the one process.

**The same device may appear more than once.**  That is the port's
counterpart of the reference's device list, not a feature of its own: the
reference's CPU tests run on 8 virtual devices
(``--xla_force_host_platform_device_count=8``), the port's on ``8 ×
"cpu"``; one card is ``n × cuda:0``; a host with n cards is
``cuda:0 .. cuda:n-1``.  A block plays the part of a device everywhere
(per-device bytes are per-block bytes).  The helpers here pin the two
layout contracts everything else in :mod:`..meshstore` assumes:

* **one axis, one name** — ``SHARD_AXIS = "shard"``.  The table's only
  sharded dimension is dim 0 (rows); value lanes replicate.
* **partitioner ↔ mesh alignment** — a :class:`~..cluster.partition.
  RangePartitioner` deployed over this table must have every shard
  boundary on a row-block multiple (``block_aligned``), otherwise a
  logical shard straddles two devices' blocks and every pull pays a
  resharding gather.  :func:`check_alignment` makes the convention a
  checked precondition (at one device every boundary is aligned).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..cluster.partition import RangePartitioner, mesh_row_block
from ..utils.device import DeviceLike, resolve_device

SHARD_AXIS = "shard"


class MisalignedTable(ValueError):
    """A partitioner whose shard boundaries do not land on mesh
    row-block multiples — the silent-resharding hazard, made loud."""


@dataclasses.dataclass(frozen=True)
class StoreLayout:
    """The port's 1-D store mesh: block ``i`` of the table on
    ``devices[i]`` (devices may repeat), the canonical axis name.
    ``device`` is the first block's device, where pulls land."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (SHARD_AXIS,)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: len(self.devices)}

    @property
    def n_devices(self) -> int:
        return len(self.devices)


def make_store_mesh(
    devices: Optional[Sequence] = None, *, device: DeviceLike = None
) -> StoreLayout:
    """The store layout over ``devices``: one row block a list entry, in
    order (an entry may repeat).  Without ``devices``: ``device`` alone
    when given, else every visible card, as the reference takes every
    local device (``cuda`` must be present: nothing drops to the CPU)."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("make_store_mesh: no devices")
    elif device is not None:
        devs = [resolve_device(device)]
    else:
        resolve_device("cuda")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return StoreLayout(tuple(devs))


def table_sharding(mesh: StoreLayout, value_shape: Sequence[int] = ()) -> Tuple[torch.device, ...]:
    """Where the table lives: the device of each row block in block
    order (rows split over the layout, value lanes together; the
    reference's ``P("shard", None...)``)."""
    return mesh.devices


def aligned_partitioner(
    capacity: int, num_shards: int, n_devices: int, *, window: int = 8
) -> RangePartitioner:
    """A range partitioner whose shard boundaries are guaranteed mesh
    row-block multiples for a ``n_devices``-way mesh over
    ``capacity`` rows."""
    return RangePartitioner(capacity, num_shards).block_aligned(
        n_devices, window=window
    )


def check_alignment(
    partitioner, capacity: int, n_devices: int, *, window: int = 8
) -> None:
    """Raise :class:`MisalignedTable` unless every shard boundary of
    ``partitioner`` lands on a mesh row-block multiple.

    Accepts any partitioner exposing ``rows_per_shard`` (range maps);
    hash maps scatter ids across the whole table by construction, so
    they can never align — reject with the remedy in the message."""
    rows = getattr(partitioner, "rows_per_shard", None)
    if rows is None:
        raise MisalignedTable(
            f"{type(partitioner).__name__} cannot align to a device "
            f"mesh: the mesh table is row-block sharded, so the mesh "
            f"backend requires a RangePartitioner "
            f"(ClusterConfig.partition='range')"
        )
    block = mesh_row_block(capacity, n_devices, window=window)
    if int(rows) % block != 0:
        raise MisalignedTable(
            f"rows_per_shard={rows} is not a multiple of the "
            f"{block}-row mesh block ({n_devices} devices over "
            f"{capacity} rows): every pull would pay a resharding "
            f"gather.  Use RangePartitioner.block_aligned({n_devices})."
        )


__all__ = [
    "SHARD_AXIS",
    "MisalignedTable",
    "StoreLayout",
    "make_store_mesh",
    "table_sharding",
    "aligned_partitioner",
    "check_alignment",
]
