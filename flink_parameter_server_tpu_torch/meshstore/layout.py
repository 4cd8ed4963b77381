"""Layout for the device-mesh store backend, on one device.

Counterpart of ``flink_parameter_server_tpu/meshstore/layout.py``.  The
reference lays the whole parameter table out as ONE global array
``jax.NamedSharding(mesh, P("shard"))`` over a 1-D device mesh: row
blocks of ``mesh_row_block`` rows per device, exactly the split
:meth:`~..core.store.StoreSpec.rows_per_shard` computes (ceil, rounded
to the 8-row window).  The port's mesh store is single-device: the "mesh" is
:class:`StoreLayout`, one device holding the one row block
(``n_devices == 1``), and a ``devices`` or ``mesh`` argument naming more
than one device raises (:func:`~..utils.device.reject_mesh`, ROADMAP
Queue 1 #9).  The block arithmetic stays parametrised by ``n_devices``,
so the alignment rule reads the same as the reference's.  The helpers
here pin the two layout contracts everything else in :mod:`..meshstore`
assumes:

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
from ..utils.device import DeviceLike, reject_mesh, resolve_device

SHARD_AXIS = "shard"


class MisalignedTable(ValueError):
    """A partitioner whose shard boundaries do not land on mesh
    row-block multiples — the silent-resharding hazard, made loud."""


@dataclasses.dataclass(frozen=True)
class StoreLayout:
    """The single-device stand-in for the reference's 1-D store mesh:
    one device, one row block, the canonical axis name."""

    device: torch.device
    axis_names: Tuple[str, ...] = (SHARD_AXIS,)

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: 1}

    @property
    def n_devices(self) -> int:
        return 1


def make_store_mesh(
    devices: Optional[Sequence] = None, *, device: DeviceLike = None
) -> StoreLayout:
    """The store layout over ``devices`` (default: ``device``, the card
    unless the caller asks for the CPU).  More than one device raises
    through :func:`~..utils.device.reject_mesh` (ROADMAP Queue 1 #9)."""
    if devices is not None:
        devs = list(devices)
        if not devs:
            raise ValueError("make_store_mesh: no devices")
        if len(devs) > 1:
            reject_mesh(devs, "the mesh store over several devices")
        device = devs[0]
    return StoreLayout(resolve_device(device))


def table_sharding(mesh: StoreLayout, value_shape: Sequence[int] = ()):
    """Where the table lives: the layout's one device (rows and value
    lanes together; the reference's ``P("shard", None...)`` over one
    device)."""
    return mesh.device


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
