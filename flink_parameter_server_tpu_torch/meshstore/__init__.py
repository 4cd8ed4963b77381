"""meshstore/ — the device store backend.

Counterpart of ``flink_parameter_server_tpu/meshstore/``.
``ClusterConfig(store_backend="mesh")`` swaps the socket-fronted shard
topology for ONE table held as row blocks on the devices of a layout:
pulls are device gathers, pushes masked scatter-adds in place — no socket,
no frame, no host copy in the inner loop.  The SSP/async/BSP clock, the
workload contract, WAL durability and the telemetry plane all keep their
existing semantics; only the transport under ``pull_batch``/``push_batch``
changes.  The reference shards the table over a device mesh from one
process; the port's layout is a device list (``layout.py``), driven from
one process too.
"""
from .client import MeshClient
from .layout import (
    SHARD_AXIS,
    MisalignedTable,
    StoreLayout,
    aligned_partitioner,
    check_alignment,
    make_store_mesh,
    table_sharding,
)
from .store import MeshParamStore

__all__ = [
    "SHARD_AXIS",
    "MisalignedTable",
    "MeshClient",
    "MeshParamStore",
    "StoreLayout",
    "aligned_partitioner",
    "check_alignment",
    "make_store_mesh",
    "table_sharding",
]
