"""cluster/ — the multi-shard parameter-server runtime.

Counterpart of ``flink_parameter_server_tpu/cluster/``: several PS
shards holding key-partitioned state (:mod:`.shard`, each slice a tensor
on the device, or a host array in a shard process), workers exchanging
asynchronous pull/push messages against them over TCP (:mod:`.client`),
deterministic key→shard maps (:mod:`.partition`), and a bounded-staleness
clock spanning BSP → SSP → fully-async (:mod:`.clock`).
:class:`~.driver.ClusterDriver` wires a topology around any
:class:`~..core.batched.BatchedWorkerLogic` and trains the same jobs the
single-process :class:`~..training.driver.StreamingDriver` runs, with
the workers' steps on the device.
"""
from .client import ClusterClient, ShardConnection
from .clock import StalenessClock
from .driver import ClusterConfig, ClusterDriver, ClusterResult
from .partition import (
    ConsistentHashPartitioner,
    Partitioner,
    RangePartitioner,
)
from .procs import RemoteShardStub, ShardProcess, ShardProcSpec
from .shard import (
    FollowerLagging,
    FrozenKeys,
    NotPrimary,
    ParamShard,
    ShardCrashed,
    ShardServer,
    StaleEpoch,
)

__all__ = [
    "ClusterClient",
    "ClusterConfig",
    "ClusterDriver",
    "ClusterResult",
    "ConsistentHashPartitioner",
    "FollowerLagging",
    "FrozenKeys",
    "NotPrimary",
    "ParamShard",
    "Partitioner",
    "RangePartitioner",
    "RemoteShardStub",
    "ShardConnection",
    "ShardProcSpec",
    "ShardProcess",
    "ShardCrashed",
    "ShardServer",
    "StaleEpoch",
    "StalenessClock",
]
