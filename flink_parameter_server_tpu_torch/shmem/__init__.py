"""shmem/: zero-copy shared-memory transport for co-located shards.

Counterpart of ``flink_parameter_server_tpu/shmem/``, which imports no
JAX: a copy, since the port imports nothing of the JAX package (whose
``__init__`` imports JAX).  The ring layout is the reference's byte for
byte, so a ring written by either package reads back through the other.
The rings carry host bytes only: a card shard copies its rows off the
card before they reach a ring, as it does for every wire.

The binary framing removed the codec's share of a pull round; what
remained was TCP loopback's scheduler-wakeup and kernel-copy floor, the
wrong substrate between processes on ONE host.  This package swaps the
substrate and nothing else: per-(client, shard) SPSC ring pairs in
``multiprocessing.shared_memory`` carrying the SAME versioned frame
layout as ``utils/frames.py`` byte for byte, negotiated per connection
(``hello shm v=1`` → binary TCP → lines) with automatic fallback for
non-co-located peers.

Layering: ``ring`` and ``doorbell`` are dependency-free substrate;
``pump`` is the server half (imported lazily by ``utils/net.py`` on
the first shm hello); ``channel`` is the client half (imported lazily
by ``cluster/client.py`` on an shm dial).  Import THIS package freely
— it pulls in the cluster client, so the server-side never imports it
at module scope.
"""
from .channel import (
    DEFAULT_CAPACITY,
    ShmShardConnection,
    available,
    hello_shm_line,
    shm_usable,
)
from .doorbell import Doorbell
from .pump import ShmServerPump
from .ring import (
    K_FRAME,
    K_LINE,
    K_WRAP,
    RingClosed,
    RingCorruption,
    RingTimeout,
    ShmRing,
)

__all__ = [
    "DEFAULT_CAPACITY",
    "Doorbell",
    "K_FRAME",
    "K_LINE",
    "K_WRAP",
    "RingClosed",
    "RingCorruption",
    "RingTimeout",
    "ShmRing",
    "ShmServerPump",
    "ShmShardConnection",
    "available",
    "hello_shm_line",
    "shm_usable",
]
