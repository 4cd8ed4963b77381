"""tierstore/ — two-tier ParamShard store (``store_backend="tiered"``).

Counterpart of ``flink_parameter_server_tpu/tierstore/``.  Hot rows live
dense on the store's ``device`` (the card unless the caller asks for the
CPU, where the layout is the reference's); cold rows live in an mmap'd
slab file in host memory.  Because every row is recomputable from the
deterministic per-id init (:mod:`~..utils.initializers`), an ABSENT row
is not a fault — the cold tier is a cache of MUTATED rows only, and the
WAL + checkpoint planes remain the sole durability story
(docs/tierstore.md).

  * :class:`~.slab.ColdSlab` — the mmap'd fixed-width row file plus
    its id→slot index and free list;
  * :class:`~.store.TieredStore` — the store surface
    :class:`~..cluster.shard.ParamShard` drives (``gather`` / ``push``
    / ``assign`` / ``values``), with CountMin + SpaceSaving admission
    ordering, windowed decay, pinned-row protection and batch
    demotion off the hot path;
  * :mod:`~.metrics` — ``component=tierstore`` instruments and the
    process-wide store registry behind the TelemetryServer ``tiers``
    path (``psctl tiers``).
"""
from .slab import ColdSlab
from .store import TieredStore
from .metrics import register_store, unregister_store, tiers_snapshot

__all__ = [
    "ColdSlab",
    "TieredStore",
    "register_store",
    "unregister_store",
    "tiers_snapshot",
]
