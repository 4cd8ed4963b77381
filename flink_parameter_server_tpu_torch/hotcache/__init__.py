"""hotcache/ — staleness-bounded hot-key lease cache at the client edge.

Counterpart of ``flink_parameter_server_tpu/hotcache/``.  ``leases``,
``cache`` and ``policy`` are copies (host numpy; the client's wire rows
are host arrays); ``serving``'s cross-shard top-K scores and ranks with
the port's ``ops/topk.dense_topk`` on the card unless the caller asks for
the CPU.

PR 6 measured the skew (CountMin + SpaceSaving sketches,
``telemetry/hotkeys.py``); PR 7 priced the wire (60.9% of the pull
round); this package acts on both: hot rows are cached at the client
under **leases** granted by the shards, invalidation piggybacks on the
existing request/response traffic as trailing ``inv=`` tokens, and the
staleness bound is enforced *locally* with ``cluster/clock.py``
semantics — so the bound holds through partitions, lost invalidations
and shard restarts, with the same consistency carve-out discipline as
PR 9's worker-read rules (BSP bypasses; SSP/async/serving use it).

See docs/hotcache.md for the lease protocol, the staleness contract
and the carve-out table.

| module | role |
|---|---|
| ``cache.py`` | :class:`HotRowCache` — the client-edge bounded cache + the process-wide registry the ``/hot`` endpoint reads |
| ``leases.py`` | :class:`LeaseBoard` — shard-side grants + piggybacked invalidation queues; the shared trailing-token idioms |
| ``policy.py`` | :class:`LeasePolicy` (sketch-driven grants) and :class:`StaticHotSet` |
| ``serving.py`` | :class:`CachedLookupService` — cached + hedged serving reads, cross-shard fan-out top-K over ``ops/topk`` |
"""
from .cache import (
    HotRowCache,
    cache_snapshots,
    register_cache,
    unregister_cache,
)
from .leases import (
    LeaseBoard,
    parse_inv_token,
    split_response_options,
)
from .policy import LeasePolicy, StaticHotSet
from .serving import CachedLookupResult, CachedLookupService

__all__ = [
    "CachedLookupResult",
    "CachedLookupService",
    "HotRowCache",
    "LeaseBoard",
    "LeasePolicy",
    "StaticHotSet",
    "cache_snapshots",
    "parse_inv_token",
    "register_cache",
    "split_response_options",
    "unregister_cache",
]
