"""serving/ — the online inference subsystem.

Counterpart of ``flink_parameter_server_tpu/serving/``: the query plane
of an online learner, which answers while it trains.  Versioned table
snapshots decouple readers from the in-place update step, an admission
batcher coalesces concurrent requests into bucket-shaped batches, and a
line-protocol TCP server answers top-K recommendation queries against the
live :class:`~..core.store.ShardedParamStore` while the
:class:`~..training.driver.StreamingDriver` keeps training.

Module map::

  snapshot.py   TableSnapshot / SnapshotManager — clone-on-publish with
                a publish_every cadence and staleness metadata (steps
                behind the trainer)
  batcher.py    RequestBatcher — bounded admission queue, pad-to-bucket
                coalescing, deadline flush, reject-on-overload
  engine.py     QueryEngine — snapshot-read ops: embedding lookup, MF
                dot-product scoring, exact top-K with exclusion masks
                (ops/topk.dense_topk through models/topk_recommender)
  server.py     ServingService (batcher + engine + dispatch thread),
                ServingClient (in-process), ServingServer (TCP line
                protocol)
  metrics.py    ServingMetrics — QPS, batch-fill ratio, queue depth,
                p50/p99 request latency, snapshot staleness
  follower.py   FollowerLookupService / ChainLookupResult — lookups
                against a live replicated cluster, routed across each
                shard's replica chain (replication/), that keep flowing
                through a failover

Train-while-serve is one call::

    driver = StreamingDriver(logic, store)
    service = driver.serve_with(publish_every=4)
    client = service.client()
    ...                       # driver.run(batches) in one thread,
    client.top_k(user, k=10)  # queries answered concurrently
"""
from .batcher import QueueFull, RequestBatcher
from .engine import LookupResult, NoSnapshotError, QueryEngine, TopKResult
from .follower import ChainLookupResult, FollowerLookupService
from .metrics import ServingMetrics
from .server import ServingClient, ServingServer, ServingService
from .snapshot import SnapshotManager, TableSnapshot

__all__ = [
    "QueueFull",
    "RequestBatcher",
    "NoSnapshotError",
    "QueryEngine",
    "TopKResult",
    "LookupResult",
    "ServingMetrics",
    "ServingService",
    "ServingClient",
    "ServingServer",
    "SnapshotManager",
    "TableSnapshot",
    "ChainLookupResult",
    "FollowerLookupService",
]
