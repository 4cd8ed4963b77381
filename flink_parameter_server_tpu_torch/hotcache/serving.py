"""Cached serving reads — the tier that survives celebrity traffic.

Counterpart of ``flink_parameter_server_tpu/hotcache/serving.py``.  The
lookups are the reference's (host numpy rows through the lease-capable
client); :meth:`CachedLookupService.top_k` scores each shard's candidate
rows and merges the partial top-Ks with the port's
:func:`~..ops.topk.dense_topk` on the service's ``device`` — the card
unless the caller asks for the CPU; without a card the service raises.
Answers come back as numpy.

The serving-side consumer of the hot-key cache: a lookup service over
the live cluster table whose hot rows come from the client-edge cache
and whose misses go to the shards **hedged**
(:class:`~..elastic.hedging.Hedger` — a straggling shard races a
budgeted backup connection, first answer wins), so a storm on 1% of
the keys neither crosses the wire per request nor parks the tail
behind one slow handler.

This composes with (not replaces) the other two serving topologies:

  * the in-process snapshot plane (``serving/``) serves from published
    training snapshots — no wire at all, but only inside the trainer
    process;
  * the replica-chain reader (``serving/follower.py``) load-balances
    across followers — linear read scaling;
  * this tier multiplies either by the skew: cached hot rows cost no
    wire round trip at all for up to ``bound`` ticks.

:meth:`CachedLookupService.top_k` is the cross-shard fan-out: the
candidate set is scored per owning shard (rows pulled through the
cache, so hot candidates are free) and the per-shard partial top-Ks
merge through one final :func:`~..ops.topk.dense_topk` — the same
partial-top-K-then-merge shape the sketch aggregator already exercises
on counter scores (``telemetry/hotkeys.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.topk import dense_topk
from ..utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class CachedLookupResult:
    """One answered lookup batch + its cache provenance."""

    values: np.ndarray      # (B, *value_shape) float32
    cache_hits: int         # ids served from the edge cache
    cache_misses: int       # ids that crossed the wire
    epoch: Optional[int]    # membership epoch the routing used


class CachedLookupService:
    """Serving lookups with the hot-key tier in front.

    Built from a ``membership`` view (elastic/replicated clusters) or
    static ``addresses``+``partitioner``; constructs its own
    lease-capable :class:`~..cluster.client.ClusterClient` with the
    cache, policy and (by default) a hedger attached.  Timeouts
    default tight — a serving read is latency-bound.  ``device`` is
    where :meth:`top_k` scores and ranks: the card unless the caller
    passes ``device="cpu"``.
    """

    def __init__(
        self,
        membership=None,
        value_shape: Sequence[int] = (),
        *,
        addresses=None,
        partitioner=None,
        cache=None,
        policy=None,
        bound: int = 4,
        capacity: int = 2048,
        lease_ttl: int = 16,
        hedge=None,
        hedge_after_s: Optional[float] = 0.05,
        registry=None,
        worker: str = "serving-hotcache",
        timeout: float = 5.0,
        connect_timeout: float = 2.0,
        retry_timeout: float = 10.0,
        device: DeviceLike = None,
    ):
        from ..cluster.client import ClusterClient
        from .cache import HotRowCache
        from .policy import LeasePolicy

        # resolved first: without a card the service raises before it
        # builds a cache, a hedger or a client
        self.device = resolve_device(device)
        if cache is None:
            cache = HotRowCache(
                bound, capacity=capacity,
                registry=registry if registry is not None else None,
                worker=worker,
            )
        if policy is None:
            # default: lease what the live cross-shard sketches say is
            # hot (PR 6's measurement driving PR 11's mechanism)
            from ..telemetry.hotkeys import get_aggregator

            policy = LeasePolicy(get_aggregator())
        if hedge is None and hedge_after_s is not None:
            from ..elastic.hedging import Hedger

            hedge = Hedger(
                hedge_after_s,
                registry=registry if registry is not None else None,
            )
        self.cache = cache
        self.policy = policy
        self._client = ClusterClient(
            addresses,
            partitioner,
            value_shape=value_shape,
            membership=membership,
            hedge=hedge,
            hotcache=cache,
            lease_policy=policy,
            lease_ttl=lease_ttl,
            timeout=timeout,
            connect_timeout=connect_timeout,
            retry_timeout=retry_timeout,
            registry=registry if registry is not None else None,
            worker=worker,
        )
        self.lookups_served = 0
        self.lookup_errors = 0

    @property
    def client(self):
        return self._client

    # -- the read surface ----------------------------------------------------
    def lookup(self, ids) -> CachedLookupResult:
        """Rows for ``ids``: cache hits served locally, misses pulled
        (hedged) from the shards; hot misses are leased so the next
        storm request is a hit."""
        ids = np.asarray(ids, np.int64)
        cache = self.cache
        h0, m0 = cache.hits, cache.misses
        try:
            values = self._client.pull_batch(ids)
        except Exception:
            self.lookup_errors += 1
            raise
        self.lookups_served += 1
        return CachedLookupResult(
            values=values,
            cache_hits=cache.hits - h0,
            cache_misses=cache.misses - m0,
            epoch=self._client._epoch,
        )

    def top_k(
        self, query, candidate_ids, k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-``k`` of ``query · row`` over ``candidate_ids``,
        fanned out per owning shard: each shard's candidate rows are
        fetched through the cache (hot rows free), scored and cut to a
        local top-``k`` with :func:`~..ops.topk.dense_topk`, and the
        ``shards × k`` partials merge through one final ``dense_topk``
        — communication is O(shards · k), not O(candidates).

        Returns ``(scores (k,), ids (k,))`` padded with ``-inf``/``-1``
        when fewer than ``k`` candidates exist.  Scoring and both
        selections run on the service's ``device``."""
        dev = self.device
        cand = np.unique(np.asarray(candidate_ids, np.int64).reshape(-1))
        if cand.size == 0:
            return (
                np.full(k, -np.inf, np.float32),
                np.full(k, -1, np.int64),
            )
        q = torch.as_tensor(
            np.asarray(query, np.float32).reshape(1, -1), device=dev
        )
        shards = self._client.partitioner.shard_of(cand)
        part_scores = []
        part_ids = []
        for s in np.unique(shards):
            sids = cand[shards == s]
            rows = self._client.pull_batch(sids)
            rows2d = np.asarray(rows, np.float32).reshape(len(sids), -1)
            scores, idx = dense_topk(
                torch.as_tensor(rows2d, device=dev), q,
                min(k, len(sids)),
            )
            idx0 = idx[0].cpu().numpy()
            valid = idx0 >= 0
            part_scores.append(scores[0][torch.as_tensor(valid, device=dev)])
            part_ids.append(sids[idx0[valid]])
        all_scores = torch.cat(part_scores)
        all_ids = np.concatenate(part_ids)
        # the merge: partial candidates re-ranked on their own scores
        merged_scores, merged_idx = dense_topk(
            all_scores.reshape(-1, 1),
            torch.ones((1, 1), dtype=torch.float32, device=dev),
            min(k, len(all_ids)),
        )
        idx0 = merged_idx[0].cpu().numpy()
        out_scores = np.full(k, -np.inf, np.float32)
        out_ids = np.full(k, -1, np.int64)
        valid = idx0 >= 0
        n = int(valid.sum())
        out_scores[:n] = merged_scores[0].cpu().numpy()[valid]
        out_ids[:n] = all_ids[idx0[valid]]
        return out_scores, out_ids

    def close(self) -> None:
        self._client.close()


__all__ = ["CachedLookupResult", "CachedLookupService"]
