"""HotRowCache — the client-edge staleness-bounded row cache.

A copy of ``flink_parameter_server_tpu/hotcache/cache.py``: rows are host
numpy, as the client's wire data is.

Replicas (PR 9) multiply read capacity linearly; this cache multiplies
it by the skew: a celebrity row that is 30% of all read traffic costs
one lease per ``bound`` ticks instead of one wire round trip per
request.  The price is staleness, and the whole design is about
keeping that price inside the SSP contract (``cluster/clock.py``): a
cached row served at tick ``t`` that was filled at tick ``t0`` misses
at most ``t − t0`` ticks of other writers' pushes, so the cache may
serve it **only while** ``t − t0 <= bound`` — exactly the SSP
guarantee, enforced locally so it survives partitions, lost
invalidations and shard restarts (docs/hotcache.md "Staleness
contract").

The consistency carve-out (same discipline as PR 9's worker-read
rules):

  =============  ========================================================
  consistency    cache behaviour
  =============  ========================================================
  BSP (bound 0)  BYPASSED — the driver never attaches a cache to a
                 bound-0 worker client (reads must see every previous-
                 round write; any cached age > 0 breaks parity)
  SSP (k > 0)    entries served while age ≤ k ticks; past that the read
                 falls through to the shard (counted
                 ``hotcache_stale_rejects_total``)
  async / serve  entries served under the configured ``bound`` (ticks)
                 and optional ``ttl_s`` wall-clock cap
  =============  ========================================================

A **tick** is one ``pull_batch`` call on the owning client — one
training round for a cluster worker, one request for a serving
reader.  Freshness inside the bound comes from invalidation:
the owning client drops entries for its own pushes immediately, and
cross-client writes arrive as piggybacked ``inv=`` tokens
(:mod:`.leases`) within one round of the conflicting push.

Not thread-safe by design-of-use (each worker client owns its cache,
the same ownership rule as ``ShardConnection``) — but all mutation is
behind one lock anyway so monitoring surfaces (``/hot``, run_report)
can read a live cache safely.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


class _Entry:
    __slots__ = ("row", "tick", "t_wall", "hits", "bound")

    def __init__(
        self, row: np.ndarray, tick: int, t_wall: float, bound: int
    ):
        self.row = row
        self.tick = tick
        self.t_wall = t_wall
        self.hits = 0
        self.bound = bound  # per-entry effective bound (jittered ≤ cache bound)


class HotRowCache:
    """Staleness-bounded hot-row cache (see module docstring).

    ``bound`` is the maximum entry age in ticks a lookup may serve;
    ``ttl_s`` an optional wall-clock cap on top (async mode's belt and
    braces); ``capacity`` bounds memory — at capacity the oldest-fill
    entry is evicted.
    """

    def __init__(
        self,
        bound: int = 2,
        *,
        capacity: int = 1024,
        ttl_s: Optional[float] = None,
        jitter_frac: float = 0.25,
        registry=None,
        worker: Optional[str] = None,
    ):
        if bound < 1:
            raise ValueError(
                f"bound={bound}: must be >= 1 (BSP/bound-0 readers "
                f"bypass the cache entirely — see docs/hotcache.md)"
            )
        if capacity < 1:
            raise ValueError(f"capacity={capacity}: must be >= 1")
        if not 0.0 <= jitter_frac < 1.0:
            raise ValueError(
                f"jitter_frac={jitter_frac}: must be in [0, 1)"
            )
        self.bound = int(bound)
        self.capacity = int(capacity)
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        # per-key deterministic TTL jitter: entries leased in one wave
        # would otherwise all expire on the same tick and re-lease as
        # one thundering herd (a visible p99 spike every `bound`
        # requests); spreading each key's effective bound over
        # [bound·(1−jitter_frac), bound] de-synchronizes the refresh
        # load.  Jittered bounds only ever SHORTEN a lease, so the
        # staleness contract (age ≤ bound) is untouched.
        self.jitter_frac = float(jitter_frac)
        # brownout widening (loadgen/overload.BrownoutController,
        # docs/loadgen.md): under shed pressure the controller widens
        # the served-age bound to ``entry.bound × widen`` — degraded
        # freshness instead of errors, still a REAL bound the
        # lease_staleness checker enforces (at the widened value).
        # 1.0 = normal operation.
        self._widen = 1.0
        self._lock = threading.Lock()
        self._entries: Dict[int, _Entry] = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.revocations = 0       # entries dropped by inv= / own push
        self.stale_rejects = 0     # valid entries past the bound
        self.evictions = 0         # capacity pressure
        self.fills = 0
        self.max_served_age = 0    # the nemesis lease_staleness oracle
        if registry is not False:
            from ..telemetry.registry import get_registry

            reg = registry if registry is not None else get_registry()
            labels = {"worker": worker} if worker is not None else {}
            self._c_hits = reg.counter(
                "hotcache_hits_total", component="hotcache", **labels
            )
            self._c_misses = reg.counter(
                "hotcache_misses_total", component="hotcache", **labels
            )
            self._c_revoked = reg.counter(
                "hotcache_revocations_total", component="hotcache",
                **labels,
            )
            self._c_stale = reg.counter(
                "hotcache_stale_rejects_total", component="hotcache",
                **labels,
            )
            reg.gauge(
                "hotcache_entries", component="hotcache",
                fn=lambda: len(self._entries), **labels,
            )
        else:
            self._c_hits = self._c_misses = None
            self._c_revoked = self._c_stale = None

    # -- the tick (one per pull_batch on the owning client) ------------------
    def tick(self) -> int:
        with self._lock:
            self._tick += 1
            return self._tick

    @property
    def current_tick(self) -> int:
        with self._lock:
            return self._tick

    # -- the read path -------------------------------------------------------
    def lookup(self, ids) -> Dict[int, np.ndarray]:
        """Servable rows for ``ids``: only entries within the staleness
        bound (and ttl) are returned; entries past either are removed
        and counted as stale rejects (the read falls through to the
        shard).  Every id not returned is a miss."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        out: Dict[int, np.ndarray] = {}
        now = time.monotonic()
        n_hit = n_miss = 0
        with self._lock:
            widen = self._widen
            for gid in ids.tolist():
                e = self._entries.get(gid)
                if e is None:
                    n_miss += 1
                    continue
                age = self._tick - e.tick
                if age > int(e.bound * widen) or (
                    self.ttl_s is not None
                    and now - e.t_wall > self.ttl_s
                ):
                    del self._entries[gid]
                    self.stale_rejects += 1
                    if self._c_stale is not None:
                        self._c_stale.inc()
                    n_miss += 1
                    continue
                e.hits += 1
                out[gid] = e.row
                n_hit += 1
                if age > self.max_served_age:
                    self.max_served_age = age
            self.hits += n_hit
            self.misses += n_miss
        if self._c_hits is not None:
            if n_hit:
                self._c_hits.inc(n_hit)
            if n_miss:
                self._c_misses.inc(n_miss)
        return out

    # -- the fill path (lease answers) ---------------------------------------
    def fill(self, ids, rows) -> int:
        """Install freshly leased rows at the current tick; returns the
        number installed (capacity-evicting oldest fills)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        rows = np.asarray(rows, np.float32)
        now = time.monotonic()
        jitter_span = int(self.bound * self.jitter_frac)
        with self._lock:
            for i, gid in enumerate(ids.tolist()):
                while (
                    gid not in self._entries
                    and len(self._entries) >= self.capacity
                ):
                    oldest = min(
                        self._entries, key=lambda g: self._entries[g].tick
                    )
                    del self._entries[oldest]
                    self.evictions += 1
                bound = self.bound - (
                    ((gid * 0x9E3779B1) >> 7) % (jitter_span + 1)
                    if jitter_span else 0
                )
                self._entries[gid] = _Entry(
                    np.array(rows[i], np.float32), self._tick, now, bound
                )
            self.fills += len(ids)
            return len(ids)

    # -- invalidation --------------------------------------------------------
    def invalidate(self, ids=None) -> int:
        """Drop entries for ``ids`` (None = everything — the ``inv=*``
        drop-all marker and the epoch-flip path); returns how many were
        actually dropped.  Called for the client's own pushes and for
        piggybacked ``inv=`` tokens."""
        with self._lock:
            if ids is None:
                n = len(self._entries)
                self._entries.clear()
            else:
                n = 0
                for gid in np.asarray(ids, np.int64).reshape(-1).tolist():
                    if self._entries.pop(gid, None) is not None:
                        n += 1
            self.revocations += n
        if self._c_revoked is not None and n:
            self._c_revoked.inc(n)
        return n

    def clear(self) -> None:
        self.invalidate(None)

    # -- brownout (loadgen/overload.BrownoutController) ----------------------
    def set_widen(self, mult: float) -> None:
        """Scale the served-age bound by ``mult`` (≥ 1; 1 restores
        normal operation).  Entries aged past their own bound but
        inside ``bound × mult`` become servable again — the degraded
        tier under overload.  The caller owns proving the widened
        bound still holds (``max_served_age`` keeps tracking)."""
        m = float(mult)
        if m < 1.0:
            raise ValueError(f"widen mult={mult}: must be >= 1")
        with self._lock:
            self._widen = m

    @property
    def widen_mult(self) -> float:
        with self._lock:
            return self._widen

    # -- monitoring ----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "tick": self._tick,
                "bound": self.bound,
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (
                    round(self.hits / total, 4) if total else None
                ),
                "fills": self.fills,
                "revocations": self.revocations,
                "stale_rejects": self.stale_rejects,
                "evictions": self.evictions,
                "max_served_age": self.max_served_age,
                "widen_mult": self._widen,
                "effective_bound": int(self.bound * self._widen),
            }

    def snapshot(self, n: int = 32) -> Dict[str, object]:
        """The ``/hot`` endpoint shape: stats + the per-key table
        (key, age in ticks, per-key hits), hottest first."""
        out = self.stats()
        with self._lock:
            keys = sorted(
                self._entries.items(), key=lambda kv: -kv[1].hits
            )[:n]
            out["keys"] = [
                {
                    "key": gid,
                    "age": self._tick - e.tick,
                    "hits": e.hits,
                }
                for gid, e in keys
            ]
        return out


# -- process-wide cache registry (the /hot endpoint + run_report view) --------
_CACHES_LOCK = threading.Lock()
_CACHES: Dict[str, HotRowCache] = {}


def register_cache(label: str, cache: HotRowCache) -> HotRowCache:
    """Make a cache visible to the ``/hot`` telemetry path and the
    run-report roll-up (re-registering a label replaces it)."""
    with _CACHES_LOCK:
        _CACHES[str(label)] = cache
    return cache


def unregister_cache(label: str) -> None:
    with _CACHES_LOCK:
        _CACHES.pop(str(label), None)


def cache_snapshots(n: int = 32) -> Dict[str, Dict[str, object]]:
    """``{label: snapshot}`` over every registered cache."""
    with _CACHES_LOCK:
        caches = dict(_CACHES)
    return {label: c.snapshot(n) for label, c in sorted(caches.items())}


__all__ = [
    "HotRowCache",
    "cache_snapshots",
    "register_cache",
    "unregister_cache",
]
