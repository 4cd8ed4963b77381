"""``component=tierstore`` instruments + the ``tiers`` snapshot

A copy of ``flink_parameter_server_tpu/tierstore/metrics.py`` (host
code).
registry.

Two consumers share one stats source (:meth:`TieredStore.stats`):

  * the metric plane — per-shard gauges registered on the shard's
    :class:`~..telemetry.registry.MetricsRegistry` (scraped as
    ``component=tierstore`` lines; see docs/tierstore.md's instrument
    catalog);
  * the ``tiers`` TelemetryServer path — ``psctl tiers`` wants the
    full per-shard stats dict, not flattened metric lines, so shards
    also register a snapshot callable here (process-wide, like
    :class:`~..telemetry.hotkeys.HotKeyAggregator`).  The callable is
    expected to take the shard lock itself; ``tiers_snapshot``
    returns ``None`` until the first store registers, which the
    exporter renders as the "no tiered shards" null payload.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

_lock = threading.Lock()
_stores: Dict[str, Callable[[], dict]] = {}


def register_store(label: str, stats_fn: Callable[[], dict]) -> None:
    """Expose a tiered shard's stats under ``label`` (``shard-N`` /
    ``shard-N-fK`` for followers).  Last registration wins — a shard
    restart re-registers over its dead predecessor."""
    with _lock:
        _stores[str(label)] = stats_fn


def unregister_store(label: str) -> None:
    with _lock:
        _stores.pop(str(label), None)


def tiers_snapshot() -> Optional[Dict[str, dict]]:
    """``{label: stats_dict}`` for every registered tiered store, or
    ``None`` when no tiered shard ever registered (the cluster is not
    running ``store_backend="tiered"``)."""
    with _lock:
        if not _stores:
            return None
        fns = list(_stores.items())
    out: Dict[str, dict] = {}
    for label, fn in fns:
        try:
            st = fn()
        except Exception:
            # a shard mid-crash/restart must not poison the scrape
            continue
        if st is not None:
            out[label] = st
    return out


def clear() -> None:
    """Test hook: forget every registration."""
    with _lock:
        _stores.clear()


def register_instruments(reg, shard_label: str, stats_fn) -> None:
    """Register the per-shard gauge set on ``reg``.  Monotonic counts
    (hits/misses/promotes/demotes/spills) are exported as fn-backed
    gauges reading the store's cumulative counters — same pattern as
    ``cluster_shard_queue_depth``.  Registrations are literal (one
    call per instrument) so the fpsanalyze D002 catalog reconciliation
    can see every name — keep this list in lockstep with the
    docs/tierstore.md instrument table."""
    def field(name):
        def read():
            st = stats_fn()
            return None if st is None else st.get(name)

        return read

    shard = str(shard_label)
    reg.gauge("tier_resident_rows", component="tierstore",
              shard=shard, fn=field("resident_rows"))
    reg.gauge("tier_hot_capacity_rows", component="tierstore",
              shard=shard, fn=field("hot_capacity_rows"))
    reg.gauge("tier_pinned_rows", component="tierstore",
              shard=shard, fn=field("pinned_rows"))
    reg.gauge("tier_slab_rows", component="tierstore",
              shard=shard, fn=field("slab_rows"))
    reg.gauge("tier_slab_bytes", component="tierstore",
              shard=shard, fn=field("slab_bytes"))
    reg.gauge("tier_hits_total", component="tierstore",
              shard=shard, fn=field("hits"))
    reg.gauge("tier_misses_total", component="tierstore",
              shard=shard, fn=field("misses"))
    reg.gauge("tier_promotes_total", component="tierstore",
              shard=shard, fn=field("promotes"))
    reg.gauge("tier_demotes_total", component="tierstore",
              shard=shard, fn=field("demotes"))
    reg.gauge("tier_spills_total", component="tierstore",
              shard=shard, fn=field("spills"))
    reg.gauge("tier_evict_scan_seconds", component="tierstore",
              shard=shard, fn=field("last_evict_scan_s"))


__all__ = [
    "register_store",
    "unregister_store",
    "tiers_snapshot",
    "register_instruments",
    "clear",
]
