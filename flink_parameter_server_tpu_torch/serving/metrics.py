"""Serving-side observability — the query-plane sibling of

A copy of ``flink_parameter_server_tpu/serving/metrics.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

``training/metrics.StepMetrics``.

Same machinery, same contract: a rolling-window tracker with a
``snapshot()`` dict and a JSON-lines ``emit(sink)``, so the driver's
``metrics_sink`` receives interleaved training and serving lines from
one stream.  Tracked: QPS, request latency percentiles (admission →
answer), batch-fill ratio (occupancy / padded bucket — how much of
each compiled program is real work), queue depth, rejection count, and
snapshot staleness (trainer steps the served table lags the live one).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..telemetry.registry import json_line


class ServingMetrics:
    """Rolling QPS/latency/fill tracker for the serve path.

    Thread-safe: the dispatch thread records batches while any thread
    snapshots.  ``queue_depth_fn`` / ``staleness_fn`` are live probes
    wired in by the :class:`~.server.ServingService` so emission reads
    the CURRENT queue/staleness, not a stale recorded value.

    With a :class:`~..telemetry.MetricsRegistry` attached
    (``registry=``, or :meth:`bind_registry` after construction), the
    admission counters (requests / batches / rejects), the
    admission→answer latency histogram, and live probe gauges (QPS,
    fill, queue depth, staleness) publish through the unified plane
    under ``component=serving``.
    """

    def __init__(self, window: int = 1024, registry=None):
        self.window = int(window)
        self._lock = threading.Lock()
        self._latencies: List[float] = []  # seconds, admission -> answer
        self._fills: List[float] = []  # per batch: n / bucket
        self._done_times: List[float] = []  # per request completion
        self.total_requests = 0
        self.total_batches = 0
        self.total_rejected = 0
        self.started_at = time.perf_counter()
        self.queue_depth_fn: Optional[Callable[[], int]] = None
        self.staleness_fn: Optional[Callable[[], Optional[int]]] = None
        self.registry = None
        self._c_requests = self._c_batches = None
        self._c_rejected = self._h_latency = None
        self._c_reject_reason: Dict[str, Any] = {}
        if registry is not None:
            self.bind_registry(registry)

    def bind_registry(self, registry) -> "ServingMetrics":
        """Publish through the unified plane.  Called by
        :class:`~.server.ServingService` AFTER the queue/staleness
        probes are wired, so the gauges read live values from day one."""
        self.registry = registry
        self._c_requests = registry.counter(
            "serving_requests_total", component="serving"
        )
        self._c_batches = registry.counter(
            "serving_batches_total", component="serving"
        )
        self._c_rejected = registry.counter(
            "serving_rejected_total", component="serving"
        )
        # per-cause admission rejects (the soak's badput attribution,
        # docs/loadgen.md): queue_full = hard capacity, deadline =
        # queue wait blew the request deadline, shed = deliberate
        # overload shedding below the hard line.  Pre-registered so
        # /metrics shows zeros from the first scrape.
        self._c_reject_reason = {
            r: registry.counter(
                "serving_rejected_total", component="serving", reason=r
            )
            for r in ("queue_full", "deadline", "shed")
        }
        self._h_latency = registry.histogram(
            "serving_latency_seconds", component="serving"
        )
        registry.gauge("serving_qps", component="serving", fn=self.qps)
        registry.gauge(
            "serving_batch_fill", component="serving", fn=self.batch_fill
        )
        registry.gauge(
            "serving_queue_depth", component="serving",
            fn=lambda: (
                None if self.queue_depth_fn is None
                else self.queue_depth_fn()
            ),
        )
        registry.gauge(
            "snapshot_staleness_steps", component="serving",
            fn=lambda: (
                None if self.staleness_fn is None else self.staleness_fn()
            ),
        )
        return self

    # -- recording ---------------------------------------------------------
    def record_batch(
        self, n: int, bucket: int, latencies_s: List[float]
    ) -> None:
        now = time.perf_counter()
        with self._lock:
            self.total_batches += 1
            self.total_requests += n
            self._fills.append(n / max(1, bucket))
            self._latencies.extend(latencies_s)
            self._done_times.extend([now] * n)
            for buf in (self._latencies, self._fills, self._done_times):
                if len(buf) > self.window:
                    del buf[: len(buf) - self.window]
        if self._c_requests is not None:
            self._c_requests.inc(n)
            self._c_batches.inc()
            for lat in latencies_s:
                self._h_latency.observe(lat)

    def record_reject(self, n: int = 1, reason: str = "queue_full") -> None:
        with self._lock:
            self.total_rejected += n
        if self._c_rejected is not None:
            self._c_rejected.inc(n)
            counter = self._c_reject_reason.get(reason)
            if counter is not None:
                counter.inc(n)

    # -- reporting ---------------------------------------------------------
    def qps(self) -> float:
        """Windowed queries/sec: completions in the window over the span
        from the first windowed completion to now (robust to bursts)."""
        with self._lock:
            if not self._done_times:
                return 0.0
            span = time.perf_counter() - self._done_times[0]
            n = len(self._done_times)
        return n / span if span > 0 else 0.0

    def latency_percentiles(self) -> Dict[str, float]:
        with self._lock:
            lat = list(self._latencies)
        if not lat:
            return {"p50": 0.0, "p90": 0.0, "p99": 0.0}
        d = np.array(lat)
        return {
            "p50": float(np.percentile(d, 50)),
            "p90": float(np.percentile(d, 90)),
            "p99": float(np.percentile(d, 99)),
        }

    def batch_fill(self) -> float:
        with self._lock:
            return float(np.mean(self._fills)) if self._fills else 0.0

    def snapshot(self) -> Dict[str, Any]:
        lat = self.latency_percentiles()
        out = {
            "serving_requests": self.total_requests,
            "serving_rejected": self.total_rejected,
            "serving_qps": round(self.qps(), 1),
            "serving_p50_ms": round(lat["p50"] * 1e3, 3),
            "serving_p90_ms": round(lat["p90"] * 1e3, 3),
            "serving_p99_ms": round(lat["p99"] * 1e3, 3),
            "batch_fill": round(self.batch_fill(), 3),
            "wall_s": round(time.perf_counter() - self.started_at, 3),
        }
        if self.queue_depth_fn is not None:
            out["queue_depth"] = int(self.queue_depth_fn())
        if self.staleness_fn is not None:
            s = self.staleness_fn()
            out["snapshot_staleness_steps"] = None if s is None else int(s)
        return out

    def emit(self, sink=None) -> str:
        """One single-line JSON sample (shared ``ts``/``run_id`` stamped
        by the unified plane; guaranteed to round-trip ``json.loads``)."""
        return json_line(
            self.snapshot(), sink,
            run_id=self.registry.run_id if self.registry else None,
        )


__all__ = ["ServingMetrics"]
