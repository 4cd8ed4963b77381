"""Timeline plane — continuous metric series over the registry.

Counterpart of ``flink_parameter_server_tpu/telemetry/timeline.py``, which
imports no JAX; the port keeps its own copy, since it imports nothing of
the JAX package.  Every other telemetry surface is point-in-time:
``snapshot()`` answers "what is true now", the profiler answers "where
did this round go", the SLO engine answers "is the objective burning".
:class:`TimelineRecorder` adds the time axis: a sampler (background
thread or explicit :meth:`~TimelineRecorder.sample` calls) that polls a
:class:`~.registry.MetricsRegistry` into bounded per-instrument ring
series —

  * counters become **rates** (value delta / wall delta),
  * gauges become **values** (live probes resolved per sample),
  * histograms become **windowed p50/p99** via bucket-count deltas and
    the in-bin interpolation of :func:`percentile_from_counts`, which the
    elastic controller also reads its windowed pull-RTT p99 with.

Identity is (name, label set, derived field), so labelled instruments
such as ``cluster_shard_rtt_seconds{shard}`` fan out into per-shard
series.  Two consumers ride each sample:

  * :class:`SkewTracker` — windowed per-entity medians over one metric's
    series, published as ``skew_ratio{metric,entity}`` gauges; the
    max/median entity is the straggler attribution;
  * online detectors (:mod:`.detectors`) — EWMA drift and rolling-MAD
    outliers; a firing bumps ``timeline_anomalies_total{metric,kind}``,
    notes the flight recorder (one throttled dump per episode), and is
    scale-out pressure for :class:`~..elastic.controller.ElasticController`.

:meth:`TimelineRecorder.payload` is the JSON window; the reference's
``/metrics`` ``timeline`` path, ``psctl`` views and run-report section
that serve it wait for ROADMAP Queue 1 #7b2.  All of this is host code:
nothing here touches a device.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .flightrec import get_recorder
from .registry import MetricsRegistry, _label_key, get_registry


def percentile_from_counts(bounds, counts, q: float) -> float:
    """The registry histogram's in-bin interpolation
    (:meth:`~.registry.Histogram.percentile`) applied to an arbitrary
    bucket-count vector — typically a DELTA window between two polls.
    ``counts`` is non-cumulative with the overflow bin last; the
    overflow bin clamps to the largest finite boundary."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q / 100.0 * total
    seen = 0.0
    for i, c in enumerate(counts):
        if seen + c >= rank and c > 0:
            if i == len(bounds):
                return bounds[-1]
            lo = 0.0 if i == 0 else bounds[i - 1]
            frac = (rank - seen) / c
            return lo + (bounds[i] - lo) * min(1.0, max(0.0, frac))
        seen += c
    return bounds[-1]


def _median(values: List[float]) -> float:
    s = sorted(values)
    n = len(s)
    if n == 0:
        raise ValueError("median of empty sequence")
    mid = n // 2
    if n % 2:
        return s[mid]
    return 0.5 * (s[mid - 1] + s[mid])


class SkewTracker:
    """Windowed per-entity medians over ONE metric's timeline series —
    the straggler attribution primitive.

    ``observe()`` is fed every appended point by the recorder; points
    whose labels carry ``entity_label`` accumulate into a bounded
    per-entity window.  ``evaluate()`` (once per sample tick) computes
    each entity's median, the median-of-medians baseline, and each
    entity's ratio against it; ratios publish as
    ``skew_ratio{metric=,entity=}`` gauges and the max-ratio entity is
    flagged once past ``ratio_threshold`` — "shard 0 is 8× the fleet
    median" is one gauge read, not a log dive.

    Unlike the drift detectors, this needs NO pre-fault baseline: the
    entities are each other's control group, so a straggler that is
    slow from its very first window still attributes.
    """

    def __init__(
        self,
        metric: str,
        *,
        entity_label: str,
        field: Optional[str] = None,
        window: int = 32,
        min_points: int = 3,
        ratio_threshold: float = 2.0,
        warmup_evals: int = 0,
        registry: Optional[MetricsRegistry] = None,
        history: int = 1024,
    ):
        if window < 1 or min_points < 1:
            raise ValueError(
                f"window={window}, min_points={min_points}: both >= 1"
            )
        if ratio_threshold <= 1.0:
            raise ValueError(
                f"ratio_threshold={ratio_threshold}: must be > 1 (1.0 "
                f"would flag a perfectly balanced fleet)"
            )
        self.metric = metric
        self.entity_label = entity_label
        self.field = field
        self.window = int(window)
        self.min_points = int(min_points)
        self.ratio_threshold = float(ratio_threshold)
        # the first windows after process start measure connection
        # setup, not steady-state service time — suppress flagging
        # (never the published ratios) until this many verdicts passed
        self.warmup_evals = int(warmup_evals)
        self._evals = 0
        self.registry = registry
        self._per_entity: Dict[str, deque] = {}
        self._gauges: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self.history: deque = deque(maxlen=int(history))
        self.last: Optional[Dict[str, Any]] = None

    def observe(self, name: str, labels: Dict[str, str], field: str,
                value: float, ts: float) -> None:
        if name != self.metric:
            return
        if self.field is not None and field != self.field:
            return
        entity = labels.get(self.entity_label)
        if entity is None:
            return
        with self._lock:
            ring = self._per_entity.get(entity)
            if ring is None:
                ring = deque(maxlen=self.window)
                self._per_entity[entity] = ring
            ring.append(float(value))

    def evaluate(self, now: Optional[float] = None) -> Optional[dict]:
        """One attribution pass: per-entity medians → ratios → gauges.
        Returns the verdict dict (also kept as ``.last`` and appended
        to ``.history``), or None when fewer than two entities have
        enough points to compare."""
        with self._lock:
            medians = {
                e: _median(list(ring))
                for e, ring in self._per_entity.items()
                if len(ring) >= self.min_points
            }
        if len(medians) < 2:
            return None
        baseline = _median(list(medians.values()))
        floor = max(abs(baseline), 1e-12)
        ratios = {e: m / floor for e, m in medians.items()}
        if self.registry is not None:
            for e, r in ratios.items():
                g = self._gauges.get(e)
                if g is None:
                    g = self.registry.gauge(
                        "skew_ratio", component="timeline",
                        metric=self.metric, entity=e,
                    )
                    self._gauges[e] = g
                g.set(r)
        top = max(ratios, key=lambda e: ratios[e])
        self._evals += 1
        verdict = {
            "ts": round(now if now is not None else time.time(), 6),
            "metric": self.metric,
            "entity_label": self.entity_label,
            "entity": top,
            "ratio": round(ratios[top], 4),
            "flagged": (
                ratios[top] >= self.ratio_threshold
                and self._evals > self.warmup_evals
            ),
            "medians": {e: round(m, 6) for e, m in medians.items()},
        }
        self.last = verdict
        self.history.append(verdict)
        return verdict

    def snapshot(self) -> dict:
        return {
            "metric": self.metric,
            "entity_label": self.entity_label,
            "field": self.field,
            "ratio_threshold": self.ratio_threshold,
            "warmup_evals": self.warmup_evals,
            "last": self.last,
        }


class TimelineRecorder:
    """Background sampler: registry instruments → bounded ring series.

    ``start()`` launches the poll thread (``interval_s`` cadence);
    ``sample()`` is one synchronous poll (tests and the soak/nemesis
    harnesses drive it directly when they want deterministic ticks).
    ``payload()`` is the JSON-shaped window every surface serves: the
    TelemetryServer ``timeline`` path, the soak artifact, the run
    report.  ``mark(label, **fields)`` stamps an operational event
    (fault injected, arm started) onto the same time axis, which is
    what lets the lint and the A/B harness cross-reference anomaly
    firings against fault onset.

    Per-label-set identity means cardinality is bounded only by the
    registry's; ``max_series`` caps the fan-out (drops counted, never
    silent) so a runaway label can't eat the process.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        interval_s: float = 0.25,
        capacity: int = 2048,
        max_series: int = 512,
        detectors: Optional[Iterable] = None,
        skew: Optional[Iterable[SkewTracker]] = None,
        include: Optional[Callable[[str], bool]] = None,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s}: must be > 0")
        if capacity < 2 or max_series < 1:
            raise ValueError(
                f"capacity={capacity}, max_series={max_series}: need "
                f"capacity >= 2 and max_series >= 1"
            )
        self.registry = registry if registry is not None else get_registry()
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self.detectors = list(detectors) if detectors else []
        self.skew = list(skew) if skew else []
        for tracker in self.skew:
            if tracker.registry is None:
                tracker.registry = self.registry
        self._include = include
        self._lock = threading.Lock()
        self._series: Dict[
            Tuple[str, Tuple[Tuple[str, str], ...], str], deque
        ] = {}
        self._prev_counter: Dict[int, Tuple[float, float]] = {}
        self._prev_buckets: Dict[int, List[int]] = {}
        self._anomalies: List[dict] = []
        self._marks: List[dict] = []
        self._samples = 0
        self._dropped_series = 0
        self.started_at: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- one poll ----------------------------------------------------------
    def sample(self) -> int:
        """Poll every instrument once; returns the number of points
        appended this tick.  Fires detectors/skew inline on each new
        point (the detectors see exactly what the rings record)."""
        now = time.time()
        mono = time.monotonic()
        fired: List[dict] = []
        appended = 0
        for inst in self.registry.instruments():
            if self._include is not None and not self._include(inst.name):
                continue
            if inst.kind == "counter":
                v = float(inst.value)
                prev = self._prev_counter.get(id(inst))
                self._prev_counter[id(inst)] = (v, mono)
                if prev is None:
                    continue
                pv, pt = prev
                dt = mono - pt
                if dt <= 0:
                    continue
                appended += self._append(
                    inst, "rate", now, max(0.0, (v - pv) / dt), fired
                )
            elif inst.kind == "gauge":
                v = inst.value
                if v is None:
                    continue  # unreadable probe = gap, not a zero
                appended += self._append(
                    inst, "value", now, float(v), fired
                )
            elif inst.kind == "histogram":
                counts = inst.bucket_counts()
                prev_c = self._prev_buckets.get(
                    id(inst), [0] * len(counts)
                )
                self._prev_buckets[id(inst)] = counts
                delta = [c - p for c, p in zip(counts, prev_c)]
                if sum(delta) <= 0:
                    continue  # no traffic this window = gap
                bounds = inst.bounds
                appended += self._append(
                    inst, "p50", now,
                    percentile_from_counts(bounds, delta, 50.0), fired,
                )
                appended += self._append(
                    inst, "p99", now,
                    percentile_from_counts(bounds, delta, 99.0), fired,
                )
        for tracker in self.skew:
            tracker.evaluate(now)
        self._samples += 1
        for anom in fired:  # file IO (flightrec dump) outside the walk
            self._on_anomaly(anom)
        return appended

    def _append(self, inst, field: str, ts: float, value: float,
                fired: List[dict]) -> int:
        key = (inst.name, _label_key(inst.labels), field)
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self._dropped_series += 1
                    return 0
                ring = deque(maxlen=self.capacity)
                self._series[key] = ring
            ring.append((round(ts, 6), value))
        for tracker in self.skew:
            tracker.observe(inst.name, inst.labels, field, value, ts)
        for det in self.detectors:
            anom = det.observe(inst.name, inst.labels, field, value, ts)
            if anom is not None:
                fired.append(anom)
        return 1

    def _on_anomaly(self, anom: dict) -> None:
        self._anomalies.append(anom)
        self.registry.counter(
            "timeline_anomalies_total", component="timeline",
            metric=anom["metric"], kind=anom["kind"],
        ).inc()
        rec = get_recorder()
        if rec is not None:
            rec.note(
                "timeline_anomaly", metric=anom["metric"],
                kind=anom["kind"], field=anom.get("field"),
                value=anom.get("value"), score=anom.get("score"),
            )
            # throttled per (kind, metric): a storm of firings on one
            # series produces ONE blackbox artifact per episode, not
            # one per sample (flightrec min_dump_interval_s)
            rec.dump(f"timeline_{anom['kind']}_{anom['metric']}")

    # -- the event axis ----------------------------------------------------
    def mark(self, label: str, **fields: Any) -> dict:
        """Stamp an operational event (fault injected, phase change)
        onto the timeline's own time axis — the cross-reference anchor
        the ``--timeline`` lint and the detection A/B measure against."""
        event = {"ts": round(time.time(), 6), "label": str(label)}
        event.update(fields)
        self._marks.append(event)
        return event

    # -- reads -------------------------------------------------------------
    def anomalies(self) -> List[dict]:
        """Append-only anomaly ledger (the elastic controller keeps a
        cursor into this to turn NEW firings into scale pressure)."""
        return list(self._anomalies)

    def anomalies_since(self, cursor: int) -> Tuple[List[dict], int]:
        """The ledger entries appended since ``cursor`` plus the new
        cursor — the one-liner both the elastic and adaptive
        controllers use so neither re-consumes an old firing."""
        ledger = list(self._anomalies)
        return ledger[cursor:], len(ledger)

    def series(self, metric: Optional[str] = None) -> List[dict]:
        with self._lock:
            items = list(self._series.items())
        out = []
        for (name, labels, field), ring in items:
            if metric is not None and name != metric:
                continue
            out.append({
                "metric": name,
                "labels": dict(labels),
                "field": field,
                "points": [[ts, v] for ts, v in ring],
            })
        out.sort(key=lambda s: (s["metric"], s["field"],
                                sorted(s["labels"].items())))
        return out

    def payload(self, metric: Optional[str] = None) -> dict:
        """The timeline window in its one wire/artifact shape (the
        TelemetryServer ``timeline`` path, the soak artifact's per-arm
        body, the ``--timeline`` lint's subject)."""
        return {
            "kind": "timeline",
            "run_id": self.registry.run_id,
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "samples": self._samples,
            "started_at": self.started_at,
            "dropped_series": self._dropped_series,
            "series": self.series(metric),
            "marks": list(self._marks),
            "anomalies": list(self._anomalies),
            "skew": [t.snapshot() for t in self.skew],
        }

    def summary(self) -> List[dict]:
        """Per-series min/max/last rows (the run-report section)."""
        rows = []
        for s in self.series():
            vals = [v for _, v in s["points"]]
            if not vals:
                continue
            rows.append({
                "metric": s["metric"],
                "labels": s["labels"],
                "field": s["field"],
                "points": len(vals),
                "min": min(vals),
                "max": max(vals),
                "last": vals[-1],
            })
        return rows

    # -- the loop ----------------------------------------------------------
    def start(self) -> "TimelineRecorder":
        if self._thread is None or not self._thread.is_alive():
            self.started_at = time.time()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="timeline-recorder", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — the sampler must survive
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "TimelineRecorder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- the process-wide default -------------------------------------------------
# Like the flight recorder: NOT created lazily.  No recorder installed
# means the `timeline` telemetry path answers null and no thread runs —
# library users opt in, they never discover a background sampler.
_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[TimelineRecorder] = None


def get_timeline() -> Optional[TimelineRecorder]:
    with _DEFAULT_LOCK:
        return _DEFAULT


def set_timeline(
    recorder: Optional[TimelineRecorder],
) -> Optional[TimelineRecorder]:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = recorder
    return recorder


__all__ = [
    "TimelineRecorder",
    "SkewTracker",
    "percentile_from_counts",
    "get_timeline",
    "set_timeline",
]
