"""A copy of ``flink_parameter_server_tpu/telemetry/registry.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

Unified metric registry — the single seam every subsystem measures
through.

Before this module, `training/metrics.py`, `serving/metrics.py` and
`resilience/health.py` each invented their own JSON-ish emit format and
nothing correlated a slow step with ingest stalls, serving admission
pressure, or a recovery replay.  The straggler study (arXiv:2308.15482,
PAPERS.md) diagnoses PS slowdowns from exactly that cross-component
timeline, and the elastic-aggregation line of work (arXiv:2204.03211)
assumes a queryable live metrics surface.  This registry is both: a
process-wide, thread-safe table of typed instruments (Counter, Gauge,
Histogram) carrying ``component=train|serving|ingest|recovery`` labels,
snapshot-able at any moment (the ``/metrics`` endpoint in
``exporter.py`` renders it live) and emittable as one JSON line per
sample (the sink contract the three legacy emitters now publish
through).

Identity: an instrument is (name, sorted label set).  Asking twice for
the same identity returns the same instrument; asking with a different
type raises — a counter silently shadowed by a gauge is the classic
way dashboards lie.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# -- run identity -------------------------------------------------------------
# One id per process by default, shared by every emitter so interleaved
# JSON lines from train/serve/recover correlate without guesswork.
_RUN_ID_LOCK = threading.Lock()
_RUN_ID: Optional[str] = None


def default_run_id() -> str:
    """Process-wide run id (pid + start-time; stable for the process)."""
    global _RUN_ID
    with _RUN_ID_LOCK:
        if _RUN_ID is None:
            _RUN_ID = f"{os.getpid():x}-{int(time.time() * 1e3) & 0xFFFFFFFF:08x}"
        return _RUN_ID


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic accumulator (events, steps, rejects, restarts)."""

    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value.  Either ``set()`` stored values or a live
    ``fn`` probe (queue depth, heartbeat age) resolved at read time —
    a stored gauge read mid-stall would report the pre-stall value,
    which is exactly the lie the probe form exists to avoid."""

    kind = "gauge"

    def __init__(
        self,
        name: str,
        labels: Dict[str, str],
        fn: Optional[Callable[[], Optional[float]]] = None,
    ):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value: Optional[float] = None
        self._fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_fn(self, fn: Callable[[], Optional[float]]) -> None:
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> Optional[float]:
        with self._lock:
            fn = self._fn
            stored = self._value
        if fn is not None:
            try:
                v = fn()
            except Exception:  # a dead probe must not kill a scrape
                return None
            return None if v is None else float(v)
        return stored


# Default histogram boundaries: seconds, spanning sub-ms device steps
# through multi-second recovery episodes (upper bounds; +inf implicit).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram:
    """Fixed-boundary histogram (Prometheus-shaped: per-bucket counts,
    sum, count).  Boundaries are upper bounds of non-cumulative bins;
    the overflow bin is implicit.  ``percentile`` interpolates linearly
    within the winning bin — approximate by construction, but stable
    under concurrency and O(buckets) to read, which is what a live
    ``/metrics`` scrape needs."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        labels: Dict[str, str],
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(bounds) or len(
            set(bounds)
        ) != len(bounds):
            raise ValueError(
                f"histogram {name}: buckets must be a non-empty strictly "
                f"increasing sequence, got {buckets!r}"
            )
        self.name = name
        self.labels = dict(labels)
        self.bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # last = overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # bisect by hand to stay allocation-free under the lock
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._sum += v
            self._count += 1

    # -- reads ------------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def bucket_counts(self) -> List[int]:
        """Non-cumulative per-bin counts (len(bounds) + 1, overflow last)."""
        with self._lock:
            return list(self._counts)

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) by linear
        interpolation inside the winning bin; the overflow bin clamps to
        the largest finite boundary (an honest floor, not a guess)."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q={q}: must be in [0, 100]")
        counts = self.bucket_counts()
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = q / 100.0 * total
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= rank and c > 0:
                if i == len(self.bounds):  # overflow bin
                    return self.bounds[-1]
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i]
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            seen += c
        return self.bounds[-1]

    @property
    def value(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "buckets": list(self._counts),
            }


class MetricsRegistry:
    """Thread-safe instrument table + JSON-lines sink.

    ``counter/gauge/histogram`` are get-or-create by (name, labels);
    ``snapshot()`` is a consistent-enough point-in-time read (each
    instrument is internally consistent; cross-instrument skew is
    bounded by one lock hop), ``emit(sink)`` writes ONE single-line
    JSON sample carrying the shared ``ts``/``run_id`` fields every
    emitter in the repo now stamps.
    """

    def __init__(self, run_id: Optional[str] = None):
        self._lock = threading.Lock()
        self._instruments: Dict[
            Tuple[str, Tuple[Tuple[str, str], ...]], Any
        ] = {}
        self.run_id = run_id if run_id is not None else default_run_id()
        self.created_at = time.time()

    # -- instrument accessors ---------------------------------------------
    def _get_or_create(self, cls, name: str, labels: Dict[str, str],
                       **kwargs):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels, **kwargs)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"instrument {name}{labels} already registered as "
                    f"{inst.kind}, requested {cls.kind}"
                )
            return inst

    def counter(self, name: str, *, component: Optional[str] = None,
                **labels: str) -> Counter:
        if component is not None:
            labels["component"] = component
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, *, component: Optional[str] = None,
              fn: Optional[Callable[[], Optional[float]]] = None,
              **labels: str) -> Gauge:
        if component is not None:
            labels["component"] = component
        g = self._get_or_create(Gauge, name, labels)
        if fn is not None:
            g.set_fn(fn)
        return g

    def histogram(self, name: str, *, component: Optional[str] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        if component is not None:
            labels["component"] = component
        h = self._get_or_create(Histogram, name, labels, buckets=buckets)
        if tuple(float(b) for b in buckets) != h.bounds:
            raise ValueError(
                f"histogram {name}{labels}: bucket boundaries differ from "
                f"the registered instrument's"
            )
        return h

    def instruments(self) -> List[Any]:
        with self._lock:
            return list(self._instruments.values())

    # -- reads -------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """``{name: [{"labels": {...}, "kind": ..., "value": ...}, ...]}``
        — gauges resolve their live probes here; a probe that fails or
        returns None yields value None (visible, not invented)."""
        out: Dict[str, Any] = {}
        for inst in self.instruments():
            v = inst.value
            if isinstance(v, float) and (
                math.isnan(v) or math.isinf(v)
            ):
                v = None  # JSON has no inf/nan; a poisoned gauge shows
                # as null rather than producing an unparseable line
            out.setdefault(inst.name, []).append(
                {"labels": dict(inst.labels), "kind": inst.kind, "value": v}
            )
        return out

    def emit(self, sink=None) -> str:
        """One single-line JSON sample of the whole registry (the
        JSON-lines sink contract; round-trips through ``json.loads``)."""
        return json_line(
            {"kind": "registry", "metrics": self.snapshot()},
            sink, run_id=self.run_id,
        )


def _finite(v):
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return None
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_finite(x) for x in v]
    return v


def json_line(payload: Dict[str, Any], sink=None, *,
              run_id: Optional[str] = None) -> str:
    """The one emit path every JSON-lines emitter in the repo funnels
    through: stamp the shared ``ts``/``run_id`` fields, null out
    non-finite floats (strict JSON has no NaN/Infinity), and guarantee
    the result is a single line that round-trips ``json.loads``."""
    body = {"ts": round(time.time(), 3),
            "run_id": run_id if run_id is not None else default_run_id()}
    body.update({k: _finite(v) for k, v in payload.items()})
    line = json.dumps(body, allow_nan=False)
    assert "\n" not in line  # json.dumps without indent never wraps
    if sink is not None:
        sink.write(line + "\n")
    return line


# -- the process-wide default -------------------------------------------------
_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (created on first use).  Every
    subsystem publishes here unless handed an explicit registry — which
    is what makes one ``/metrics`` endpoint see train, serve, ingest
    and recovery at once."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


def set_registry(registry: Optional[MetricsRegistry]) -> None:
    """Swap the process default (tests isolate themselves with this;
    None resets to lazy re-creation)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = registry


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "default_run_id",
    "json_line",
    "get_registry",
    "set_registry",
]
