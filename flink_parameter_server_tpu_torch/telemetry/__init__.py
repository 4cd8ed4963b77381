"""Telemetry plane of the port: measurement and detection.

Copies of the JAX package's ``telemetry/registry.py``, ``spans.py``,
``flightrec.py`` and ``profiler.py`` (none of them imports JAX; the flight
recorder names its results folder after the torch device type), and the
detection half of the plane:

  * :mod:`.hotkeys` — count-min + space-saving hot-key sketches over
    pull/push/serving key traffic, merged across shards by the
    :class:`HotKeyAggregator`, whose final top-K ranks on the card;
  * :mod:`.slo` — declarative objectives evaluated as multi-window burn
    rates, consumable by the elastic controller;
  * :mod:`.timeline` — the time axis: a sampler polling the registry into
    bounded per-instrument ring series, plus the :class:`SkewTracker`
    per-entity straggler attribution;
  * :mod:`.detectors` — online anomaly detectors (EWMA drift +
    rolling-MAD outlier) riding the timeline's samples.

The surfaces that serve them — the ``/metrics`` endpoint, the run report
and the lock witness — wait for ROADMAP Queue 1 #7b2.
"""
from .detectors import EWMADriftDetector, RollingMADDetector
from .flightrec import FlightRecorder, StormDetector, get_recorder, set_recorder
from .hotkeys import (
    HotKeyAggregator,
    HotKeySketch,
    SpaceSavingTopK,
    get_aggregator,
    set_aggregator,
)
from .registry import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_run_id,
    get_registry,
    json_line,
    set_registry,
)
from .slo import SLOEngine, SLOSpec, default_slos
from .spans import SpanTracer, get_tracer, set_tracer, span
from .timeline import (
    SkewTracker,
    TimelineRecorder,
    get_timeline,
    percentile_from_counts,
    set_timeline,
)

__all__ = [
    "FlightRecorder",
    "StormDetector",
    "get_recorder",
    "set_recorder",
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_run_id",
    "get_registry",
    "json_line",
    "set_registry",
    "SpanTracer",
    "get_tracer",
    "set_tracer",
    "span",
    "HotKeyAggregator",
    "HotKeySketch",
    "SpaceSavingTopK",
    "get_aggregator",
    "set_aggregator",
    "SLOEngine",
    "SLOSpec",
    "default_slos",
    "TimelineRecorder",
    "SkewTracker",
    "percentile_from_counts",
    "get_timeline",
    "set_timeline",
    "EWMADriftDetector",
    "RollingMADDetector",
]
