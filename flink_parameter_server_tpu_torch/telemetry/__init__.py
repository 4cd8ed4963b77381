"""Telemetry plane of the port: measurement, detection and surfaces.

Copies of the JAX package's ``telemetry/registry.py``, ``spans.py``,
``flightrec.py``, ``profiler.py``, ``distributed.py`` and
``lockwitness.py`` (none of them imports JAX; the flight recorder names
its results folder after the torch device type), the detection half of
the plane:

  * :mod:`.hotkeys` — count-min + space-saving hot-key sketches over
    pull/push/serving key traffic, merged across shards by the
    :class:`HotKeyAggregator`, whose final top-K ranks on the card;
  * :mod:`.slo` — declarative objectives evaluated as multi-window burn
    rates, consumable by the elastic controller;
  * :mod:`.timeline` — the time axis: a sampler polling the registry into
    bounded per-instrument ring series, plus the :class:`SkewTracker`
    per-entity straggler attribution;
  * :mod:`.detectors` — online anomaly detectors (EWMA drift +
    rolling-MAD outlier) riding the timeline's samples;

and the surfaces that serve them:

  * :mod:`.exporter` — Prometheus-text rendering + the TCP ``/metrics``,
    ``/healthz``, ``/hotkeys``, ``/hot``, ``/budget``, ``/conns``,
    ``/timeline``, ``/workloads``, ``/adaptive`` (the installed
    adaptive runtime) and ``/tiers`` (the registered tiered stores)
    endpoint;
  * :mod:`.report` — ``results/<platform>/run_report.{md,json}``;
  * :mod:`.lockwitness` — the runtime lock-order witness (opt-in; nothing
    imports it).
"""
from .detectors import EWMADriftDetector, RollingMADDetector
from .distributed import (
    TraceCollector,
    TraceContext,
    format_token,
    new_trace,
    parse_token,
)
from .exporter import TelemetryServer, prometheus_text, scrape
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
from .profiler import (
    PHASES,
    PhaseProfiler,
    StackSampler,
    get_profiler,
    set_profiler,
)
from .report import build_run_report, render_markdown, write_run_report
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
    "TelemetryServer",
    "prometheus_text",
    "scrape",
    "build_run_report",
    "render_markdown",
    "write_run_report",
    "TraceCollector",
    "TraceContext",
    "format_token",
    "new_trace",
    "parse_token",
    "PHASES",
    "PhaseProfiler",
    "StackSampler",
    "get_profiler",
    "set_profiler",
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
