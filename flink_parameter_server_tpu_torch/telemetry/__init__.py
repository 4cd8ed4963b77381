"""Telemetry plane of the port: the metrics registry, the host span tracer
and the flight recorder.

Copies of the JAX package's ``telemetry/registry.py``, ``spans.py`` and
``flightrec.py`` (none of them imports JAX; the flight recorder names its
results folder after the torch device type), and of ``profiler.py``, the
latency-budget phase profiler the TCP serving front end times its phases
with.  Of ``timeline.py`` only the windowed-percentile helper the elastic
controller reads is ported; the endpoint, report, the timeline recorder
and the hot-key modules wait for ROADMAP Queue 1 #7.
"""
from .flightrec import FlightRecorder, StormDetector, get_recorder, set_recorder
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
from .spans import SpanTracer, get_tracer, set_tracer, span

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
]
