"""Tracing / profiling hooks.

Port of ``flink_parameter_server_tpu/training/tracing.py``.  The reference
traces with the JAX profiler and names phases with ``jax.named_scope``;
here :func:`profile_trace` records ``torch.profiler`` (host and card) and
writes a Chrome trace (``chrome://tracing`` / ui.perfetto.dev) into
``log_dir``, and :func:`scope` / :func:`annotate_step` are
``torch.profiler.record_function`` ranges, which show on that trace.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[None]:
    """Record ``torch.profiler`` (CPU, and CUDA when a card is present)
    around the block and write ``trace-<pid>-<ns>.json`` into ``log_dir``.

    Wrap a handful of steady-state steps, not the whole run: the first
    steps include the kernels' build and the allocator's warm-up."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        )


def scope(name: str):
    """Named range for phase attribution inside a step: shows up on the
    profiler's timeline.

    Usage::

        with tracing.scope("pull"):
            pulled = store.pull(ids)
    """
    return torch.profiler.record_function(name)


def annotate_step(fn, name: str = "ps_step"):
    """Wrap a step function so its whole body is one named range."""

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapped


# devices whose memory_stats raised — warned once per device, not once
# per poll (device_memory_stats is on gauge-scrape cadence) and never
# swallowed silently
_mem_stats_warned: set = set()


def device_memory_stats(device=None) -> dict:
    """Memory stats of the card ``device`` (default: the current CUDA
    device), as ``{"cuda:N": {"bytes_in_use": int, "peak_bytes": int}}``
    from ``torch.cuda.memory_stats``; ``{}`` for a CPU device or when no
    card is present.  Every entry carries exactly those two keys.  A
    card whose stats query raises is omitted and logged once (an
    unknown failure must be visible, not silently absorbed)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        stats = torch.cuda.memory_stats(index)
    except Exception as e:  # noqa: BLE001 — log once, keep polling
        key = f"cuda:{index}"
        if key not in _mem_stats_warned:
            _mem_stats_warned.add(key)
            logger.warning(
                "device_memory_stats: %s raised %s: %s "
                "(suppressing further warnings for this device)",
                key, type(e).__name__, e,
            )
        return {}
    return {
        f"cuda:{index}": {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
        }
    }


def register_device_memory_gauges(registry=None) -> int:
    """Register live probe gauges ``device_bytes_in_use{device=...}`` /
    ``device_peak_bytes{device=...}`` (component=train) on the unified
    plane for every device currently reporting stats; returns how many
    devices were wired.  Values resolve at scrape time — the endpoint
    sees CURRENT memory pressure, not enrollment-time numbers."""
    from ..telemetry import get_registry

    reg = registry if registry is not None else get_registry()
    wired = 0
    for name in device_memory_stats():
        def _probe(key, field):
            return lambda: device_memory_stats(key).get(key, {}).get(field)

        reg.gauge("device_bytes_in_use", component="train", device=name,
                  fn=_probe(name, "bytes_in_use"))
        reg.gauge("device_peak_bytes", component="train", device=name,
                  fn=_probe(name, "peak_bytes"))
        wired += 1
    return wired


__all__ = [
    "profile_trace",
    "scope",
    "annotate_step",
    "device_memory_stats",
    "register_device_memory_gauges",
]
