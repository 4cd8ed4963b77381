"""Flight recorder — a bounded blackbox for post-mortems.

A copy of ``flink_parameter_server_tpu/telemetry/flightrec.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

A live ``/metrics`` scrape answers "what is happening"; it answers
nothing once the process is wedged or dead.  The flight recorder is
the other half: every process keeps a bounded ring of recent
OPERATIONAL events (WAL/epoch flips, migrations, restarts, stalls,
storms — noted explicitly via :meth:`FlightRecorder.note`), and on a
trigger dumps that ring TOGETHER with the span-tracer tail and a full
registry snapshot to ``results/<platform>/flightrec_<reason>.json`` —
so the post-mortem starts from a file, not from hoping someone was
scraping at 3 a.m.

Triggers (wired across the repo, each falls back to the process-wide
recorder installed via :func:`set_recorder` — no recorder installed
means no files written, ever):

  * **stall watchdog** — :class:`~..resilience.health.StallWatchdog`
    dumps once per stall episode (``flightrec_stall_<component>``);
  * **crash** — :class:`~..resilience.recovery.RecoveringDriver`
    dumps before each supervised restart
    (``flightrec_crash_<failure_class>``);
  * **stale-epoch storm** — :class:`~..cluster.client.ClusterClient`
    dumps when membership-refresh retries exceed the storm threshold
    inside the window (``flightrec_stale_epoch_storm``) — the
    signature of a flip that clients cannot converge on.

Dumps are throttled per reason (``min_dump_interval_s``) so a storm
produces one artifact, not one per retry.  The dump format is linted
by ``tools/check_metric_lines.py --flightrec`` (valid JSON object,
``reason``/``pid``/``run_id``/``events`` present, every event carries
a numeric ``ts``).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .registry import MetricsRegistry, _finite, default_run_id
from .spans import SpanTracer


class StormDetector:
    """Edge-triggered rate trip: ``note()`` returns True exactly when
    the noted-event count inside ``window_s`` first crosses
    ``threshold`` (then re-arms only after the window quiets down) —
    the stale-epoch-storm trigger, reusable for any event flood."""

    def __init__(
        self,
        threshold: int = 25,
        window_s: float = 5.0,
        clock=time.monotonic,
    ):
        if threshold < 1 or window_s <= 0:
            raise ValueError(
                f"threshold={threshold}, window_s={window_s}: need "
                f"threshold >= 1 and window_s > 0"
            )
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._times: deque = deque()
        self._tripped = False
        self.storms = 0

    def note(self) -> bool:
        now = self._clock()
        with self._lock:
            self._times.append(now)
            cutoff = now - self.window_s
            while self._times and self._times[0] < cutoff:
                self._times.popleft()
            if len(self._times) >= self.threshold:
                if self._tripped:
                    return False
                self._tripped = True
                self.storms += 1
                return True
            self._tripped = False
            return False


class FlightRecorder:
    """Bounded event ring + the dump path.

    ``note(kind, **fields)`` is the hot-path API: one dict appended to
    a deque under a lock — cheap enough for epoch flips, restarts and
    stall events (NOT per-push; per-request traffic belongs in the
    registry/sketches, the recorder keeps the OPERATIONAL timeline).

    ``dump(reason)`` assembles the blackbox: the event ring, the last
    ``span_tail`` spans of ``tracer`` (when attached), and a full
    snapshot of ``registry``; writes
    ``results/<platform>/flightrec_<reason>.json`` and returns the
    path (``None`` when throttled)."""

    def __init__(
        self,
        capacity: int = 1024,
        *,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[SpanTracer] = None,
        span_tail: int = 256,
        min_dump_interval_s: float = 5.0,
        results_dir: Optional[str] = None,
        platform: Optional[str] = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity={capacity}: must be >= 1")
        self.registry = registry
        self.tracer = tracer
        self.span_tail = int(span_tail)
        self.min_dump_interval_s = float(min_dump_interval_s)
        self.results_dir = results_dir
        self.platform = platform
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(capacity))
        self._last_dump: Dict[str, float] = {}
        self.dumps: List[str] = []

    # -- the ring ----------------------------------------------------------
    def note(self, kind: str, **fields: Any) -> None:
        event = {"ts": round(time.time(), 6), "kind": str(kind)}
        event.update(fields)
        with self._lock:
            self._events.append(event)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    # -- the dump ----------------------------------------------------------
    def _dir(self) -> str:
        if self.results_dir is not None:
            return self.results_dir
        repo = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        platform = self.platform
        if platform is None:
            import torch

            platform = "cuda" if torch.cuda.is_available() else "cpu"
        return os.path.join(repo, "results", platform)

    def dump(self, reason: str, *, force: bool = False) -> Optional[str]:
        reason_slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", str(reason)) or "unknown"
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason_slug)
            if (
                not force
                and last is not None
                and now - last < self.min_dump_interval_s
            ):
                return None
            self._last_dump[reason_slug] = now
            events = list(self._events)
        doc: Dict[str, Any] = {
            "reason": str(reason),
            "pid": os.getpid(),
            "run_id": (
                self.registry.run_id if self.registry is not None
                else default_run_id()
            ),
            "generated_at": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "ts": round(time.time(), 3),
            "events": events,
        }
        if self.tracer is not None:
            doc["spans"] = self.tracer.spans()[-self.span_tail:]
        if self.registry is not None:
            doc["metrics"] = self.registry.snapshot()
        out_dir = self._dir()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"flightrec_{reason_slug}.json")
        with open(path, "w") as f:
            json.dump(_finite(doc), f, indent=2)
            f.write("\n")
        with self._lock:
            self.dumps.append(path)
        return path


# -- the process-wide default -------------------------------------------------
# Deliberately NOT created lazily: with no recorder installed the
# trigger sites are no-ops, so unit tests and library users never find
# surprise artifacts under results/.
_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[FlightRecorder] = None


def get_recorder() -> Optional[FlightRecorder]:
    with _DEFAULT_LOCK:
        return _DEFAULT


def set_recorder(rec: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = rec
    return rec


__all__ = [
    "FlightRecorder",
    "StormDetector",
    "get_recorder",
    "set_recorder",
]
