"""Heartbeats + stall watchdog — straggler/stall detection for the
train-while-serve stack.

A copy of ``flink_parameter_server_tpu/resilience/health.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

The straggler study (arxiv 2308.15482, PAPERS.md) is blunt about where a
PS loses throughput: not steady-state overhead but *silent* stalls — a
frozen source, a wedged device transfer, a serving thread stuck on a
dead snapshot.  None of those raise; they just stop beating.  So each
component (ingest, train loop, serving dispatch) calls
:meth:`HealthMonitor.beat` on its own thread at its natural cadence, and
one :class:`StallWatchdog` thread turns "no beat for T seconds" into an
OBSERVABLE event: a ``StepMetrics``-style JSON line on the metrics sink
plus an ``on_stall`` callback — which is where the supervisor
(:class:`~.recovery.RecoveringDriver`) or an operator hook plugs in
(e.g. ``driver.request_stop`` to force a drain + checkpoint out of a
half-stalled job).

Watchdog semantics: one stall event per episode — the component firing
re-arms only after it beats again, so a stalled source emits one event,
not one per poll.  Components register lazily (first beat) and a
component that has *never* beaten is not stalled (a job without serving
attached must not page about the serving heartbeat).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..telemetry.registry import get_registry, json_line

# canonical component names (any string works; these are what the
# driver/serving wiring uses, and what tests/docs refer to)
INGEST = "ingest"
TRAIN = "train"
SERVING = "serving_dispatch"


class HealthMonitor:
    """Thread-safe last-beat registry: ``beat(name)`` on the component's
    own thread, ``age(name)``/``stalled(threshold)`` from anywhere.

    Heartbeats also route through the unified telemetry plane: the
    first beat of each component registers a live probe gauge
    ``last_heartbeat_age_s{component=...}`` on ``registry`` (default:
    the process-wide one), so a stall is VISIBLE on ``/metrics`` — the
    age climbing scrape over scrape — before the watchdog fires.
    ``registry=False`` opts out (pure-unit tests with fake clocks)."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        *,
        registry=None,
    ):
        self._clock = clock
        self._lock = threading.Lock()
        self._last: Dict[str, float] = {}
        self._beats: Dict[str, int] = {}
        self._registry = registry
        self._gauged: set = set()

    def beat(self, component: str) -> None:
        now = self._clock()
        with self._lock:
            self._last[component] = now
            self._beats[component] = self._beats.get(component, 0) + 1
            first = component not in self._gauged
            if first:
                self._gauged.add(component)
        if first and self._registry is not False:
            reg = (
                self._registry if self._registry is not None
                else get_registry()
            )
            reg.gauge(
                "last_heartbeat_age_s", component=component,
                fn=lambda c=component: self.age(c),
            )

    def components(self) -> List[str]:
        with self._lock:
            return sorted(self._last)

    def beats(self, component: str) -> int:
        with self._lock:
            return self._beats.get(component, 0)

    def age(self, component: str) -> Optional[float]:
        """Seconds since the component last beat (None if it never has)."""
        with self._lock:
            last = self._last.get(component)
        return None if last is None else max(0.0, self._clock() - last)

    def ages(self) -> Dict[str, float]:
        now = self._clock()
        with self._lock:
            return {c: max(0.0, now - t) for c, t in self._last.items()}

    def stalled(self, threshold_s: float) -> List[str]:
        """Components whose last beat is older than ``threshold_s``."""
        return [c for c, a in self.ages().items() if a > threshold_s]


class StallWatchdog:
    """Background poller that turns missing heartbeats into events.

    ``on_stall(component, age_s)`` fires once per stall episode (per
    component), on the watchdog thread — keep it cheap and thread-safe;
    ``driver.request_stop`` and flag-setting both qualify.  ``sink``
    receives one JSON line per event (the driver's ``metrics_sink``
    contract), e.g.::

        {"stall": "ingest", "age_s": 5.2, "threshold_s": 2.0, ...}
    """

    def __init__(
        self,
        monitor: HealthMonitor,
        stall_after_s: float,
        *,
        on_stall: Optional[Callable[[str, float], None]] = None,
        poll_s: Optional[float] = None,
        sink=None,
        registry=None,
        flightrec=None,
    ):
        if stall_after_s <= 0:
            raise ValueError(f"stall_after_s={stall_after_s}: must be > 0")
        self.monitor = monitor
        self.stall_after_s = float(stall_after_s)
        self.on_stall = on_stall
        self.poll_s = (
            float(poll_s) if poll_s is not None else self.stall_after_s / 4
        )
        self.sink = sink
        # flight recorder (telemetry/flightrec.py): each stall episode
        # dumps the blackbox — a wedged process's post-mortem must not
        # depend on a live scrape.  None = the process-wide recorder
        # (no-op when none installed); False = never dump.
        self._flightrec = flightrec
        # unified plane: each stall episode also bumps
        # stall_episodes_total{component=<stalled>} (registry=False
        # opts out; None = the process-wide default)
        self._registry = registry
        self.events: List[dict] = []
        self._tripped: set = set()  # components in an open stall episode
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StallWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="stall-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the poll ----------------------------------------------------------
    def check_once(self) -> List[dict]:
        """One poll pass (the loop body, callable directly from tests):
        emit an event for each component newly past the threshold, re-arm
        components that beat again.  Returns the new events."""
        ages = self.monitor.ages()
        new_events = []
        with self._lock:
            for comp, age in ages.items():
                if age > self.stall_after_s:
                    if comp in self._tripped:
                        continue
                    self._tripped.add(comp)
                    event = {
                        "stall": comp,
                        "age_s": round(age, 3),
                        "threshold_s": self.stall_after_s,
                        "beats": self.monitor.beats(comp),
                    }
                    self.events.append(event)
                    new_events.append(event)
                else:
                    self._tripped.discard(comp)
        for event in new_events:
            if self._registry is not False:
                reg = (
                    self._registry if self._registry is not None
                    else get_registry()
                )
                reg.counter(
                    "stall_episodes_total", component=event["stall"]
                ).inc()
            if self._flightrec is not False:
                rec = self._flightrec
                if rec is None:
                    from ..telemetry.flightrec import get_recorder

                    rec = get_recorder()
                if rec is not None:
                    rec.note("stall", **event)
                    rec.dump(f"stall_{event['stall']}")
            if self.sink is not None:
                # one-JSON-per-episode stays; the line now carries the
                # shared ts/run_id like every other emitter
                json_line(event, self.sink)
            if self.on_stall is not None:
                self.on_stall(event["stall"], event["age_s"])
        return new_events

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_once()
            except Exception:  # a sink/callback error must not kill the
                pass           # watchdog — it would die exactly when needed


__all__ = [
    "HealthMonitor",
    "StallWatchdog",
    "INGEST",
    "TRAIN",
    "SERVING",
]
