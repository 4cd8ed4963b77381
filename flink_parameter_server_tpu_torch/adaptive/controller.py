"""The adaptive control loop: detection → bounds → hedge → rebalance.

A copy of ``flink_parameter_server_tpu/adaptive/controller.py`` (host
code).

:class:`AdaptiveRuntime` is the glue.  It consumes the timeline
plane — worker-entity :class:`~..telemetry.timeline.SkewTracker`
verdicts plus NEW entries of the anomaly ledger (cursor idiom shared
with :class:`~..elastic.controller.ElasticController`) — and drives
the three actuators:

* :class:`~.bounds.BoundPolicy` widens/narrows the per-worker
  allowances on the driver's :class:`~.bounds.AdaptiveClock`;
* push hedging is passive from the loop's point of view (the
  :class:`~.hedge.PushHedger` races inside the client); the runtime
  aggregates its win/loss counts into the ``adaptive`` surface;
* :class:`~.rebalance.RebalancePolicy` re-routes row groups away from
  persistent stragglers.

Every action appends a decision record (bounded ring) and bumps a
``component=adaptive`` counter, so "what did the runtime do and why"
is one ``psctl adaptive`` read.  The loop re-reads ``driver.clock``
each tick — the driver builds a FRESH clock per run, and the runtime
must follow it, not gate a dead one.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .bounds import AdaptiveClock, BoundPolicy
from .rebalance import RebalancePolicy


class AdaptiveRuntime:
    """Closed-loop straggler adaptation over one cluster driver."""

    def __init__(
        self,
        driver,
        timeline,
        *,
        interval_s: float = 0.25,
        registry=None,
        clear_evals: int = 3,
        rebalance: Optional[RebalancePolicy] = None,
        metric: str = "cluster_pull_rtt_seconds",
        entity_label: str = "worker",
        max_decisions: int = 512,
    ):
        self.driver = driver
        self.timeline = timeline
        self.interval_s = float(interval_s)
        self.clear_evals = int(clear_evals)
        self.rebalance = rebalance
        self.metric = metric
        self.entity_label = entity_label
        self.decisions: deque = deque(maxlen=int(max_decisions))
        self._anomaly_cursor = 0
        self._clock: Optional[AdaptiveClock] = None
        self._bounds: Optional[BoundPolicy] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        if registry is None:
            from ..telemetry.registry import get_registry

            registry = get_registry()
        self.registry = registry if registry is not False else None
        self._g_bound: Dict[int, Any] = {}
        if self.registry is not None:
            reg = self.registry
            self._c_decisions = reg.counter(
                "adaptive_decisions_total", component="adaptive"
            )
            self._c_widen = reg.counter(
                "adaptive_bound_widenings_total", component="adaptive"
            )
            self._c_narrow = reg.counter(
                "adaptive_bound_narrowings_total", component="adaptive"
            )
            self._c_rebalance = reg.counter(
                "adaptive_rebalances_total", component="adaptive"
            )
        else:
            self._c_decisions = self._c_widen = None
            self._c_narrow = self._c_rebalance = None

    # -- detection ----------------------------------------------------------
    def _trackers(self):
        tl = self.timeline
        return [
            t for t in getattr(tl, "skew", ())
            if t.metric == self.metric
            and t.entity_label == self.entity_label
        ]

    def _flagged_workers(self, corroborated: bool) -> Dict[int, float]:
        """Worker index → skew ratio for currently-flagged verdicts.
        A new anomaly-ledger firing on the tracked metric corroborates
        the top entity even while the tracker is still in warmup
        (``corroborated``) — the two detection planes reinforce each
        other rather than one gating the other."""
        flagged: Dict[int, float] = {}
        for tracker in self._trackers():
            verdict = tracker.last
            if not verdict:
                continue
            try:
                worker = int(verdict["entity"])
            except (TypeError, ValueError):
                continue
            if (verdict["flagged"]
                    or (corroborated
                        and verdict["ratio"] >= tracker.ratio_threshold)):
                flagged[worker] = float(verdict["ratio"])
        return flagged

    # -- the loop body -------------------------------------------------------
    def step(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation (the thread calls this every ``interval_s``;
        tests call it directly for deterministic ticks).  Returns the
        decision records appended this tick."""
        now = time.time() if now is None else now
        self.ticks += 1
        new_anoms, self._anomaly_cursor = self.timeline.anomalies_since(
            self._anomaly_cursor
        )
        corroborated = any(
            a.get("metric") == self.metric for a in new_anoms
        )
        clock = getattr(self.driver, "clock", None)
        if not isinstance(clock, AdaptiveClock):
            return []
        if clock is not self._clock:
            # fresh clock per run: allowances and hysteresis restart
            self._clock = clock
            self._bounds = BoundPolicy(
                clock, clear_evals=self.clear_evals
            )
        flagged = self._flagged_workers(corroborated)
        out: List[dict] = []
        out.extend(self._bounds.observe(flagged))
        if self.rebalance is not None:
            current_round = max(clock.clocks(), default=0)
            out.extend(
                self.rebalance.observe(flagged, now, current_round)
            )
        for rec in out:
            rec.setdefault("ts", round(now, 6))
            self.decisions.append(rec)
            if self._c_decisions is not None:
                self._c_decisions.inc()
                if rec["action"] == "widen":
                    self._c_widen.inc()
                elif rec["action"] == "narrow":
                    self._c_narrow.inc()
                elif rec["action"] == "reroute":
                    self._c_rebalance.inc()
        self._publish_bounds(clock)
        return out

    def _publish_bounds(self, clock: AdaptiveClock) -> None:
        if self.registry is None:
            return
        for w, bound in enumerate(clock.effective_bounds()):
            g = self._g_bound.get(w)
            if g is None:
                g = self.registry.gauge(
                    "adaptive_effective_bound", component="adaptive",
                    worker=str(w),
                )
                self._g_bound[w] = g
            g.set(bound)

    # -- surfaces ------------------------------------------------------------
    def _hedge_stats(self) -> Dict[str, int]:
        issued = won = 0
        for client in getattr(self.driver, "_clients", ()) or ():
            h = getattr(client, "push_hedge", None)
            if h is not None:
                issued += h.hedges_issued
                won += h.hedges_won
        return {"issued": issued, "won": won}

    def payload(self) -> dict:
        """The ``adaptive`` wire shape (TelemetryServer path, psctl
        table, run-report section)."""
        clock = getattr(self.driver, "clock", None)
        adaptive = isinstance(clock, AdaptiveClock)
        workers: List[dict] = []
        ratios: Dict[int, float] = {}
        for tracker in self._trackers():
            verdict = tracker.last
            if not verdict:
                continue
            medians = verdict.get("medians") or {}
            vals = sorted(medians.values())
            if vals:
                mid = vals[len(vals) // 2]
                baseline = max(abs(mid), 1e-12)
                for e, m in medians.items():
                    try:
                        ratios[int(e)] = m / baseline
                    except (TypeError, ValueError):
                        continue
        if adaptive:
            bounds = clock.effective_bounds()
            for w, bound in enumerate(bounds):
                workers.append({
                    "worker": w,
                    "effective_bound": bound,
                    "skew_ratio": round(ratios.get(w, 1.0), 4),
                })
        hedge = self._hedge_stats()
        return {
            "kind": "adaptive",
            "adaptive": adaptive,
            "base_bound": getattr(clock, "bound", None),
            "bound_ceiling": getattr(clock, "bound_ceiling", None),
            "workers": workers,
            "hedge": hedge,
            "rebalance": {
                "moves": (
                    self.rebalance.moves
                    if self.rebalance is not None else 0
                ),
                "assignments": (
                    self.rebalance.router.assignments()
                    if self.rebalance is not None
                    and self.rebalance.router is not None else []
                ),
            },
            "counts": {
                "widenings": (
                    self._bounds.widenings
                    if self._bounds is not None else 0
                ),
                "narrowings": (
                    self._bounds.narrowings
                    if self._bounds is not None else 0
                ),
            },
            "decisions": list(self.decisions),
            "ticks": self.ticks,
        }

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "AdaptiveRuntime":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="adaptive-runtime", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "AdaptiveRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- the process-wide default -------------------------------------------------
# Same discipline as the timeline recorder: never created lazily.  No
# runtime installed means the `adaptive` telemetry path answers null
# and no control thread runs.
_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[AdaptiveRuntime] = None


def get_adaptive_runtime() -> Optional[AdaptiveRuntime]:
    with _DEFAULT_LOCK:
        return _DEFAULT


def set_adaptive_runtime(
    runtime: Optional[AdaptiveRuntime],
) -> Optional[AdaptiveRuntime]:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = runtime
    return runtime


__all__ = [
    "AdaptiveRuntime",
    "get_adaptive_runtime",
    "set_adaptive_runtime",
]
