"""SLO engine — declarative objectives evaluated as burn rates.

A copy of ``flink_parameter_server_tpu/telemetry/slo.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  The port's ``/metrics`` endpoint and run report
(``exporter.py``, ``report.py``) read its gauges and verdicts.

A threshold alert ("p99 > 25 ms") pages on one bad scrape and sleeps
through a slow bleed.  The SRE-standard fix is an ERROR BUDGET: an
objective like "99% of pulls complete within 25 ms" grants a 1% bad
budget, and the alert condition is the budget's BURN RATE — bad
fraction ÷ budget — evaluated over two windows at once: a short
window so a sudden regression fires fast, a long window so a
transient blip does not.  Burn 1.0 = exactly on budget; sustained
burn > ``page_burn`` on BOTH windows = a real breach.

:class:`SLOSpec` declares one objective over a registry metric:

  * ``kind="latency"`` — over a histogram (``metric``): an
    observation is GOOD when ≤ ``threshold``; good counts come from
    the bucket counts (linear interpolation inside the bucket holding
    the threshold, same approximation as
    :meth:`~.registry.Histogram.percentile`);
  * ``kind="bound"`` — over gauges (``metric``): each engine sample
    is one observation, GOOD when every matching gauge reads ≤
    ``threshold`` (staleness bounds, queue depths).

:class:`SLOEngine` samples the registry (explicitly via
:meth:`sample` or on its own poll thread), keeps a time-indexed ring
per objective, and exposes the verdicts three ways: probe gauges on
``/metrics`` (``fps_slo_burn_rate{slo=,window=}``,
``fps_slo_healthy{slo=}``), the ``slo`` section of ``run_report``,
and :meth:`verdicts` — which
:class:`~..elastic.controller.ElasticController` consumes as a
scale/replace pressure signal.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .registry import Histogram, MetricsRegistry, get_registry


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective: ``target`` fraction of observations
    of ``metric`` must be GOOD (≤ ``threshold``)."""

    name: str
    metric: str
    threshold: float
    target: float = 0.99
    kind: str = "latency"  # "latency" (histogram) | "bound" (gauge)

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"slo {self.name}: target={self.target} must be in (0, 1)"
            )
        if self.kind not in ("latency", "bound"):
            raise ValueError(
                f"slo {self.name}: kind={self.kind!r}: 'latency' | 'bound'"
            )


# -- the stock objectives the repo's planes ship with -------------------------
def pull_latency_slo(threshold_s: float = 0.025,
                     target: float = 0.99) -> SLOSpec:
    """Cluster pull RTT (``cluster_pull_rtt_seconds``) — the straggler
    signal the elastic controller already thresholds, as a budget."""
    return SLOSpec("pull_p99", "cluster_pull_rtt_seconds",
                   threshold_s, target)


def serving_latency_slo(threshold_s: float = 0.050,
                        target: float = 0.99) -> SLOSpec:
    return SLOSpec("serving_p99", "serving_latency_seconds",
                   threshold_s, target)


def staleness_slo(max_steps: float = 4.0, target: float = 0.95) -> SLOSpec:
    """SSP staleness spread stays within bound (gauge samples)."""
    return SLOSpec("staleness", "cluster_staleness_steps",
                   max_steps, target, kind="bound")


def recovery_time_slo(threshold_s: float = 5.0,
                      target: float = 0.9) -> SLOSpec:
    """Supervised recovery episodes (``recovery_duration_seconds``,
    observed by :class:`~..resilience.recovery.RecoveringDriver`)."""
    return SLOSpec("recovery_time", "recovery_duration_seconds",
                   threshold_s, target)


def failover_slo(threshold_s: float = 1.0,
                 target: float = 0.95) -> SLOSpec:
    """Replica-chain failovers (``replication_failover_seconds``,
    observed per promotion by replication/failover.py) — the
    sub-second availability budget docs/elastic.md promises: 95% of
    primary losses resolved by a follower flip within a second."""
    return SLOSpec("failover_time", "replication_failover_seconds",
                   threshold_s, target)


def default_slos() -> List[SLOSpec]:
    return [
        pull_latency_slo(),
        serving_latency_slo(),
        staleness_slo(),
        recovery_time_slo(),
        failover_slo(),
    ]


class SLOEngine:
    """Sample → ring → multi-window burn rates → verdicts.

    ``windows`` are (short, long) seconds; test-scale engines pass
    sub-second windows and drive :meth:`sample` with a fake clock.
    Verdicts per objective:

      * ``"ok"`` — short-window burn ≤ 1 (inside budget);
      * ``"burning"`` — short-window burn > 1 but not yet a
        sustained breach;
      * ``"breach"`` — burn > ``page_burn`` on BOTH windows (the
        page-worthy condition, and the controller's pressure signal);
      * ``"no_data"`` — nothing observed yet.
    """

    def __init__(
        self,
        slos: Optional[Sequence[SLOSpec]] = None,
        *,
        registry: Optional[MetricsRegistry] = None,
        windows: Tuple[float, float] = (60.0, 300.0),
        page_burn: float = 2.0,
        clock=time.monotonic,
        register_gauges: bool = True,
    ):
        short, long_ = float(windows[0]), float(windows[1])
        if not 0 < short < long_:
            raise ValueError(
                f"windows={windows}: need 0 < short < long"
            )
        self.slos = list(slos) if slos is not None else default_slos()
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.registry = registry if registry is not None else get_registry()
        self.windows = (short, long_)
        self.page_burn = float(page_burn)
        self._clock = clock
        self._lock = threading.Lock()
        # per slo: deque of (t, good_cumulative, total_cumulative)
        self._rings: Dict[str, deque] = {
            s.name: deque(maxlen=4096) for s in self.slos
        }
        # bound-kind objectives have no cumulative instrument to read —
        # each engine sample IS one observation, accumulated here
        self._bound_totals: Dict[str, list] = {
            s.name: [0.0, 0.0] for s in self.slos if s.kind == "bound"
        }
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if register_gauges:
            for spec in self.slos:
                for window in ("short", "long"):
                    self.registry.gauge(
                        "slo_burn_rate", component="slo", slo=spec.name,
                        window=window,
                        fn=lambda n=spec.name, w=window: self._burn(n, w),
                    )
                self.registry.gauge(
                    "slo_healthy", component="slo", slo=spec.name,
                    fn=lambda n=spec.name: (
                        1.0 if self.status(n)["verdict"] in ("ok", "no_data")
                        else 0.0
                    ),
                )

    # -- sampling ----------------------------------------------------------
    def _cumulative(self, spec: SLOSpec) -> Tuple[float, float]:
        """(good, total) cumulative observation counts for the spec —
        summed across every instrument sharing the metric name."""
        good = total = 0.0
        for inst in self.registry.instruments():
            if inst.name != spec.metric:
                continue
            if spec.kind == "latency":
                if not isinstance(inst, Histogram):
                    continue
                counts = inst.bucket_counts()
                bounds = inst.bounds
                t = float(sum(counts))
                g = 0.0
                lo = 0.0
                for b, c in zip(bounds, counts):
                    if b <= spec.threshold:
                        g += c
                    elif lo < spec.threshold:
                        # the bucket straddling the threshold: linear
                        # interpolation (the histogram's own percentile
                        # approximation, applied in reverse)
                        g += c * (spec.threshold - lo) / (b - lo)
                    lo = b
                total += t
                good += min(g, t)
            else:  # bound: gauges, one observation per engine sample
                v = inst.value
                if v is None:
                    continue
                total += 1.0
                if float(v) <= spec.threshold:
                    good += 1.0
        if spec.kind == "bound":
            # accumulate the point sample into the running totals (a
            # gauge read has no history of its own)
            acc = self._bound_totals[spec.name]
            acc[0] += good
            acc[1] += total
            return acc[0], acc[1]
        return good, total

    def sample(self) -> None:
        """One evaluation pass: append each objective's cumulative
        (good, total) to its ring, stamped with the engine clock."""
        now = self._clock()
        for spec in self.slos:
            good, total = self._cumulative(spec)
            with self._lock:
                self._rings[spec.name].append((now, good, total))

    # -- reads -------------------------------------------------------------
    def _window_delta(
        self, name: str, window_s: float
    ) -> Tuple[float, float]:
        """(bad, total) observed inside the trailing window."""
        with self._lock:
            ring = list(self._rings[name])
        if not ring:
            return 0.0, 0.0
        t_now, g_now, n_now = ring[-1]
        base = ring[0]
        for entry in ring:
            # oldest sample still inside the window; fall back to the
            # oldest sample we have (honest partial window at startup)
            if entry[0] >= t_now - window_s:
                base = entry
                break
        _t0, g0, n0 = base
        total = max(0.0, n_now - n0)
        bad = max(0.0, (n_now - g_now) - (n0 - g0))
        return bad, total

    def _burn(self, name: str, window: str) -> Optional[float]:
        spec = next((s for s in self.slos if s.name == name), None)
        if spec is None:
            return None
        w = self.windows[0] if window == "short" else self.windows[1]
        bad, total = self._window_delta(name, w)
        if total <= 0:
            return 0.0
        budget = 1.0 - spec.target
        return (bad / total) / budget

    def status(self, name: str) -> Dict[str, Any]:
        spec = next((s for s in self.slos if s.name == name), None)
        if spec is None:
            raise KeyError(f"no SLO named {name!r}")
        bad_s, total_s = self._window_delta(name, self.windows[0])
        bad_l, total_l = self._window_delta(name, self.windows[1])
        budget = 1.0 - spec.target
        burn_short = (bad_s / total_s) / budget if total_s > 0 else 0.0
        burn_long = (bad_l / total_l) / budget if total_l > 0 else 0.0
        if total_l <= 0 and total_s <= 0:
            verdict = "no_data"
        elif burn_short > self.page_burn and burn_long > self.page_burn:
            verdict = "breach"
        elif burn_short > 1.0:
            verdict = "burning"
        else:
            verdict = "ok"
        return {
            "slo": spec.name,
            "metric": spec.metric,
            "threshold": spec.threshold,
            "target": spec.target,
            "verdict": verdict,
            "burn_short": round(burn_short, 4),
            "burn_long": round(burn_long, 4),
            "window_total": total_s,
        }

    def verdicts(self) -> List[Dict[str, Any]]:
        return [self.status(s.name) for s in self.slos]

    def breached(self) -> List[str]:
        """Names of objectives currently in ``"breach"`` — the
        controller's pressure signal."""
        return [v["slo"] for v in self.verdicts() if v["verdict"] == "breach"]

    # -- the poll loop ------------------------------------------------------
    def start(self, interval_s: float = 1.0) -> "SLOEngine":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(float(interval_s),),
                name="slo-engine", daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — the sampler must survive
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "SLOEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = [
    "SLOEngine",
    "SLOSpec",
    "default_slos",
    "failover_slo",
    "pull_latency_slo",
    "recovery_time_slo",
    "serving_latency_slo",
    "staleness_slo",
]
