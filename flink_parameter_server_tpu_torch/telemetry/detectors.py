"""Online anomaly detectors over timeline series.

A copy of ``flink_parameter_server_tpu/telemetry/detectors.py``, which
imports no JAX: the port imports nothing of the JAX package, whose
``__init__`` imports JAX.

Two deliberately simple, O(1)-per-point (or O(window)) detectors that
run INSIDE the :class:`~.timeline.TimelineRecorder` sample loop —
cheap enough to ride every poll, strong enough to catch the two
failure shapes the straggler study (arXiv:2308.15482, PAPERS.md) says
matter:

  * :class:`EWMADriftDetector` — exponentially-weighted mean/variance
    per series; fires when a point lands ``k`` EW-sigmas from the EW
    mean.  Catches LEVEL SHIFTS (a shard's RTT steps up and stays up)
    and then adapts: the state keeps absorbing points, so a sustained
    shift fires once per episode, not forever.
  * :class:`RollingMADDetector` — rolling median + median-absolute-
    deviation window per series; fires on robust z
    (``|x - med| / (1.4826 * MAD)``) past ``k``.  Catches OUTLIER
    SPIKES without the mean/variance being dragged by the spike
    itself (the classic EWMA blind spot), at O(window log window) per
    point over a small window.

Both are edge-triggered with hysteresis: one anomaly record at
episode START, silence while the episode persists, re-arm only after
the score drops below ``rearm_fraction * k``.  That is what makes
"one flightrec dump per episode" structural rather than throttle-luck,
and what keeps ``timeline_anomalies_total{metric,kind}`` a count of
EPISODES, not of samples spent inside one.

Scale floors (``rel_floor``/``abs_floor``) keep a near-constant series
from manufacturing infinite z-scores out of float jitter — the
documented zero-false-positive contract on stationary noise
(tests/test_timeline.py pins it against a numpy reference).

Detectors are metric-scoped (``metric`` + optional derived ``field``
— "rate", "value", "p50", "p99") and keep independent state per label
set, so one detector instance watches every shard/worker series of
its metric at once.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .registry import _label_key


def _scale_floor(scale: float, center: float, rel_floor: float,
                 abs_floor: float) -> float:
    return max(scale, rel_floor * abs(center), abs_floor)


class _EpisodeState:
    """Edge-trigger bookkeeping shared by both detectors."""

    __slots__ = ("active", "episode_started", "peak_score", "n")

    def __init__(self):
        self.active = False
        self.episode_started: Optional[float] = None
        self.peak_score = 0.0
        self.n = 0


class _BaseDetector:
    """Match + per-label-set state + edge-triggered episode ledger.

    Subclasses implement :meth:`_score_and_update` (score the point
    against the series state, then absorb it); this base decides
    warmup, firing edges, hysteresis re-arm, and the anomaly record
    shape the recorder consumes.
    """

    kind = "base"

    def __init__(
        self,
        metric: str,
        *,
        field: Optional[str] = None,
        k: float = 4.0,
        warmup: int = 10,
        rearm_fraction: float = 0.5,
        rel_floor: float = 0.05,
        abs_floor: float = 1e-9,
    ):
        if k <= 0 or warmup < 2:
            raise ValueError(
                f"k={k}, warmup={warmup}: need k > 0 and warmup >= 2"
            )
        if not 0.0 < rearm_fraction <= 1.0:
            raise ValueError(
                f"rearm_fraction={rearm_fraction}: must be in (0, 1]"
            )
        self.metric = metric
        self.field = field
        self.k = float(k)
        self.warmup = int(warmup)
        self.rearm_fraction = float(rearm_fraction)
        self.rel_floor = float(rel_floor)
        self.abs_floor = float(abs_floor)
        self._lock = threading.Lock()
        self._state: Dict[Tuple[Tuple[str, str], ...], Any] = {}
        self._episodes: Dict[
            Tuple[Tuple[str, str], ...], _EpisodeState
        ] = {}
        self.episodes: List[dict] = []  # closed + open episode ledger

    # -- subclass seam -----------------------------------------------------
    def _new_state(self) -> Any:
        raise NotImplementedError

    def _score_and_update(self, state: Any,
                          value: float) -> Optional[float]:
        """Return the point's score vs the PRE-UPDATE state (None while
        warming up), then absorb the point into the state."""
        raise NotImplementedError

    # -- the recorder-facing API -------------------------------------------
    def observe(self, name: str, labels: Dict[str, str], field: str,
                value: float, ts: float) -> Optional[dict]:
        """Score one timeline point; returns an anomaly record exactly
        at episode start, else None."""
        if name != self.metric:
            return None
        if self.field is not None and field != self.field:
            return None
        key = _label_key(labels)
        with self._lock:
            state = self._state.get(key)
            if state is None:
                state = self._new_state()
                self._state[key] = state
                self._episodes[key] = _EpisodeState()
            ep = self._episodes[key]
            score = self._score_and_update(state, float(value))
            ep.n += 1
            if score is None:
                return None
            if ep.active:
                ep.peak_score = max(ep.peak_score, score)
                if score < self.k * self.rearm_fraction:
                    ep.active = False  # episode over; re-armed
                return None
            if score <= self.k:
                return None
            ep.active = True
            ep.episode_started = ts
            ep.peak_score = score
            record = {
                "ts": round(ts, 6),
                "metric": self.metric,
                "labels": dict(labels),
                "field": field,
                "kind": self.kind,
                "value": value,
                "score": round(score, 4),
                "threshold": self.k,
            }
            self.episodes.append(record)
            return record


class EWMADriftDetector(_BaseDetector):
    """EW mean/variance drift detector (level shifts).

    State per series: EW mean ``m`` and EW variance ``v`` with
    smoothing ``alpha`` (West 1979 incremental form:
    ``d = x - m;  m += alpha*d;  v = (1-alpha)*(v + alpha*d*d)``).
    Score = ``|x - m_pre| / max(sqrt(v_pre), floors)``.  The state
    absorbs every point INCLUDING anomalous ones — a sustained level
    shift therefore fires at its leading edge and then becomes the
    new normal, which is exactly the drift (not outlier) semantics.
    """

    kind = "ewma_drift"

    def __init__(self, metric: str, *, field: Optional[str] = None,
                 alpha: float = 0.2, k: float = 4.0, warmup: int = 10,
                 **kwargs):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha={alpha}: must be in (0, 1)")
        super().__init__(metric, field=field, k=k, warmup=warmup,
                         **kwargs)
        self.alpha = float(alpha)

    def _new_state(self) -> dict:
        return {"n": 0, "mean": 0.0, "var": 0.0}

    def _score_and_update(self, state: dict,
                          value: float) -> Optional[float]:
        score: Optional[float] = None
        if state["n"] >= self.warmup:
            sigma = _scale_floor(
                math.sqrt(max(0.0, state["var"])), state["mean"],
                self.rel_floor, self.abs_floor,
            )
            score = abs(value - state["mean"]) / sigma
        if state["n"] == 0:
            state["mean"] = value
        else:
            d = value - state["mean"]
            incr = self.alpha * d
            state["mean"] += incr
            state["var"] = (1.0 - self.alpha) * (
                state["var"] + d * incr
            )
        state["n"] += 1
        return score


class RollingMADDetector(_BaseDetector):
    """Rolling median/MAD outlier detector (spikes).

    State per series: a bounded window of recent points.  Score =
    ``|x - median| / max(1.4826 * MAD, floors)`` — the robust z-score
    (1.4826 makes MAD a consistent sigma estimator under normality).
    Median and MAD shrug off the spike itself, so a single wild point
    cannot raise the bar for detecting the next one.
    """

    kind = "mad_outlier"

    def __init__(self, metric: str, *, field: Optional[str] = None,
                 window: int = 24, k: float = 6.0, warmup: int = 12,
                 **kwargs):
        if window < 4:
            raise ValueError(f"window={window}: must be >= 4")
        super().__init__(metric, field=field, k=k, warmup=warmup,
                         **kwargs)
        if self.warmup > window:
            raise ValueError(
                f"warmup={warmup} > window={window}: the warmup bar "
                f"could never be met from a full window"
            )
        self.window = int(window)

    def _new_state(self) -> deque:
        return deque(maxlen=self.window)

    @staticmethod
    def _median(sorted_vals: List[float]) -> float:
        n = len(sorted_vals)
        mid = n // 2
        if n % 2:
            return sorted_vals[mid]
        return 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid])

    def _score_and_update(self, state: deque,
                          value: float) -> Optional[float]:
        score: Optional[float] = None
        if len(state) >= self.warmup:
            vals = sorted(state)
            med = self._median(vals)
            mad = self._median(sorted(abs(v - med) for v in vals))
            scale = _scale_floor(
                1.4826 * mad, med, self.rel_floor, self.abs_floor
            )
            score = abs(value - med) / scale
        state.append(value)
        return score


__all__ = ["EWMADriftDetector", "RollingMADDetector"]
