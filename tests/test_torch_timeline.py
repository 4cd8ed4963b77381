"""The port's timeline plane (``telemetry/timeline.py`` + ``detectors.py``)
against the JAX package's, on the CPU.

Mirrors 26 of tests/test_timeline.py's 31 tests: TestPercentileFromCounts
(4), TestDetectorOracles (7), TestTimelineRecorder (9), TestSkewTracker (5)
and TestElasticPressure (1, through the port's ``ElasticClusterDriver`` with
``device="cpu"``).  TestSurfaces (2) is mirrored with the ``/metrics``
endpoint in tests/test_torch_telemetry_surfaces.py; TestTooling (3) waits
for the lint and the committed artifact (ROADMAP Queue 1 #7h).  The mirrors hold the same numpy oracles the
reference's tests hold; the background-loop mirror polls with a bounded
deadline and then checks that the thread is gone.

Parity with the reference (both sides are numpy and Python):
  * the same seeded series through both packages' detectors give the same
    firing indices and the same scores (rtol 1e-12);
  * ``percentile_from_counts`` gives the same floats on the same counts;
  * the same registry traffic, sampled on the same scripted clock, gives
    equal ``TimelineRecorder.payload()`` documents (series, anomalies,
    skew verdicts and marks, timestamps included).
"""
import json
import math
import time

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.telemetry import detectors as ref_detectors
from flink_parameter_server_tpu.telemetry import timeline as ref_timeline
from flink_parameter_server_tpu.telemetry.registry import MetricsRegistry as RefRegistry
from flink_parameter_server_tpu_torch.telemetry import detectors as port_detectors
from flink_parameter_server_tpu_torch.telemetry import timeline as port_timeline
from flink_parameter_server_tpu_torch.telemetry.detectors import (
    EWMADriftDetector,
    RollingMADDetector,
)
from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
from flink_parameter_server_tpu_torch.telemetry.timeline import (
    SkewTracker,
    TimelineRecorder,
    percentile_from_counts,
)

torch.set_num_threads(2)

pytestmark = pytest.mark.timeline


def _feed(det, xs, *, name="m", field="value", labels=None):
    """Run a series through a detector point-by-point; ts = index so a
    record's ``ts`` IS the firing index."""
    records = []
    for i, x in enumerate(xs):
        rec = det.observe(name, labels or {}, field, float(x), float(i))
        if rec is not None:
            records.append(rec)
    return records


# ---------------------------------------------------------------------------
# percentile_from_counts
# ---------------------------------------------------------------------------


class TestPercentileFromCounts:
    def test_exact_interpolation(self):
        bounds = [1.0, 2.0, 4.0]
        counts = [0, 10, 0, 0]  # all mass in (1, 2]
        # rank 5 of 10 → halfway through the (1, 2] bin
        assert percentile_from_counts(bounds, counts, 50.0) == pytest.approx(2.0 - 0.5)

    def test_overflow_clamps_to_last_bound(self):
        bounds = [1.0, 2.0]
        counts = [0, 0, 7]  # everything overflowed
        assert percentile_from_counts(bounds, counts, 99.0) == 2.0

    def test_empty_window_is_zero(self):
        assert percentile_from_counts([1.0, 2.0], [0, 0, 0], 99.0) == 0.0

    def test_matches_registry_histogram_on_full_window(self):
        """On a first window (delta == cumulative) the function and
        Histogram.percentile are the same math."""
        reg = MetricsRegistry()
        h = reg.histogram("x_seconds", component="test",
                          buckets=(0.01, 0.05, 0.1, 0.5, 1.0))
        rng = np.random.default_rng(7)
        for v in rng.uniform(0.0, 1.2, 200):
            h.observe(float(v))
        counts = h.bucket_counts()
        for q in (50.0, 90.0, 99.0):
            assert percentile_from_counts(h.bounds, counts, q) == pytest.approx(
                h.percentile(q)
            )


def test_percentile_from_counts_equals_the_reference_bitwise():
    rng = np.random.default_rng(3)
    bounds = sorted(rng.uniform(0.001, 2.0, 9).tolist())
    for _ in range(50):
        counts = rng.integers(0, 20, len(bounds) + 1).tolist()
        for q in (0.0, 12.5, 50.0, 90.0, 99.0, 100.0):
            got = percentile_from_counts(bounds, counts, q)
            want = ref_timeline.percentile_from_counts(bounds, counts, q)
            assert got == want  # the same float, bit for bit


# ---------------------------------------------------------------------------
# detector oracles vs numpy
# ---------------------------------------------------------------------------


def _ewma_reference_scores(xs, *, alpha, warmup,
                           rel_floor=0.05, abs_floor=1e-9):
    """Closed-form EW mean/variance (weighted sums, not the detector's
    recursion): m_j = (1-a)^j x_0 + a Σ_{i=1..j} (1-a)^{j-i} x_i and
    v_j = Σ_{i=1..j} a (1-a)^{j-i+1} d_i² with d_i = x_i - m_{i-1}.
    Score at point j (j >= warmup) uses the state BEFORE absorbing it."""
    xs = np.asarray(xs, dtype=float)
    n = len(xs)
    means = np.empty(n)
    means[0] = xs[0]
    for j in range(1, n):
        w = alpha * (1.0 - alpha) ** (j - np.arange(1, j + 1))
        means[j] = (1.0 - alpha) ** j * xs[0] + float(w @ xs[1:j + 1])
    d = xs[1:] - means[:-1]
    variances = np.zeros(n)
    for j in range(1, n):
        w = alpha * (1.0 - alpha) ** (j - np.arange(1, j + 1) + 1)
        variances[j] = float(w @ (d[:j] ** 2))
    scores = np.full(n, np.nan)
    for j in range(warmup, n):
        m, v = means[j - 1], variances[j - 1]
        sigma = max(math.sqrt(max(0.0, v)), rel_floor * abs(m), abs_floor)
        scores[j] = abs(xs[j] - m) / sigma
    return scores


def _mad_reference_scores(xs, *, window, warmup,
                          rel_floor=0.05, abs_floor=1e-9):
    """Robust z of each point vs the np.median/MAD of the (up to
    ``window``) points BEFORE it — the detector appends after scoring."""
    xs = np.asarray(xs, dtype=float)
    scores = np.full(len(xs), np.nan)
    for j in range(len(xs)):
        win = xs[max(0, j - window):j]
        if len(win) >= warmup:
            med = float(np.median(win))
            mad = float(np.median(np.abs(win - med)))
            scale = max(1.4826 * mad, rel_floor * abs(med), abs_floor)
            scores[j] = abs(xs[j] - med) / scale
    return scores


class TestDetectorOracles:
    def test_ewma_firing_index_and_score_match_numpy(self):
        rng = np.random.default_rng(11)
        xs = list(rng.normal(1.0, 0.02, 30)) + list(rng.normal(1.6, 0.02, 10))
        alpha, k, warmup = 0.2, 4.0, 10
        ref = _ewma_reference_scores(xs, alpha=alpha, warmup=warmup)
        expected_idx = int(np.argmax(np.nan_to_num(ref) > k))
        assert ref[expected_idx] > k  # the shift IS detectable
        det = EWMADriftDetector("m", field="value", alpha=alpha,
                                k=k, warmup=warmup)
        records = _feed(det, xs)
        assert records, "level shift never fired"
        first = records[0]
        assert first["ts"] == float(expected_idx)
        assert first["kind"] == "ewma_drift"
        assert first["score"] == pytest.approx(ref[expected_idx], rel=1e-3)

    def test_mad_spike_index_and_score_match_numpy(self):
        rng = np.random.default_rng(13)
        xs = list(rng.normal(1.0, 0.02, 80))
        xs[40] = 2.0  # one wild point
        window, k, warmup = 24, 6.0, 12
        ref = _mad_reference_scores(xs, window=window, warmup=warmup)
        det = RollingMADDetector("m", field="value", window=window,
                                 k=k, warmup=warmup)
        records = _feed(det, xs)
        assert len(records) == 1
        assert records[0]["ts"] == 40.0
        assert records[0]["kind"] == "mad_outlier"
        assert records[0]["score"] == pytest.approx(ref[40], rel=1e-3)

    def test_zero_false_positives_on_stationary_noise(self):
        """The scale-floor contract: float jitter on a flat series
        cannot manufacture episodes at default thresholds."""
        rng = np.random.default_rng(17)
        xs = rng.normal(1.0, 0.02, 600)
        ewma = EWMADriftDetector("m", field="value")
        mad = RollingMADDetector("m", field="value")
        assert _feed(ewma, xs) == []
        assert _feed(mad, xs) == []

    def test_sustained_shift_is_one_episode_then_rearms(self):
        """Edge-trigger semantics: the plateau fires at its leading
        edge only; after the detector adapts (re-arm), a SECOND shift
        fires a second episode."""
        xs = ([1.0] * 10) + ([10.0] * 37) + ([30.0] * 5)
        det = EWMADriftDetector("m", field="value", alpha=0.2,
                                k=4.0, warmup=5)
        records = _feed(det, xs)
        assert [r["ts"] for r in records] == [10.0, 47.0]
        # the ledger mirrors the records (episode count, not samples)
        assert len(det.episodes) == 2

    def test_label_sets_keep_independent_state(self):
        """One detector instance watches every labelled series of its
        metric; a shift on shard 1 must not fire (or warm up) shard 0."""
        det = EWMADriftDetector("m", field="value", k=4.0, warmup=5)
        for i in range(8):
            det.observe("m", {"shard": "0"}, "value", 1.0, float(i))
            det.observe("m", {"shard": "1"}, "value", 1.0, float(i))
        rec = det.observe("m", {"shard": "1"}, "value", 9.0, 8.0)
        assert rec is not None and rec["labels"] == {"shard": "1"}
        assert det.observe("m", {"shard": "0"}, "value", 1.0, 8.0) is None

    def test_metric_and_field_scoping(self):
        det = RollingMADDetector("m", field="p99", window=8, k=6.0,
                                 warmup=4)
        for i in range(8):
            assert det.observe("other", {}, "p99", 1.0, float(i)) is None
            assert det.observe("m", {}, "rate", 1.0, float(i)) is None
        # nothing scoped-in was ever absorbed
        assert det.observe("m", {}, "p99", 100.0, 9.0) is None  # warming

    def test_ctor_validation(self):
        with pytest.raises(ValueError, match="warmup"):
            EWMADriftDetector("m", warmup=1)
        with pytest.raises(ValueError, match="alpha"):
            EWMADriftDetector("m", alpha=1.5)
        with pytest.raises(ValueError, match="window"):
            RollingMADDetector("m", window=2)
        with pytest.raises(ValueError, match="could never be met"):
            RollingMADDetector("m", window=8, warmup=9)
        with pytest.raises(ValueError, match="rearm_fraction"):
            EWMADriftDetector("m", rearm_fraction=0.0)


def _series(seed):
    """A seeded series with a level shift, a spike and a second shift, on
    two label sets, so both detectors fire, re-arm and fire again."""
    rng = np.random.default_rng(seed)
    xs = np.concatenate([rng.normal(1.0, 0.03, 60), rng.normal(1.9, 0.03, 50),
                         rng.normal(1.9, 0.3, 40), rng.normal(4.0, 0.05, 50)])
    xs[30] = 3.5
    xs[130] += 5.0
    return xs


@pytest.mark.parametrize("kind, kw", [
    ("EWMADriftDetector", dict(alpha=0.2, k=4.0, warmup=10)),
    ("EWMADriftDetector", dict(alpha=0.05, k=3.0, warmup=5, rearm_fraction=0.8)),
    ("RollingMADDetector", dict(window=24, k=6.0, warmup=12)),
    ("RollingMADDetector", dict(window=8, k=3.5, warmup=4, rel_floor=0.01)),
])
def test_detectors_fire_as_the_reference_does(kind, kw):
    port = getattr(port_detectors, kind)("m", field="p99", **kw)
    ref = getattr(ref_detectors, kind)("m", field="p99", **kw)
    fired = {"port": [], "ref": []}
    for seed, shard in ((5, "0"), (6, "1")):
        xs = _series(seed)
        for i, x in enumerate(xs):
            for name, det in (("port", port), ("ref", ref)):
                rec = det.observe("m", {"shard": shard}, "p99", float(x), float(i))
                if rec is not None:
                    fired[name].append(rec)
    assert len(fired["port"]) >= 4  # both label sets fire more than once
    assert [(r["labels"], r["ts"], r["kind"], r["value"]) for r in fired["port"]] == [
        (r["labels"], r["ts"], r["kind"], r["value"]) for r in fired["ref"]
    ]
    np.testing.assert_allclose([r["score"] for r in fired["port"]],
                               [r["score"] for r in fired["ref"]], rtol=1e-12, atol=0)
    assert port.episodes == ref.episodes


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


class TestTimelineRecorder:
    def test_counter_becomes_rate(self):
        reg = MetricsRegistry()
        c = reg.counter("events_total", component="test")
        rec = TimelineRecorder(reg, interval_s=0.01)
        a = time.monotonic()
        rec.sample()  # primes the counter window
        b = time.monotonic()
        c.inc(100)
        time.sleep(0.03)
        inner = time.monotonic()
        rec.sample()
        outer = time.monotonic()
        series = rec.series("events_total")
        assert len(series) == 1 and series[0]["field"] == "rate"
        (_, rate), = series[0]["points"]
        # the sample's dt is bracketed by our own monotonic reads
        assert 100.0 / (outer - a) <= rate <= 100.0 / (inner - b)

    def test_gauge_value_and_none_gap(self):
        reg = MetricsRegistry()
        g = reg.gauge("level", component="test")
        probe = reg.gauge("probe", component="test")
        probe.set_fn(lambda: None)  # unreadable probe
        rec = TimelineRecorder(reg, interval_s=0.01)
        g.set(3.5)
        rec.sample()
        g.set(4.5)
        rec.sample()
        series = {s["metric"]: s for s in rec.series()}
        assert [v for _, v in series["level"]["points"]] == [3.5, 4.5]
        assert "probe" not in series  # a gap, not a zero

    def test_histogram_windowed_p99_vs_exact_reservoir(self):
        """Bucket-delta p99 agrees with np.percentile of the exact
        delta-window observations to within the enclosing bucket, and
        is genuinely WINDOWED (a quiet window after a loud one)."""
        reg = MetricsRegistry()
        bounds = (0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0)
        h = reg.histogram("lat_seconds", component="test", buckets=bounds)
        rec = TimelineRecorder(reg, interval_s=0.01)
        rng = np.random.default_rng(23)

        def bucket_of(v):
            lo = 0.0
            for b in bounds:
                if v <= b:
                    return lo, b
                lo = b
            return lo, bounds[-1]

        loud = rng.uniform(0.2, 0.9, 400)
        for v in loud:
            h.observe(float(v))
        rec.sample()
        quiet = rng.uniform(0.001, 0.03, 300)
        for v in quiet:
            h.observe(float(v))
        rec.sample()
        p99 = [s for s in rec.series("lat_seconds")
               if s["field"] == "p99"][0]["points"]
        assert len(p99) == 2
        for (_, got), window in zip(p99, (loud, quiet)):
            exact = float(np.percentile(window, 99))
            lo, hi = bucket_of(exact)
            assert lo <= got <= hi, (got, exact)
        # windowed, not cumulative: window 2's p99 is small while the
        # cumulative histogram is still dominated by the loud window
        assert p99[1][1] < 0.1 < h.percentile(99.0)

    def test_capacity_bounds_ring(self):
        reg = MetricsRegistry()
        g = reg.gauge("level", component="test")
        rec = TimelineRecorder(reg, interval_s=0.01, capacity=4)
        for i in range(10):
            g.set(float(i))
            rec.sample()
        pts = rec.series("level")[0]["points"]
        assert [v for _, v in pts] == [6.0, 7.0, 8.0, 9.0]

    def test_max_series_drops_are_counted(self):
        reg = MetricsRegistry()
        reg.gauge("a", component="test").set(1.0)
        reg.gauge("b", component="test").set(2.0)
        rec = TimelineRecorder(reg, interval_s=0.01, max_series=1)
        rec.sample()
        assert len(rec.series()) == 1
        assert rec.payload()["dropped_series"] >= 1

    def test_marks_and_payload_are_json(self):
        reg = MetricsRegistry()
        reg.gauge("level", component="test").set(1.0)
        rec = TimelineRecorder(reg, interval_s=0.01)
        rec.mark("fault_injected", shard=0, op="delay")
        rec.sample()
        payload = json.loads(json.dumps(rec.payload()))
        assert payload["kind"] == "timeline"
        assert payload["samples"] == 1
        assert payload["marks"][0]["label"] == "fault_injected"
        assert payload["marks"][0]["shard"] == 0
        names = {s["metric"] for s in payload["series"]}
        assert "level" in names

    def test_anomaly_bumps_counter_and_ledger(self):
        reg = MetricsRegistry()
        g = reg.gauge("probe_value", component="test")
        det = EWMADriftDetector("probe_value", field="value",
                                k=4.0, warmup=5)
        rec = TimelineRecorder(reg, interval_s=0.01, detectors=[det])
        for _ in range(8):
            g.set(1.0)
            rec.sample()
        assert rec.anomalies() == []
        g.set(10.0)
        rec.sample()
        anoms = rec.anomalies()
        assert len(anoms) == 1 and anoms[0]["metric"] == "probe_value"
        bumped = [
            i for i in reg.instruments()
            if i.name == "timeline_anomalies_total"
        ]
        assert len(bumped) == 1 and bumped[0].value == 1
        assert bumped[0].labels["kind"] == "ewma_drift"

    def test_background_loop_samples_and_stops(self):
        reg = MetricsRegistry()
        reg.gauge("level", component="test").set(1.0)
        rec = TimelineRecorder(reg, interval_s=0.01)
        with rec:
            thread = rec._thread
            deadline = time.monotonic() + 30.0
            while rec.payload()["samples"] < 3 and time.monotonic() < deadline:
                time.sleep(0.01)
        assert rec.payload()["samples"] >= 3
        # stop() joined the loop: no thread is left to sample again
        assert rec._thread is None and not thread.is_alive()
        settled = rec.payload()["samples"]
        time.sleep(0.05)
        assert rec.payload()["samples"] == settled  # loop really stopped

    def test_ctor_validation(self):
        with pytest.raises(ValueError, match="interval_s"):
            TimelineRecorder(MetricsRegistry(), interval_s=0.0)
        with pytest.raises(ValueError, match="capacity"):
            TimelineRecorder(MetricsRegistry(), capacity=1)


class _ScriptedClock:
    """Stands in for the ``time`` module of both timeline modules: every
    read of either clock advances by a fixed step, so both packages see
    the same timestamps and the same counter windows."""

    def __init__(self):
        self.t = 1000.0

    def _tick(self):
        self.t += 0.25
        return self.t

    def time(self):
        return self._tick()

    def monotonic(self):
        return self._tick()


def _drive_timeline(reg, mod, det_mod):
    det = [det_mod.EWMADriftDetector("rtt_seconds", field="p99", k=4.0, warmup=4),
           det_mod.RollingMADDetector("level", field="value", window=8, k=5.0, warmup=4)]
    skew = mod.SkewTracker("rtt_seconds", entity_label="shard", field="p50",
                           window=8, min_points=2, ratio_threshold=2.0)
    rec = mod.TimelineRecorder(reg, interval_s=0.25, capacity=16, detectors=det, skew=[skew])
    rng = np.random.default_rng(29)
    c = reg.counter("pushes_total", component="test", shard="0")
    g = reg.gauge("level", component="test")
    hs = [reg.histogram("rtt_seconds", component="test", shard=str(s),
                        buckets=(0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1)) for s in range(3)]
    rec.mark("start", arm="parity")
    for tick in range(24):
        c.inc(int(rng.integers(1, 50)))
        g.set(float(rng.normal(2.0, 0.05)) + (4.0 if tick == 15 else 0.0))
        for s, h in enumerate(hs):
            scale = 0.004 * (5.0 if (s == 2 and tick >= 12) else 1.0)
            for v in rng.uniform(0.5, 1.5, 40) * scale:
                h.observe(float(v))
        rec.sample()
    return rec.payload()


def test_recorder_payload_equals_the_reference(monkeypatch):
    """The same registry traffic, sampled on the same scripted clock,
    gives the same payload document through both packages."""
    payloads = []
    for mod, det_mod, registry_cls in ((port_timeline, port_detectors, MetricsRegistry),
                                       (ref_timeline, ref_detectors, RefRegistry)):
        clock = _ScriptedClock()
        monkeypatch.setattr(mod, "time", clock)
        payloads.append(_drive_timeline(registry_cls(run_id="parity"), mod, det_mod))
    port, ref = payloads
    assert port["samples"] == ref["samples"] == 24
    assert {a["kind"] for a in port["anomalies"]} == {"ewma_drift", "mad_outlier"}
    assert port["skew"][0]["last"]["entity"] == "2" and port["skew"][0]["last"]["flagged"]
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)


# ---------------------------------------------------------------------------
# skew attribution
# ---------------------------------------------------------------------------


class TestSkewTracker:
    def _feed_entities(self, tracker, per_entity, n=8):
        for i in range(n):
            for entity, value in per_entity.items():
                tracker.observe(
                    tracker.metric, {"shard": entity},
                    "p99", value, float(i),
                )

    def test_straggler_named_with_no_baseline(self):
        reg = MetricsRegistry()
        t = SkewTracker("cluster_shard_rtt_seconds", entity_label="shard",
                        field="p99", window=8, min_points=3,
                        ratio_threshold=2.0, registry=reg)
        self._feed_entities(t, {"0": 0.01, "1": 0.011, "2": 0.1})
        verdict = t.evaluate(now=1.0)
        assert verdict is not None
        assert verdict["entity"] == "2" and verdict["flagged"]
        assert verdict["ratio"] == pytest.approx(0.1 / 0.011, rel=1e-3)
        # ratios published as gauges
        gauges = {
            i.labels["entity"]: i.value for i in reg.instruments()
            if i.name == "skew_ratio"
        }
        assert set(gauges) == {"0", "1", "2"}
        assert gauges["2"] == pytest.approx(0.1 / 0.011, rel=1e-3)

    def test_balanced_fleet_not_flagged(self):
        t = SkewTracker("m", entity_label="shard", window=8,
                        min_points=3, ratio_threshold=2.0)
        self._feed_entities(t, {"0": 0.01, "1": 0.0105, "2": 0.0098})
        verdict = t.evaluate(now=1.0)
        assert verdict is not None and not verdict["flagged"]

    def test_warmup_evals_suppresses_flag_not_ratio(self):
        t = SkewTracker("m", entity_label="shard", window=8,
                        min_points=3, ratio_threshold=2.0,
                        warmup_evals=2)
        # 3 entities: with only 2, the median-of-medians baseline
        # averages the straggler in and bounds the ratio below 2
        self._feed_entities(t, {"0": 0.01, "1": 0.011, "2": 0.1})
        v1 = t.evaluate(now=1.0)
        v2 = t.evaluate(now=2.0)
        v3 = t.evaluate(now=3.0)
        assert v1["ratio"] > 2.0 and not v1["flagged"]  # cold start
        assert not v2["flagged"]
        assert v3["flagged"]  # past warmup, same signal
        assert t.snapshot()["warmup_evals"] == 2

    def test_needs_two_entities(self):
        t = SkewTracker("m", entity_label="shard", min_points=1)
        t.observe("m", {"shard": "0"}, "p99", 0.01, 0.0)
        assert t.evaluate(now=1.0) is None

    def test_threshold_validation(self):
        with pytest.raises(ValueError, match="ratio_threshold"):
            SkewTracker("m", entity_label="shard", ratio_threshold=1.0)


# ---------------------------------------------------------------------------
# elastic pressure from anomaly firings
# ---------------------------------------------------------------------------


class TestElasticPressure:
    def test_anomaly_firing_drives_scale_out_once(self, tmp_path):
        from flink_parameter_server_tpu_torch.elastic import (
            ElasticClusterConfig,
            ElasticClusterDriver,
            ElasticController,
            ScalePolicy,
        )
        from flink_parameter_server_tpu_torch.models.matrix_factorization import (
            OnlineMatrixFactorization,
            SGDUpdater,
        )
        from flink_parameter_server_tpu_torch.utils.initializers import (
            ranged_random_factor,
        )

        reg = MetricsRegistry()
        logic = OnlineMatrixFactorization(
            32, 4, updater=SGDUpdater(0.05), seed=1, device="cpu"
        )
        d = ElasticClusterDriver(
            logic, capacity=64, value_shape=(4,),
            init_fn=ranged_random_factor(3, (4,)),
            config=ElasticClusterConfig(
                num_shards=1, num_workers=1,
                wal_dir=str(tmp_path / "wal"),
            ),
            registry=reg, device="cpu",
        )
        d.start()
        try:
            g = reg.gauge("probe_value", component="test")
            det = EWMADriftDetector("probe_value", field="value",
                                    k=4.0, warmup=5)
            rec = TimelineRecorder(reg, interval_s=0.01, detectors=[det])
            ctl = ElasticController(
                d,
                policy=ScalePolicy(
                    max_shards=4, min_window_frames=5, cooldown_s=0.0
                ),
                registry=reg,
                timeline=rec,
            )
            for _ in range(8):
                g.set(1.0)
                rec.sample()
            assert ctl.step() is None  # flat series, no pressure
            g.set(10.0)
            rec.sample()  # the drift fires here
            act = ctl.step()
            assert act and act["action"] == "scale_out" and act["ok"]
            assert act["timeline_anomalies"] == ["probe_value/ewma_drift"]
            assert d.partitioner.num_shards == 2
            # cursor advanced: the SAME firing never pressures twice
            assert ctl.step() is None
        finally:
            d.stop()
