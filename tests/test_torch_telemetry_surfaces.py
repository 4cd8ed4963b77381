"""The port's telemetry surfaces (``telemetry/exporter.py``, ``report.py``,
``lockwitness.py``) and the plane under them, against the JAX package's.

Mirrors, on the CPU (``device="cpu"``, a CPU hot-key aggregator):
  * tests/test_telemetry.py, 21 of its 22 tests: the registry (identity,
    thread safety, bucket math, dead probes), the JSON-lines contract of
    every emitter, spans and their Chrome export, ``prometheus_text`` and
    the TCP ``/metrics`` endpoint mid-training, the driver's checkpoint
    and WAL spans, telemetry off, the run report, ``device_memory_stats``
    and the metric-line lint over a live run.  The overhead guard
    (``test_overhead_guard_200_step_run``) is left out: it drives
    ``benchmarks/telemetry_overhead.py``, which this round does not port;
  * tests/test_tracing.py's ``test_hot_keys_on_metrics_and_report``,
    ``test_metrics_endpoint_strict_http_reader`` and
    ``test_report_hedge_win_rate``;
  * tests/test_timeline.py's TestSurfaces (2);
  * tests/test_replication.py's ``test_lag_gauges_live_on_metrics_endpoint``
    and TestWitnessedReplicationOracle (1);
  * tests/test_elastic.py's ``test_run_report_carries_elastic_section``.

Parity with the reference, exact:
  * the same instrument operations on both registries (and the same
    stream through both packages' hot-key sketches) give byte-equal
    ``prometheus_text`` once ``ts`` and ``run_id`` are masked;
  * ``build_run_report`` over the same registry operations, profiler
    phases and cache traffic gives equal keys and values apart from
    ``generated_at``, ``run_id`` and ``wall_s`` (the platform is not in the
    report; it names the results folder);
  * a scripted lock order gives the same inversion report from both
    witnesses.
One fault of the reference is repaired in the port and pinned here: a gauge
set to NaN or an infinity renders in the exposition format instead of
failing the scrape.
"""
import http.client
import io
import json
import re
import socket
import threading
import time

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu import telemetry as ref_tm
from flink_parameter_server_tpu.hotcache import cache as ref_cache
from flink_parameter_server_tpu.telemetry import hotkeys as ref_hotkeys
from flink_parameter_server_tpu.telemetry import lockwitness as ref_lockwitness
from flink_parameter_server_tpu.telemetry import profiler as ref_profiler
from flink_parameter_server_tpu.telemetry import timeline as ref_timeline
from flink_parameter_server_tpu_torch import telemetry as tm
from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
from flink_parameter_server_tpu_torch.data.streams import microbatches
from flink_parameter_server_tpu_torch.hotcache import HotRowCache, register_cache, unregister_cache
from flink_parameter_server_tpu_torch.models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
)
from flink_parameter_server_tpu_torch.telemetry import hotkeys, lockwitness
from flink_parameter_server_tpu_torch.telemetry import profiler as port_profiler
from flink_parameter_server_tpu_torch.telemetry.hotkeys import HotKeyAggregator, HotKeySketch
from flink_parameter_server_tpu_torch.telemetry.timeline import get_timeline, set_timeline
from flink_parameter_server_tpu_torch.training.driver import DriverConfig, StreamingDriver
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

torch.set_num_threads(2)

pytestmark = pytest.mark.telemetry

CPU = "cpu"


@pytest.fixture()
def registry():
    """Isolated registry installed as the process default for the test
    (driver/serving wiring resolves the default lazily)."""
    reg = tm.MetricsRegistry(run_id="test-run")
    old = tm.get_registry()
    tm.set_registry(reg)
    yield reg
    tm.set_registry(old)


@pytest.fixture()
def tracer():
    tr = tm.SpanTracer()
    old = tm.get_tracer()
    tm.set_tracer(tr)
    yield tr
    tm.set_tracer(old)


@pytest.fixture()
def aggregator():
    """A CPU aggregator as the process default (the default one ranks on
    the card)."""
    agg = HotKeyAggregator(device=CPU)
    old = hotkeys.get_aggregator()
    hotkeys.set_aggregator(agg)
    yield agg
    hotkeys.set_aggregator(old)


def _mf_driver(num_users, num_items, dim, seed=0, **cfg):
    logic = OnlineMatrixFactorization(num_users, dim, updater=SGDUpdater(0.05), device=CPU)
    store = ShardedParamStore.create(
        num_items, (dim,), init_fn=ranged_random_factor(seed + 1, (dim,)), device=CPU,
    )
    return StreamingDriver(logic, store, config=DriverConfig(dump_model=False, **cfg))


# ---------------------------------------------------------------------------
# registry: typing, identity, thread-safety
# ---------------------------------------------------------------------------


def test_instrument_identity_and_type_conflicts(registry):
    c1 = registry.counter("x_total", component="train")
    c2 = registry.counter("x_total", component="train")
    assert c1 is c2
    # same name, different labels = a different instrument
    c3 = registry.counter("x_total", component="serving")
    assert c3 is not c1
    with pytest.raises(ValueError):
        registry.gauge("x_total", component="train")
    registry.histogram("h", component="train", buckets=[1.0, 2.0])
    with pytest.raises(ValueError):  # boundary mismatch on re-request
        registry.histogram("h", component="train", buckets=[1.0, 3.0])


def test_counter_rejects_negative(registry):
    c = registry.counter("n_total")
    with pytest.raises(ValueError):
        c.inc(-1)


def test_registry_thread_safety_under_concurrent_writers(registry):
    """N threads hammering the same counter + histogram lose nothing:
    totals are exact, histogram count equals observations made."""
    c = registry.counter("hits_total", component="train")
    h = registry.histogram("lat_seconds", component="train", buckets=[0.25, 0.5, 0.75])
    g = registry.gauge("level", component="train")
    n_threads, per_thread = 8, 2_000
    rngs = [np.random.default_rng(i) for i in range(n_threads)]

    def writer(i):
        for v in rngs[i].uniform(0, 1, per_thread):
            c.inc()
            h.observe(float(v))
            g.set(float(v))

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    total = n_threads * per_thread
    assert c.value == total
    assert h.count == total
    assert sum(h.bucket_counts()) == total
    assert g.value is not None and 0 <= g.value <= 1


def test_histogram_bucket_math_vs_numpy_oracle(registry):
    bounds = [0.001, 0.01, 0.1, 1.0, 10.0]
    h = registry.histogram("oracle_seconds", buckets=bounds)
    rng = np.random.default_rng(42)
    vals = rng.lognormal(mean=-3.0, sigma=2.0, size=5_000)
    for v in vals:
        h.observe(float(v))
    edges = np.concatenate([[-np.inf], np.array(bounds), [np.inf]])
    oracle, _ = np.histogram(vals, bins=edges)
    assert h.bucket_counts() == oracle.tolist()
    assert h.count == len(vals)
    np.testing.assert_allclose(h.sum, vals.sum(), rtol=1e-9)
    for q in (50, 90, 99):
        exact = float(np.percentile(vals, q))
        est = h.percentile(q)
        assert np.searchsorted(bounds, est) == np.searchsorted(bounds, min(exact, bounds[-1])), (
            q, exact, est,
        )


def test_gauge_probe_failure_reads_none(registry):
    g = registry.gauge("flaky", fn=lambda: 1 / 0)
    assert g.value is None  # dead probe: visible as null, not a crash
    snap = registry.snapshot()
    assert snap["flaky"][0]["value"] is None


# ---------------------------------------------------------------------------
# JSON-lines contract: every emitter round-trips with shared ts/run_id
# ---------------------------------------------------------------------------


def _assert_metric_line(line):
    assert "\n" not in line
    d = json.loads(line)
    assert isinstance(d["ts"], float) and d["ts"] > 0
    assert isinstance(d["run_id"], str) and d["run_id"]
    return d


def test_all_emitters_round_trip_json(registry):
    from flink_parameter_server_tpu_torch.resilience.health import HealthMonitor, StallWatchdog
    from flink_parameter_server_tpu_torch.serving.metrics import ServingMetrics
    from flink_parameter_server_tpu_torch.training.metrics import StepMetrics

    m = StepMetrics(events_per_step=10, registry=registry)
    m.step_start()
    m.step_end()
    d = _assert_metric_line(m.emit())
    assert d["run_id"] == "test-run" and d["steps"] == 1

    sm = ServingMetrics(registry=registry)
    sm.record_batch(3, 4, [0.001, 0.002, 0.004])
    d = _assert_metric_line(sm.emit())
    assert d["serving_requests"] == 3

    clock = [0.0]
    mon = HealthMonitor(clock=lambda: clock[0], registry=registry)
    sink = io.StringIO()
    wd = StallWatchdog(mon, 1.0, sink=sink, registry=registry)
    mon.beat("train")
    clock[0] = 5.0
    events = wd.check_once()
    assert [e["stall"] for e in events] == ["train"]
    d = _assert_metric_line(sink.getvalue().splitlines()[0])
    assert d["stall"] == "train"
    assert registry.counter("stall_episodes_total", component="train").value == 1

    d = _assert_metric_line(registry.emit())
    assert d["kind"] == "registry"

    import tools.check_metric_lines as lint

    lines = [m.emit(), sm.emit(), sink.getvalue().splitlines()[0], registry.emit()]
    assert lint.check_lines(lines) == []


def test_json_line_sanitizes_non_finite(registry):
    line = tm.json_line({"a": float("nan"), "b": float("inf"), "nested": {"c": float("-inf")}})
    d = json.loads(line)  # strict parser: would reject NaN/Infinity
    assert d["a"] is None and d["b"] is None and d["nested"]["c"] is None


def test_heartbeat_age_gauge_visible_before_watchdog(registry):
    from flink_parameter_server_tpu_torch.resilience.health import HealthMonitor

    clock = [100.0]
    mon = HealthMonitor(clock=lambda: clock[0], registry=registry)
    mon.beat("ingest")
    clock[0] = 103.5
    txt = tm.prometheus_text(registry)
    assert 'fps_last_heartbeat_age_s{component="ingest"} 3.5' in txt


# ---------------------------------------------------------------------------
# spans: nesting, ring buffer, Chrome trace export
# ---------------------------------------------------------------------------


def test_span_nesting_and_chrome_export(tmp_path):
    tr = tm.SpanTracer()
    with tr.span("outer", component="train"):
        time.sleep(0.002)
        with tr.span("inner", component="ingest"):
            time.sleep(0.002)
    path = str(tmp_path / "trace.json")
    doc = json.loads(tr.export_chrome_trace(path))
    with open(path) as f:
        assert json.load(f) == doc  # file and return value agree
    by_name = {e["name"]: e for e in doc}
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["ph"] == inner["ph"] == "X"
    assert outer["args"]["depth"] == 0 and inner["args"]["depth"] == 1
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert inner["cat"] == "ingest"


def test_span_ring_buffer_bounds_memory():
    tr = tm.SpanTracer(capacity=16)
    for i in range(100):
        with tr.span(f"s{i}"):
            pass
    assert len(tr) == 16
    names = [s["name"] for s in tr.spans()]
    assert names == [f"s{i}" for i in range(84, 100)]  # newest survive


def test_disabled_tracer_records_nothing():
    tr = tm.SpanTracer(enabled=False)
    with tr.span("x"):
        pass
    tr.record("y", 0.0, 1.0)
    assert len(tr) == 0


# ---------------------------------------------------------------------------
# exporter: prometheus text + TCP endpoint
# ---------------------------------------------------------------------------


def test_prometheus_text_shapes(registry):
    registry.counter("steps_total", component="train").inc(7)
    h = registry.histogram("lat_seconds", component="train", buckets=[0.1, 1.0])
    h.observe(0.05)
    h.observe(5.0)
    txt = tm.prometheus_text(registry)
    assert '# TYPE fps_steps_total counter' in txt
    assert 'fps_steps_total{component="train"} 7' in txt
    assert 'fps_lat_seconds_bucket{component="train",le="0.1"} 1' in txt
    assert 'fps_lat_seconds_bucket{component="train",le="+Inf"} 2' in txt
    assert 'fps_lat_seconds_count{component="train"} 2' in txt


def test_non_finite_gauges_render_in_the_exposition_format(registry):
    """A gauge set to NaN or an infinity renders as the format spells
    them (the reference's renderer raises on these and fails the
    scrape)."""
    for name, v in (("g_nan", float("nan")), ("g_pinf", float("inf")), ("g_ninf", float("-inf"))):
        registry.gauge(name, component="x").set(v)
    txt = tm.prometheus_text(registry)
    assert 'fps_g_nan{component="x"} NaN' in txt
    assert 'fps_g_pinf{component="x"} +Inf' in txt
    assert 'fps_g_ninf{component="x"} -Inf' in txt


def test_tcp_endpoint_http_and_line_protocol(registry):
    registry.counter("steps_total", component="train").inc(3)
    with tm.TelemetryServer(registry) as srv:
        body = tm.scrape(srv.host, srv.port, "metrics")
        assert "fps_steps_total" in body
        with socket.create_connection((srv.host, srv.port)) as s:
            s.sendall(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
            data = b""
            while True:
                chunk = s.recv(1 << 16)
                if not chunk:
                    break
                data += chunk
        head, _, payload = data.partition(b"\r\n\r\n")
        assert b"200 OK" in head and b"text/plain" in head
        assert b"fps_steps_total" in payload
        health = json.loads(tm.scrape(srv.host, srv.port, "healthz"))
        assert health["status"] == "ok"
        assert "unknown path" in tm.scrape(srv.host, srv.port, "nope")
        # the paths whose modules wait for adaptive/ and tierstore/
        # answer the reference's "none installed" payload
        assert json.loads(tm.scrape(srv.host, srv.port, "adaptive"))["adaptive"] is None
        assert json.loads(tm.scrape(srv.host, srv.port, "tiers"))["tiers"] is None


# ---------------------------------------------------------------------------
# e2e: live /metrics mid-training (train-while-serve), span trace out
# ---------------------------------------------------------------------------


def test_metrics_endpoint_live_mid_training(registry, tracer):
    """Train-while-serve with the TCP endpoint up; a scrape taken MID-RUN
    (from a group hook, so it provably overlaps training) sees live train
    + serving families, and the span trace exports pull/compute/push +
    ingest + publish."""
    num_users, num_items, dim = 100, 150, 8
    driver = _mf_driver(num_users, num_items, dim)
    service = driver.serve_with(publish_every=2, max_batch=16, max_delay_ms=1.0)
    client = service.client()
    data = synthetic_ratings(num_users, num_items, 50_000, rank=4, seed=0)
    batches = list(microbatches(data, 512, epochs=1, shuffle_seed=0))
    assert len(batches) >= 90

    mid_scrapes = []
    with tm.TelemetryServer(registry) as srv:
        c_req = registry.counter("serving_requests_total", component="serving")

        def scrape_hook(step, n_steps, table, state, outs):
            if step == 20:
                client.top_k(3, k=5)
                deadline = time.monotonic() + 10
                while c_req.value < 1 and time.monotonic() < deadline:
                    time.sleep(0.002)
                mid_scrapes.append(tm.scrape(srv.host, srv.port, "metrics"))

        driver.add_group_hook(scrape_hook)
        driver.run(batches)
    service.stop()

    assert len(mid_scrapes) == 1
    txt = mid_scrapes[0]
    assert 'fps_train_steps_total{component="train"} 20' in txt
    assert "fps_pull_push_latency_seconds_bucket" in txt
    assert 'fps_serving_requests_total{component="serving"} 1' in txt
    assert "fps_snapshot_staleness_steps" in txt
    assert "fps_ingest_batches_total" in txt

    doc = json.loads(tracer.export_chrome_trace())
    names = {e["name"] for e in doc}
    assert {"pull_compute_push", "ingest", "publish"} <= names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in doc)
    n_dispatch = sum(1 for e in doc if e["name"] == "pull_compute_push")
    assert n_dispatch == len(batches)

    report = tm.build_run_report(registry)
    assert report["train"]["steps"] == len(batches)
    assert report["serving"]["requests"] >= 1
    assert report["ingest"]["batches"] == len(batches)


def test_driver_checkpoint_span_and_counter(registry, tracer, tmp_path):
    driver = _mf_driver(60, 80, 4, checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=10)
    data = synthetic_ratings(60, 80, 10_000, rank=4, seed=1)
    driver.run(microbatches(data, 512, epochs=1, shuffle_seed=0))
    assert registry.counter("checkpoints_total", component="train").value >= 1
    assert "checkpoint" in {s["name"] for s in tracer.spans()}


def test_wal_append_span(registry, tracer, tmp_path):
    driver = _mf_driver(60, 80, 4, wal_dir=str(tmp_path / "wal"))
    data = synthetic_ratings(60, 80, 5_000, rank=4, seed=1)
    driver.run(microbatches(data, 512, epochs=1, shuffle_seed=0))
    names = {s["name"] for s in tracer.spans()}
    assert "wal_append" in names
    assert registry.counter("wal_appends_total", component="ingest").value >= 1


def test_telemetry_off_touches_nothing(registry, tracer):
    driver = _mf_driver(60, 80, 4, telemetry=False)
    data = synthetic_ratings(60, 80, 5_000, rank=4, seed=1)
    driver.run(microbatches(data, 512, epochs=1, shuffle_seed=0))
    assert registry.counter("train_steps_total", component="train").value == 0
    assert len(tracer) == 0


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


def test_run_report_writes_md_and_json(registry, tmp_path):
    registry.counter("train_steps_total", component="train").inc(10)
    report = tm.build_run_report(registry, wall_s=2.0, extra={"telemetry_overhead_pct": 0.5})
    assert report["train"]["steps_per_sec"] == 5.0
    paths = tm.write_run_report(report, results_dir=str(tmp_path))
    with open(paths["json"]) as f:
        assert json.load(f)["train"]["steps"] == 10
    with open(paths["md"]) as f:
        md = f.read()
    assert "| steps/sec | 5.0 |" in md
    assert "telemetry_overhead_pct" in md


# ---------------------------------------------------------------------------
# device_memory_stats uniform keys + gauges
# ---------------------------------------------------------------------------


def test_device_memory_stats_uniform_keys(registry):
    from flink_parameter_server_tpu_torch.training import tracing

    stats = tracing.device_memory_stats()
    for entry in stats.values():
        assert set(entry) == {"bytes_in_use", "peak_bytes"}
        assert all(isinstance(v, int) for v in entry.values())
    wired = tracing.register_device_memory_gauges(registry)
    assert wired == len(stats)
    if wired:  # the CPU reports no memory stats at all
        txt = tm.prometheus_text(registry)
        assert "fps_device_bytes_in_use" in txt


def test_device_memory_stats_warns_once_on_unknown_error(monkeypatch):
    from flink_parameter_server_tpu_torch.training import tracing

    def weird(index):
        raise KeyError("boom")

    monkeypatch.setattr(tracing.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tracing.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tracing.torch.cuda, "memory_stats", weird)
    tracing._mem_stats_warned.clear()
    assert tracing.device_memory_stats() == {}
    assert tracing._mem_stats_warned == {"cuda:0"}
    # second call: no growth, no raise (warned once per device)
    assert tracing.device_memory_stats() == {}
    assert tracing._mem_stats_warned == {"cuda:0"}
    tracing._mem_stats_warned.clear()


# ---------------------------------------------------------------------------
# the metric-line lint over a real run
# ---------------------------------------------------------------------------


def test_check_metric_lines_lint_over_live_run(registry, tmp_path):
    """Capture a real driver run's metrics_sink stream and hand it to
    tools/check_metric_lines.py — the CI-shaped invocation."""
    import os
    import subprocess
    import sys

    import tools.check_metric_lines as lint

    sink = io.StringIO()
    driver = _mf_driver(60, 80, 4, metrics_every=5)
    driver.metrics_sink = sink
    service = driver.serve_with(publish_every=4, max_batch=8)
    data = synthetic_ratings(60, 80, 20_000, rank=4, seed=3)
    driver.run(microbatches(data, 256, epochs=1, shuffle_seed=0))
    service.stop()
    assert sink.getvalue().strip(), "no metric lines emitted"

    log = tmp_path / "metrics.log"
    log.write_text(sink.getvalue())
    assert lint.check_lines(sink.getvalue().splitlines()) == []
    repo = os.path.dirname(os.path.dirname(os.path.abspath(lint.__file__)))
    proc = subprocess.run([sys.executable, "tools/check_metric_lines.py", str(log)],
                          capture_output=True, text=True, cwd=repo)
    assert proc.returncode == 0, proc.stderr
    assert "0 malformed" in proc.stdout

    bad = tmp_path / "bad.log"
    bad.write_text('{"ts": 1.0, "run_id": "x"}\nnot json at all\n')
    proc = subprocess.run([sys.executable, "tools/check_metric_lines.py", str(bad)],
                          capture_output=True, text=True, cwd=repo)
    assert proc.returncode == 1
    assert "not valid JSON" in proc.stderr


# ---------------------------------------------------------------------------
# tests/test_tracing.py: hot keys on the surfaces, strict HTTP, hedges
# ---------------------------------------------------------------------------


def test_hot_keys_on_metrics_and_report(registry, aggregator):
    sk = HotKeySketch(8)
    sk.observe(np.array([7, 7, 7, 7, 3, 3, 1]))
    aggregator.register("shard-0", sk)
    txt = tm.prometheus_text(registry)
    assert '# TYPE fps_hot_key_traffic gauge' in txt
    assert 'fps_hot_key_traffic{key="7",rank="0"} 4' in txt
    assert "fps_hot_key_error_bound" in txt
    report = tm.build_run_report(registry)
    assert report["hot_keys"]["top"][0]["key"] == 7
    md = tm.render_markdown(report)
    assert "Hot keys" in md


def test_metrics_endpoint_strict_http_reader(registry, aggregator):
    registry.counter("steps_total", component="train").inc(3)
    sk = HotKeySketch(4)
    sk.observe(np.array([9, 9, 2]))
    aggregator.register("serving", sk)
    srv = tm.TelemetryServer(registry).start()
    try:
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=5)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "text/plain; version=0.0.4; charset=utf-8"
        body = resp.read()
        assert len(body) == int(resp.getheader("Content-Length"))
        text = body.decode("utf-8")
        assert "fps_steps_total" in text
        assert 'fps_hot_key_traffic{key="9"' in text
        conn.close()
        # HEAD: same headers, empty body
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=5)
        conn.request("HEAD", "/metrics")
        resp = conn.getresponse()
        assert resp.status == 200
        assert int(resp.getheader("Content-Length")) == len(body) or (
            int(resp.getheader("Content-Length")) > 0
        )
        assert resp.read() == b""
        conn.close()
        out = tm.scrape(srv.host, srv.port, "hotkeys")
        doc = json.loads(out)
        assert doc["hot_keys"]["top"][0]["key"] == 9
    finally:
        srv.stop()


def test_report_hedge_win_rate(registry):
    registry.counter("elastic_hedged_pulls_total", component="elastic").inc(10)
    registry.counter("elastic_hedges_won_total", component="elastic").inc(4)
    report = tm.build_run_report(registry)
    assert report["elastic"]["hedge_win_rate"] == 0.4
    md = tm.render_markdown(report)
    assert "hedged pulls (won / win rate) | 10 (4 / 0.4)" in md


# ---------------------------------------------------------------------------
# tests/test_timeline.py TestSurfaces
# ---------------------------------------------------------------------------


class TestSurfaces:
    def test_timeline_endpoint_null_without_recorder(self):
        from tools.psctl import scrape

        reg = tm.MetricsRegistry()
        prev = get_timeline()
        set_timeline(None)  # the opt-in contract: nothing lazy-creates one
        tsrv = tm.TelemetryServer(reg).start()
        try:
            doc = json.loads(scrape(tsrv.host, tsrv.port, "timeline"))
            assert doc["timeline"] is None
            assert get_timeline() is None  # the scrape installed nothing
        finally:
            tsrv.stop()
            set_timeline(prev)

    def test_psctl_watch_and_timeline_live_smoke(self, capsys):
        from tools.psctl import main as psctl_main

        from flink_parameter_server_tpu_torch.cluster.driver import ClusterConfig
        from flink_parameter_server_tpu_torch.telemetry.timeline import TimelineRecorder
        from flink_parameter_server_tpu_torch.workloads import (
            WorkloadParams,
            build_cluster_driver,
            create_workload,
        )

        reg = tm.MetricsRegistry()
        wl = create_workload("sketch", WorkloadParams(
            rounds=4, batch=32, num_users=24, num_items=32, dim=4, seed=3,
        ), device=CPU)
        driver = build_cluster_driver(
            wl, config=ClusterConfig(num_shards=2, num_workers=1, staleness_bound=0), registry=reg,
        )
        rec = TimelineRecorder(reg, interval_s=0.02)
        tsrv = None
        try:
            with driver:
                rec.sample()
                driver.run(wl.batches())
                time.sleep(0.03)
                rec.sample()  # second tick: rates + RTT window
            set_timeline(rec)
            tsrv = tm.TelemetryServer(reg).start()
            addr = f"{tsrv.host}:{tsrv.port}"

            rc = psctl_main(["watch", "--metrics", addr, "--raw", "--iterations", "2",
                             "--interval", "0.05"])
            assert rc == 0
            out = capsys.readouterr().out
            assert "psctl watch" in out
            assert "fps_" in out and "trend" in out

            rc = psctl_main(["timeline", "cluster_shard_rtt_seconds", "--metrics", addr, "--json"])
            assert rc == 0
            doc = json.loads(capsys.readouterr().out)
            assert doc["metric"] == "cluster_shard_rtt_seconds"
            shards = {s["labels"].get("shard") for s in doc["series"] if s["field"] == "p99"}
            assert shards == {"0", "1"}  # one series per shard
            rc = psctl_main(["timeline", "fps_cluster_shard_rtt_seconds", "--metrics", addr])
            assert rc == 0
            rendered = capsys.readouterr().out
            assert "psctl timeline" in rendered
            assert "shard=0" in rendered and "shard=1" in rendered

            rc = psctl_main(["timeline", "no_such_metric", "--metrics", addr])
            assert rc == 1
        finally:
            set_timeline(None)
            if tsrv is not None:
                tsrv.stop()


# ---------------------------------------------------------------------------
# tests/test_replication.py: the lag gauges on /metrics, the lock witness
# ---------------------------------------------------------------------------


def _identity_init(dim=4):
    def fn(ids):
        return torch.as_tensor(ids, dtype=torch.float32)[:, None] * torch.ones((1, dim))

    return fn


def _wait_for(cond, timeout=10.0, interval=0.005, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def test_lag_gauges_live_on_metrics_endpoint(tmp_path):
    """Per-follower replication_lag is scrapeable on /metrics."""
    from flink_parameter_server_tpu_torch.cluster import ConsistentHashPartitioner, ParamShard, ShardServer
    from flink_parameter_server_tpu_torch.replication import ReplHub, ReplicaShard, WALShipper

    reg = tm.MetricsRegistry()
    part = ConsistentHashPartitioner(16, 1)
    primary = ParamShard(0, part, (2,), wal_dir=str(tmp_path / "p"), registry=False, device=CPU)
    follower = ReplicaShard(0, part, (2,), wal_dir=str(tmp_path / "f"), registry=False, device=CPU)
    fsrv = ShardServer(follower, supervised=False).start()
    hub = ReplHub()
    ship = WALShipper(primary, (fsrv.host, fsrv.port), hub.subscribe(), registry=reg).start()
    primary.attach_repl_sink(hub)
    try:
        primary.push(np.array([1]), np.ones((1, 2), np.float32))
        text = tm.prometheus_text(reg)
        assert "fps_replication_lag" in text
        assert 'component="replication"' in text
    finally:
        ship.stop()
        fsrv.stop()
        primary.close()
        follower.close()


@pytest.mark.analysis
class TestWitnessedReplicationOracle:
    def test_replicated_traffic_zero_inversions(self, tmp_path):
        """Live replicated traffic — ship, async apply, chain-routed
        reads, a promotion — under the lock-order witness: zero
        inversions, and the witness saw the port's locks."""
        from flink_parameter_server_tpu_torch.cluster import ConsistentHashPartitioner, ParamShard, ShardServer
        from flink_parameter_server_tpu_torch.cluster.client import ClusterClient
        from flink_parameter_server_tpu_torch.elastic import MembershipService
        from flink_parameter_server_tpu_torch.nemesis.invariants import check_lock_inversions
        from flink_parameter_server_tpu_torch.replication import ReplHub, ReplicaShard, WALShipper

        with lockwitness.capture() as w:
            part = ConsistentHashPartitioner(64, 1)
            primary = ParamShard(0, part, (4,), init_fn=_identity_init(), wal_dir=str(tmp_path / "p"),
                                 registry=False, device=CPU)
            psrv = ShardServer(primary, supervised=False).start()
            follower = ReplicaShard(0, part, (4,), init_fn=_identity_init(), wal_dir=str(tmp_path / "f"),
                                    registry=False, device=CPU)
            fsrv = ShardServer(follower, supervised=False).start()
            hub = ReplHub()
            ship = WALShipper(primary, (fsrv.host, fsrv.port), hub.subscribe(), registry=False).start()
            primary.attach_repl_sink(hub)
            mem = MembershipService(part, [(psrv.host, psrv.port)], replicas=[[(fsrv.host, fsrv.port)]],
                                    registry=False)
            client = ClusterClient(value_shape=(4,), membership=mem, registry=False, chunk=64)
            errs = []

            def pusher():
                rng = np.random.default_rng(2)
                try:
                    for _ in range(12):
                        ids = rng.choice(64, 4, replace=False)
                        primary.push(ids, rng.normal(size=(4, 4)).astype(np.float32))
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)

            def puller():
                try:
                    for _ in range(12):
                        client.pull_batch(np.arange(8))
                except BaseException as e:  # noqa: BLE001
                    errs.append(e)

            threads = [threading.Thread(target=pusher, daemon=True),
                       threading.Thread(target=puller, daemon=True)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not errs, errs
            _wait_for(lambda: follower.repl_state()["applied"] == primary.head_seq(), msg="caught up")
            ship.stop()
            follower.catch_up()
            follower.promote_to_primary(1)
            client.close()
            psrv.stop()
            fsrv.stop()
            primary.close()
            follower.close()
        assert w.inversions == []
        assert check_lock_inversions(w.inversions).ok
        assert w.acquisitions > 0
        assert any(a.startswith("flink_parameter_server_tpu_torch.cluster.shard") for a in w.edges()) or any(
            "flink_parameter_server_tpu_torch" in b for bs in w.edges().values() for b in bs
        )


# ---------------------------------------------------------------------------
# tests/test_elastic.py: the run report's elastic section
# ---------------------------------------------------------------------------


def test_run_report_carries_elastic_section():
    reg = tm.MetricsRegistry()
    reg.gauge("elastic_epoch", component="elastic").set(3)
    reg.counter("elastic_rows_migrated_total", component="elastic").inc(42)
    reg.counter("elastic_hedged_pulls_total", component="elastic").inc(5)
    reg.counter("elastic_hedges_won_total", component="elastic").inc(2)
    report = tm.build_run_report(reg)
    assert report["elastic"]["epoch"] == 3
    assert report["elastic"]["rows_migrated"] == 42
    assert report["elastic"]["hedged_pulls"] == 5
    md = tm.render_markdown(report)
    assert "rows migrated" in md and "hedged pulls" in md
    assert json.loads(json.dumps(report))  # json-clean


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def _instrument_script(pkg, reg):
    """The same instrument operations on a registry of either package."""
    rng = np.random.default_rng(21)
    reg.counter("train_steps_total", component="train").inc(12)
    reg.counter("train_events_total", component="train").inc(12 * 512)
    reg.counter("serving_requests_total", component="serving").inc(7)
    reg.counter("serving_rejected_total", component="serving").inc(2)
    reg.counter("serving_rejected_total", component="serving", reason="queue_full").inc(2)
    reg.gauge("serving_qps", component="serving").set(123.5)
    reg.gauge("elastic_epoch", component="elastic").set(2)
    reg.counter("elastic_hedged_pulls_total", component="elastic").inc(8)
    reg.counter("elastic_hedges_won_total", component="elastic").inc(3)
    reg.counter("net_bytes_total", component="net", role="server", direction="in", verb="pull").inc(4096)
    reg.counter("net_bytes_total", component="net", role="server", direction="out", verb="pull").inc(65536)
    reg.counter("net_frames_total", component="net", role="server", direction="in", verb="pull").inc(8)
    reg.gauge("slo_healthy", component="slo", slo="pull_p99").set(1)
    reg.gauge("slo_burn_rate", component="slo", slo="pull_p99", window="short").set(0.5)
    reg.gauge("weird label", component="x", note='a"b\\c\nd').set(2.5e20)
    for name, buckets in (("pull_push_latency_seconds", [0.001, 0.01, 0.1]),
                          ("serving_latency_seconds", [0.0005, 0.005, 0.05])):
        h = reg.histogram(name, component="train", buckets=buckets)
        for v in rng.lognormal(-5, 1.5, 200):
            h.observe(float(v))
    sk = pkg.HotKeySketch(8)
    sk.observe(((rng.zipf(1.3, 3000) - 1) % 200).astype(np.int64))
    return sk


def _mask(text):
    return re.sub(r'(ts|run_id)(["=:]\s*)"?[^",}\s]*"?', r"\1\2<masked>", text)


def test_prometheus_text_matches_the_reference(aggregator):
    old_ref = ref_hotkeys.get_aggregator()
    ref_agg = ref_hotkeys.HotKeyAggregator()
    ref_hotkeys.set_aggregator(ref_agg)
    try:
        reg, ref_reg = tm.MetricsRegistry(run_id="port"), ref_tm.MetricsRegistry(run_id="ref")
        aggregator.register("shard-0", _instrument_script(hotkeys, reg))
        ref_agg.register("shard-0", _instrument_script(ref_hotkeys, ref_reg))
        got, want = tm.prometheus_text(reg), ref_tm.prometheus_text(ref_reg)
        assert "fps_hot_key_traffic" in got
        assert _mask(got) == _mask(want)
        assert got.encode() == want.encode()  # neither text carries a ts or run_id
    finally:
        ref_hotkeys.set_aggregator(old_ref)


def test_run_report_matches_the_reference(aggregator):
    old_ref = ref_hotkeys.get_aggregator()
    ref_agg = ref_hotkeys.HotKeyAggregator()
    ref_hotkeys.set_aggregator(ref_agg)
    profs = (port_profiler.PhaseProfiler(tm.MetricsRegistry()),
             ref_profiler.PhaseProfiler(ref_tm.MetricsRegistry()))
    port_profiler.set_profiler(profs[0])
    ref_profiler.set_profiler(profs[1])
    prev_tl, prev_ref_tl = get_timeline(), ref_timeline.get_timeline()
    set_timeline(None)
    ref_timeline.set_timeline(None)
    caches = (HotRowCache(3, registry=False), ref_cache.HotRowCache(3, registry=False))
    try:
        reg, ref_reg = tm.MetricsRegistry(run_id="port"), ref_tm.MetricsRegistry(run_id="ref")
        aggregator.register("shard-0", _instrument_script(hotkeys, reg))
        ref_agg.register("shard-0", _instrument_script(ref_hotkeys, ref_reg))
        rng = np.random.default_rng(4)
        for verb, phase, v in zip(rng.choice(["pull", "push"], 300),
                                  rng.choice(["rtt", "server_queue_wait", "scatter_apply"], 300),
                                  rng.lognormal(-6, 1, 300)):
            for p in profs:
                p.observe(str(verb), str(phase), float(v))
        for c in caches:
            c.fill([1, 2, 3], np.ones((3, 2), np.float32))
            c.tick()
            c.lookup([1, 2, 5])
            c.invalidate([2])
        register_cache("t-parity", caches[0])
        ref_cache.register_cache("t-parity", caches[1])
        got = tm.build_run_report(reg, wall_s=3.0, extra={"arm": "on"})
        want = ref_tm.build_run_report(ref_reg, wall_s=3.0, extra={"arm": "on"})
        for r in (got, want):
            for key in ("generated_at", "run_id", "wall_s"):
                r.pop(key)
        assert set(got) == set(want) and {"hot_keys", "hotcache", "latency_budget", "net", "slo"} <= set(got)
        assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
        assert tm.render_markdown(dict(got, run_id="x", generated_at="t", wall_s=3.0)) == \
            ref_tm.render_markdown(dict(want, run_id="x", generated_at="t", wall_s=3.0))
    finally:
        unregister_cache("t-parity")
        ref_cache.unregister_cache("t-parity")
        port_profiler.set_profiler(None)
        ref_profiler.set_profiler(None)
        set_timeline(prev_tl)
        ref_timeline.set_timeline(prev_ref_tl)
        ref_hotkeys.set_aggregator(old_ref)


def _lock_script(mod):
    """A scripted lock order on one witness: A→B, B→C, then C→A (an
    inversion through the path A ⇝ C), re-entry, a Condition wait, and
    B→A on another thread (a second inversion)."""
    w = mod.LockWitness()
    a = w.wrap(threading.Lock(), "A")
    b = w.wrap(threading.RLock(), "B")
    c = w.wrap(threading.Lock(), "C")
    with a:
        with b:
            with b:  # re-entrant: no edge
                pass
    with b:
        with c:
            pass
    with c:
        with a:  # A ⇝ C exists: inversion
            pass
    cond = threading.Condition(b)
    with cond:
        cond.wait(0.001)

    def other():
        with b:
            with a:  # A → B exists: inversion
                pass

    t = threading.Thread(target=other, name="witness-other")
    t.start()
    t.join()
    strict = mod.LockWitness(raise_on_inversion=True)
    x, y = strict.wrap(threading.Lock(), "X"), strict.wrap(threading.Lock(), "Y")
    with x:
        with y:
            pass
    raised = None
    with y:
        try:
            with x:
                pass
        except mod.LockInversion as e:
            raised = str(e)
    return w.inversions, {k: sorted(v) for k, v in w.edges().items()}, w.acquisitions, raised, x.locked()


def test_lock_witness_matches_the_reference():
    got, want = _lock_script(lockwitness), _lock_script(ref_lockwitness)
    assert len(got[0]) == 2 and got[3] is not None
    assert got == want
