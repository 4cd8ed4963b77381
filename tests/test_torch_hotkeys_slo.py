"""The port's hot-key sketches (``telemetry/hotkeys.py``) and SLO engine
(``telemetry/slo.py``) against the JAX package's, on the CPU.

Mirrors tests/test_tracing.py's TestHotKeys tests that need no endpoint
(3 of 4: ``test_hot_keys_on_metrics_and_report`` is mirrored with the
exporter and the run report in tests/test_torch_telemetry_surfaces.py),
its TestSLO (3) and tests/test_replication.py's
``test_failover_slo_registered_and_fed``.
``test_burn_rate_windows_and_verdicts`` reads the SLO's probe gauges from
the registry and, as the reference's does, off ``prometheus_text`` and the
run report.  The cluster mirror runs a port ``ClusterDriver`` with
``device="cpu"``.

Parity with the reference, exact (both sides are numpy and Python, and the
ranking of a few hundred integer counts is exact in float32):
  * both packages' ``HotKeySketch`` give the same ``top_k``, ``estimate``
    and ``error_bound`` on the same seeded Zipf stream, with and without
    the windowed decay;
  * both ``HotKeyAggregator.top_k`` give the same ranking (the reference on
    its CPU device, the port with ``device="cpu"``), and both clusters'
    per-shard sketches see the same traffic;
  * both ``SLOEngine`` give the same verdicts on the same traffic.
The device rule: ``HotKeyAggregator()`` ranks on the card, so without one
``top_k`` raises, and ``candidates()`` (host only) does not.
"""
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.cluster import ClusterConfig as RefClusterConfig
from flink_parameter_server_tpu.cluster import ClusterDriver as RefClusterDriver
from flink_parameter_server_tpu.data.movielens import synthetic_ratings as ref_ratings
from flink_parameter_server_tpu.data.streams import microbatches as ref_microbatches
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.telemetry import hotkeys as ref_hotkeys
from flink_parameter_server_tpu.telemetry import slo as ref_slo
from flink_parameter_server_tpu.telemetry.registry import MetricsRegistry as RefRegistry
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch import telemetry as tm
from flink_parameter_server_tpu_torch.cluster import ClusterConfig, ClusterDriver
from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
from flink_parameter_server_tpu_torch.data.streams import microbatches
from flink_parameter_server_tpu_torch.elastic import ElasticController, ScalePolicy
from flink_parameter_server_tpu_torch.models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
)
from flink_parameter_server_tpu_torch.telemetry.hotkeys import (
    CountMinSketch,
    HotKeyAggregator,
    HotKeySketch,
)
from flink_parameter_server_tpu_torch.telemetry import slo as port_slo
from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
from flink_parameter_server_tpu_torch.telemetry.slo import (
    SLOEngine,
    SLOSpec,
    default_slos,
    failover_slo,
    pull_latency_slo,
)
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

torch.set_num_threads(2)

pytestmark = [pytest.mark.telemetry, pytest.mark.trace]


@pytest.fixture()
def registry():
    reg = tm.MetricsRegistry(run_id="trace-test-run")
    old = tm.get_registry()
    tm.set_registry(reg)
    yield reg
    tm.set_registry(old)


@pytest.fixture()
def aggregator():
    agg = HotKeyAggregator(device="cpu")
    old = tm.get_aggregator()
    tm.set_aggregator(agg)
    yield agg
    tm.set_aggregator(old)


# ---------------------------------------------------------------------------
# hot-key sketch: oracle accuracy, merge, the cluster's shard sketches
# ---------------------------------------------------------------------------


class TestHotKeys:
    def test_topk_matches_exact_oracle_on_zipf(self):
        rng = np.random.default_rng(0)
        ids = ((rng.zipf(1.3, 60_000) - 1) % 2_000).astype(np.int64)
        sk = HotKeySketch(32)
        for chunk in np.array_split(ids, 120):
            sk.observe(chunk)
        exact = np.bincount(ids, minlength=2_000)
        top = sk.top_k(10)
        assert [t["key"] for t in top] == np.argsort(-exact)[:10].tolist()
        # documented bounds: count never underestimates, and
        # overestimates by at most max(per-key err, cms ε·N)
        bound = sk.error_bound()
        for t in top:
            true = int(exact[t["key"]])
            assert true <= t["count"] <= true + max(t["err"], bound), (
                t, true, bound,
            )

    def test_merge_across_shards_and_ops_topk_selection(self, aggregator):
        rng = np.random.default_rng(1)
        ids = ((rng.zipf(1.4, 30_000) - 1) % 500).astype(np.int64)
        # shard-partition the stream by parity — each sketch sees HALF
        a, b = HotKeySketch(16), HotKeySketch(16)
        a.observe(ids[ids % 2 == 0])
        b.observe(ids[ids % 2 == 1])
        aggregator.register("shard-0", a)
        aggregator.register("shard-1", b)
        exact = np.bincount(ids, minlength=500)
        merged_top = [t["key"] for t in aggregator.top_k(5)]
        assert merged_top == np.argsort(-exact)[:5].tolist()
        snap = aggregator.snapshot()
        assert snap["total_observed"] == 30_000
        assert snap["sketches"] == ["shard-0", "shard-1"]

    def test_cluster_driver_wires_shard_sketches(self, aggregator):
        logic = OnlineMatrixFactorization(
            16, 4, updater=SGDUpdater(0.05), device="cpu"
        )
        driver = ClusterDriver(
            logic, capacity=32, value_shape=(4,),
            init_fn=ranged_random_factor(2, (4,)),
            config=ClusterConfig(
                num_shards=2, num_workers=1, hot_keys=True, hot_key_k=8,
            ),
            registry=False, device="cpu",
        )
        cols = synthetic_ratings(16, 32, 4 * 64, seed=2)
        with driver:
            driver.run(list(microbatches(cols, 64)))
            assert aggregator.labels() == ["shard-0", "shard-1"]
            assert aggregator.total() > 0
            assert aggregator.top_k(3)
        # driver.stop() unregisters its sketches
        assert aggregator.labels() == []


def _zipf_chunks(seed, n=40_000, keys=3_000, parts=37):
    rng = np.random.default_rng(seed)
    ids = ((rng.zipf(1.2, n) - 1) % keys).astype(np.int64)
    return ids, np.array_split(ids, parts)


@pytest.mark.parametrize("kw", [
    dict(k=16),
    dict(k=32, width=512, depth=4, seed=7, buffer_ids=4096),
    dict(k=8, decay_window=9_000, buffer_ids=1000),
])
def test_sketch_equals_the_reference(kw):
    ids, chunks = _zipf_chunks(11)
    port, ref = HotKeySketch(**kw), ref_hotkeys.HotKeySketch(**kw)
    for i, chunk in enumerate(chunks):
        port.observe(chunk)
        ref.observe(chunk)
        if i % 9 == 4:  # the explicit-counts path folds in at once
            u, c = np.unique(chunk[:50], return_counts=True)
            port.observe(u, c)
            ref.observe(u, c)
    probe = np.arange(0, 3_000, 7, dtype=np.int64)
    assert port.top_k() == ref.top_k()
    assert port.top_k(5) == ref.top_k(5)
    np.testing.assert_array_equal(port.estimate(probe), ref.estimate(probe))
    assert port.error_bound() == ref.error_bound()
    assert port.total == ref.total and port.decays == ref.decays
    np.testing.assert_array_equal(port.cms.table, ref.cms.table)


def test_count_min_halve_and_merge_equal_the_reference():
    ids, _ = _zipf_chunks(12, n=5_000)
    a, b = CountMinSketch(64, 3, seed=4), ref_hotkeys.CountMinSketch(64, 3, seed=4)
    a.add(ids)
    b.add(ids)
    a.halve()
    b.halve()
    a.merge(a)
    b.merge(b)
    np.testing.assert_array_equal(a.table, b.table)
    assert a.total == b.total and a.epsilon == b.epsilon
    with pytest.raises(ValueError, match="identical"):
        a.merge(CountMinSketch(64, 3, seed=5))


def test_aggregator_ranking_equals_the_reference():
    """Four shard sketches of a partitioned Zipf stream, merged and ranked
    through ops/topk by both packages: the same ranked records, ties
    (equal counts) lowest candidate first as ``lax.top_k`` breaks them."""
    ids, chunks = _zipf_chunks(13, n=60_000, keys=800)
    port, ref = HotKeyAggregator(device="cpu"), ref_hotkeys.HotKeyAggregator()
    for s in range(4):
        ps, rs = HotKeySketch(24), ref_hotkeys.HotKeySketch(24)
        for chunk in chunks:
            mine = chunk[chunk % 4 == s]
            ps.observe(mine)
            rs.observe(mine)
        port.register(f"shard-{s}", ps)
        ref.register(f"shard-{s}", rs)
    for n in (1, 10, 24, 200):
        assert port.top_k(n) == ref.top_k(n)
        assert port.candidates(n) == ref.candidates(n)
    counts = [t["count"] for t in port.top_k(200)]
    assert counts == sorted(counts, reverse=True) and len(counts) == 24
    # equal counts: both rank the candidates in their (count, key) order
    ties = []
    for agg, cls in ((HotKeyAggregator(device="cpu"), HotKeySketch),
                     (ref_hotkeys.HotKeyAggregator(), ref_hotkeys.HotKeySketch)):
        sk = cls(8)
        sk.observe(np.array([9, 9, 5, 5, 2, 2, 7, 9]))
        agg.register("shard-0", sk)
        ties.append(agg.top_k(3))
    assert ties[0] == ties[1] == [{"key": 9, "count": 3, "err": 0}, {"key": 2, "count": 2, "err": 0},
                                  {"key": 5, "count": 2, "err": 0}]
    assert port.total() == ref.total() == ids.size
    assert port.error_bound() == ref.error_bound()
    assert port.exposition(5) == ref.exposition(5)
    assert port.snapshot(5) == ref.snapshot(5)


def test_aggregator_ranks_on_the_card_by_default():
    agg = HotKeyAggregator()
    sk = HotKeySketch(8)
    sk.observe(np.array([7, 7, 7, 7, 3, 3, 1]))
    agg.register("shard-0", sk)
    assert agg.candidates(2) == [{"key": 7, "count": 4, "err": 0},
                                 {"key": 3, "count": 2, "err": 0}]
    if torch.cuda.is_available():
        assert agg.top_k(2) == agg.candidates(2)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            agg.top_k(2)
        with pytest.raises(RuntimeError, match="cuda"):
            HotKeyAggregator().top_k(2)  # even with nothing to rank
    assert HotKeyAggregator(device="cpu").top_k(2) == []


def test_cluster_sketches_see_what_the_reference_cluster_sees(aggregator):
    """The same MF stream through both packages' 2-shard clusters with
    ``hot_keys=True`` (one worker, so each shard's frames arrive in one
    order): every shard sketch reports the same candidates and totals."""
    ref_agg = ref_hotkeys.HotKeyAggregator()
    old = ref_hotkeys.get_aggregator()
    ref_hotkeys.set_aggregator(ref_agg)
    try:
        batches = list(microbatches(synthetic_ratings(40, 96, 6 * 128, seed=5), 128))
        ref_batches = list(ref_microbatches(ref_ratings(40, 96, 6 * 128, seed=5), 128))
        cfg = dict(num_shards=2, num_workers=1, hot_keys=True, hot_key_k=8)
        port = ClusterDriver(
            OnlineMatrixFactorization(40, 4, updater=SGDUpdater(0.05), device="cpu"),
            capacity=96, value_shape=(4,), init_fn=ranged_random_factor(2, (4,)),
            config=ClusterConfig(**cfg), registry=False, device="cpu",
        )
        ref = RefClusterDriver(
            ref_mf.OnlineMatrixFactorization(40, 4, updater=ref_mf.SGDUpdater(0.05)),
            capacity=96, value_shape=(4,), init_fn=ref_init(2, (4,)),
            config=RefClusterConfig(**cfg), registry=False,
        )
        with port, ref:
            port.run(batches)
            ref.run(ref_batches)
            assert aggregator.labels() == ref_agg.labels() == ["shard-0", "shard-1"]
            for label in aggregator.labels():
                mine, theirs = aggregator._sketches[label], ref_agg._sketches[label]
                assert mine.total == theirs.total > 0
                assert mine.top_k() == theirs.top_k()
            assert aggregator.top_k(8) == ref_agg.top_k(8)
        assert aggregator.labels() == ref_agg.labels() == []
    finally:
        ref_hotkeys.set_aggregator(old)


def test_knobs_of_later_modules_still_raise_beside_hot_keys():
    """``hot_keys=True`` is served now; with it on, the knob that leads
    into a module not ported yet still raises naming Queue 1 #7, and the
    adaptive and tiered knobs are served beside it."""
    logic = OnlineMatrixFactorization(16, 4, updater=SGDUpdater(0.05), device="cpu")
    with pytest.raises(NotImplementedError, match="shmem") as e:
        ClusterDriver(logic, capacity=32, value_shape=(4,),
                      config=ClusterConfig(hot_keys=True, wire_proto="shm"), registry=False, device="cpu")
    assert "Queue 1 #7" in str(e.value)
    for kw in (dict(adaptive=True), dict(store_backend="tiered", tier_hot_rows=8)):
        d = ClusterDriver(logic, capacity=32, value_shape=(4,), config=ClusterConfig(hot_keys=True, **kw),
                          registry=False, device="cpu")
        with d:
            assert d.shards[0].hotkeys is not None
            assert type(d.clock).__name__ == ("AdaptiveClock" if "adaptive" in kw else "StalenessClock")


# ---------------------------------------------------------------------------
# SLO engine: burn rates, verdicts, controller pressure
# ---------------------------------------------------------------------------


def _gauges(reg, name):
    return {tuple(sorted(i.labels.items())): i.value for i in reg.instruments() if i.name == name}


class TestSLO:
    def test_burn_rate_windows_and_verdicts(self, registry, aggregator):
        t = [0.0]
        engine = SLOEngine(
            [pull_latency_slo(0.025, target=0.9)],
            registry=registry, windows=(10.0, 30.0), page_burn=2.0,
            clock=lambda: t[0],
        )
        h = registry.histogram(
            "cluster_pull_rtt_seconds", component="cluster"
        )
        engine.sample()  # baseline at t=0 with nothing observed
        assert engine.status("pull_p99")["verdict"] == "no_data"
        for _ in range(50):
            h.observe(0.001)  # good
        t[0] = 5.0
        engine.sample()
        assert engine.status("pull_p99")["verdict"] == "ok"
        for _ in range(50):
            h.observe(1.0)  # bad: way past 25 ms
        t[0] = 6.0
        engine.sample()
        st = engine.status("pull_p99")
        assert st["verdict"] == "breach", st
        assert st["burn_short"] > 2.0 and st["burn_long"] > 2.0
        assert engine.breached() == ["pull_p99"]
        # the probe gauges the endpoint renders, read off the registry
        burn = _gauges(registry, "slo_burn_rate")
        assert set(burn) == {
            (("component", "slo"), ("slo", "pull_p99"), ("window", w)) for w in ("short", "long")
        }
        assert all(v > 2.0 for v in burn.values())
        assert _gauges(registry, "slo_healthy") == {
            (("component", "slo"), ("slo", "pull_p99")): 0.0
        }
        # the probe gauges render on /metrics under component=slo
        txt = tm.prometheus_text(registry, include_hot_keys=False)
        assert 'fps_slo_burn_rate{component="slo"' in txt
        assert 'fps_slo_healthy{component="slo",slo="pull_p99"} 0' in txt
        # and the run report carries the verdict roll-up
        report = tm.build_run_report(registry)
        assert report["slo"]["pull_p99"]["healthy"] is False
        assert "SLO verdicts" in tm.render_markdown(report)

    def test_bound_kind_over_gauges(self, registry):
        t = [0.0]
        spec = SLOSpec("staleness", "cluster_staleness_steps", 4.0,
                       target=0.9, kind="bound")
        engine = SLOEngine(
            [spec], registry=registry, windows=(10.0, 30.0),
            clock=lambda: t[0], register_gauges=False,
        )
        g = registry.gauge("cluster_staleness_steps", component="cluster")
        g.set(1.0)
        engine.sample()
        t[0] = 1.0
        g.set(100.0)  # past the bound: every sample now bad
        for _ in range(8):
            t[0] += 1.0
            engine.sample()
        st = engine.status("staleness")
        assert st["verdict"] == "breach", st

    def test_slo_breach_pressures_elastic_controller(self, registry):
        class _StubDriver:
            class _Part:
                num_shards = 2

            partitioner = _Part()
            registry = None

            def shard_alive(self, s):
                return True

        t = [0.0]
        engine = SLOEngine(
            [pull_latency_slo(0.025, target=0.9)],
            registry=registry, windows=(10.0, 30.0),
            clock=lambda: t[0], register_gauges=False,
        )
        h = registry.histogram(
            "cluster_pull_rtt_seconds", component="cluster"
        )
        engine.sample()
        for _ in range(100):
            h.observe(1.0)
        t[0] = 5.0
        engine.sample()
        # raw thresholds are parked out of reach: only the SLO signal
        # can pressure the policy
        ctl = ElasticController(
            _StubDriver(), registry=registry, slo=engine,
            policy=ScalePolicy(
                scale_out_rtt_p99_s=1e9, min_window_frames=10**9,
                scale_out_queue_depth=1e9, max_shards=4,
            ),
        )
        decision = ctl.evaluate()
        assert decision is not None and decision["action"] == "scale_out"
        assert decision["slo_breaches"] == ["pull_p99"]


def test_failover_slo_registered_and_fed():
    assert any(s.name == "failover_time" for s in default_slos())
    spec = failover_slo()
    assert spec.metric == "replication_failover_seconds"
    reg = MetricsRegistry()
    h = reg.histogram(
        "replication_failover_seconds", component="replication"
    )
    engine = SLOEngine(
        [spec], registry=reg, windows=(0.5, 1.0),
        register_gauges=False,
    )
    engine.sample()  # the window baseline
    h.observe(0.02)  # one sub-second failover
    engine.sample()
    status = engine.status("failover_time")
    assert status["verdict"] == "ok"
    assert status["window_total"] == 1.0


def test_slo_verdicts_equal_the_reference():
    """Every default objective plus a tight pull objective, fed the same
    histograms and gauges on the same fake clock, through both engines:
    the same status documents at every step (burns, verdicts, totals)."""
    rng = np.random.default_rng(31)
    sides = []
    for pkg, registry_cls in ((port_slo, MetricsRegistry), (ref_slo, RefRegistry)):
        reg, t = registry_cls(), [0.0]
        specs = pkg.default_slos() + [pkg.SLOSpec("pull_tight", "cluster_pull_rtt_seconds", 0.002, 0.95)]
        engine = pkg.SLOEngine(specs, registry=reg, windows=(5.0, 20.0), clock=lambda t=t: t[0])
        sides.append((reg, t, engine))
    history = [[], []]
    for step in range(30):
        lat = rng.lognormal(-6.0 + (1.5 if 12 <= step < 20 else 0.0), 0.6, 40).tolist()
        stale = float(rng.integers(0, 8))
        for i, (reg, t, engine) in enumerate(sides):
            t[0] = float(step)
            h = reg.histogram("cluster_pull_rtt_seconds", component="cluster", shard="0")
            for v in lat:
                h.observe(v)
            reg.gauge("cluster_staleness_steps", component="cluster").set(stale)
            engine.sample()
            history[i].append((engine.verdicts(), engine.breached()))
    assert history[0] == history[1]
    seen = {v["verdict"] for verdicts, _ in history[0] for v in verdicts}
    assert {"ok", "breach", "no_data"} <= seen
