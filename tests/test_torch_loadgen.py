"""The port's ``loadgen/`` against the JAX package's.

Parity (the same seeded inputs through both packages, the port on
``device="cpu"``), every comparison bitwise or exactly equal:
  * every arrival curve at a grid of times, ``poisson_arrivals`` for the
    same seed (the float64 arrays byte for byte) and ``split_slots``;
  * ``UserPopulation``: hot items, head share and whole request streams
    (kind, region, user, ids), with and without custom regions;
  * ``GoodputLedger.summary()`` / ``timeline()`` fed the same recorded
    events, and ``autoscaler_score`` on the same timeline;
  * the workloads' soak hooks (``soak_read_ids`` / ``soak_push``) for mf,
    pa and sketch on the same generator;
  * ``SoakConfig``'s field names and defaults, and ``SoakReport.as_dict()``'s
    keys.

Mirrors tests/test_loadgen.py against the port: ``TestArrivals`` (5),
``TestPopulation`` (3), ``TestRetryBudget`` (2), ``TestCircuitBreaker`` (4),
``TestShedders`` (2), ``TestBrownout`` (3), ``TestClientBudget`` (3),
``TestServingAdmission`` (4), ``TestControllerFlapping`` (2) and both
``TestSoakSmoke`` soaks (2).  ``TestShardEdge`` is mirrored in
tests/test_torch_cluster.py; ``TestPsctlSlo`` and ``TestSoakLint`` wait for
the tooling mirrors (ROADMAP Queue 1 #7h).  The soaks assert only what does
not depend on the machine's speed: every arrival classified once, the
latency anchor, the verdicts, the JSON round-trip, and sheds without
errors in the far-overloaded arm.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.loadgen import arrivals as ref_arrivals
from flink_parameter_server_tpu.loadgen import population as ref_population
from flink_parameter_server_tpu.loadgen import soak as ref_soak
from flink_parameter_server_tpu.nemesis.invariants import Verdict as RefVerdict
from flink_parameter_server_tpu.workloads import WorkloadParams as RefParams
from flink_parameter_server_tpu.workloads import create_workload as ref_create
from flink_parameter_server_tpu_torch.loadgen import arrivals, soak
from flink_parameter_server_tpu_torch.loadgen.arrivals import (
    constant_rate,
    diurnal_rate,
    flash_crowds,
    poisson_arrivals,
    ramp_rate,
    split_slots,
)
from flink_parameter_server_tpu_torch.loadgen.overload import (
    BreakerBoard,
    BrownoutController,
    CircuitBreaker,
    LoadShedder,
    OverloadGuard,
    RetryBudget,
    RetryBudgetExhausted,
)
from flink_parameter_server_tpu_torch.loadgen.population import Region, UserPopulation
from flink_parameter_server_tpu_torch.nemesis.invariants import Verdict
from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
from flink_parameter_server_tpu_torch.workloads import WorkloadParams, create_workload

torch.set_num_threads(2)

pytestmark = pytest.mark.loadgen

CPU = "cpu"


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def _curves(mod):
    base, mx = mod.constant_rate(100.0)
    return {
        "constant": mod.constant_rate(120.0),
        "diurnal": mod.diurnal_rate(50.0, 250.0, period_s=100.0, phase=0.3),
        "ramp": mod.ramp_rate(10.0, 100.0, 10.0),
        "flash": mod.flash_crowds(base, mx, [(5.0, 2.0, 4.0), (7.5, 1.0, 2.5)]),
    }


@pytest.mark.parametrize("curve", ["constant", "diurnal", "ramp", "flash"])
def test_arrivals_match_the_reference_bitwise(curve):
    fn, mx = _curves(arrivals)[curve]
    rfn, rmx = _curves(ref_arrivals)[curve]
    assert mx == rmx
    grid = np.linspace(0.0, 30.0, 301)
    assert [fn(t) for t in grid] == [rfn(t) for t in grid]
    for seed in (0, 7, 123):
        a = poisson_arrivals(fn, mx, 20.0, seed=seed)
        b = ref_arrivals.poisson_arrivals(rfn, rmx, 20.0, seed=seed)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for n in (1, 3, 6):
            got, want = split_slots(a, n), ref_arrivals.split_slots(b, n)
            assert [x.tobytes() for x in got] == [x.tobytes() for x in want]


def _stream_key(reqs):
    return [(r.kind, r.region, r.user, r.ids.dtype.str, r.ids.tobytes()) for r in reqs]


@pytest.mark.parametrize("custom_regions", [False, True])
def test_population_streams_match_the_reference(custom_regions):
    kw = dict(zipf_s=1.1, batch_ids=4, seed=5)
    if custom_regions:
        kw["regions"] = [Region("eu", weight=2.0, serve_frac=0.9), Region("us", weight=1.0, serve_frac=0.3)]
        ref_kw = dict(kw, regions=[ref_population.Region("eu", weight=2.0, serve_frac=0.9),
                                   ref_population.Region("us", weight=1.0, serve_frac=0.3)])
    else:
        ref_kw = kw
    pop = UserPopulation(512, 2048, **kw)
    ref = ref_population.UserPopulation(512, 2048, **ref_kw)
    assert pop.hot_items(64).tobytes() == ref.hot_items(64).tobytes()
    assert pop.head_share(20) == ref.head_share(20)
    assert _stream_key(pop.request_stream(400, seed=4)) == _stream_key(ref.request_stream(400, seed=4))
    rng, ref_rng = np.random.default_rng(9), np.random.default_rng(9)
    assert _stream_key([pop.sample(rng) for _ in range(50)]) == _stream_key(
        [ref.sample(ref_rng) for _ in range(50)])


def _events(seed, duration_s, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        outcome = ("ok", "late", "shed", "error")[int(rng.integers(0, 4))]
        lat = None if outcome == "error" else float(rng.exponential(0.05))
        out.append((float(rng.uniform(-0.5, duration_s + 1.0)), outcome, lat))
    return out


def test_goodput_ledger_and_score_match_the_reference():
    ours, theirs = soak.GoodputLedger(6.5), ref_soak.GoodputLedger(6.5)
    for offset, outcome, lat in _events(3, 6.5, 500):
        ours.record(offset, outcome, lat)
        theirs.record(offset, outcome, lat)
    assert ours.summary() == theirs.summary()
    assert ours.timeline() == theirs.timeline()
    empty, ref_empty = soak.GoodputLedger(2.0), ref_soak.GoodputLedger(2.0)
    assert empty.summary() == ref_empty.summary()
    fn, _ = diurnal_rate(20.0, 120.0, 8.0)
    rfn, _ = ref_arrivals.diurnal_rate(20.0, 120.0, 8.0)
    for cap in (50.0, 90.0, 200.0):
        for target in (0.5, 0.9):
            assert soak.autoscaler_score(ours.timeline(), fn, cap, slo_target=target) == \
                ref_soak.autoscaler_score(theirs.timeline(), rfn, cap, slo_target=target)


@pytest.mark.parametrize("name", ["mf", "pa", "sketch"])
def test_soak_hooks_match_the_reference(name):
    p = dict(num_users=64, num_items=256, dim=8, seed=1)
    wl = create_workload(name, WorkloadParams(**p), device=CPU)
    ref = ref_create(name, RefParams(**p))
    ids = np.random.default_rng(2).integers(0, 100_000, 40)
    got, want = wl.soak_read_ids(ids), ref.soak_read_ids(ids)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.tobytes() == want.tobytes()
    pid, pd = wl.soak_push(np.random.default_rng(3), ids)
    rid, rd = ref.soak_push(np.random.default_rng(3), ids)
    assert isinstance(pd, np.ndarray) and pd.shape == (pid.size,) + tuple(wl.value_shape)
    assert pid.tobytes() == rid.tobytes() and pd.dtype == rd.dtype and pd.tobytes() == rd.tobytes()


def test_soak_config_and_report_keys_match_the_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(soak.SoakConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(ref_soak.SoakConfig)]
    assert ours == theirs
    assert [f.name for f in dataclasses.fields(soak.SoakReport)] == \
        [f.name for f in dataclasses.fields(ref_soak.SoakReport)]
    args = dict(summary={"arrivals": 1}, timeline=[], faults={"b": 1, "a": 2}, cache={}, overload={},
                controller_events=[], wall_s=1.23456)
    rep = soak.SoakReport(verdicts=[Verdict("v", True, "d")], **args)
    ref = ref_soak.SoakReport(verdicts=[RefVerdict("v", True, "d")], **args)
    assert rep.as_dict() == ref.as_dict()
    assert list(rep.as_dict()) == list(ref.as_dict())


def test_soak_runner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default would run there")
    with pytest.raises(RuntimeError, match="cuda"):
        soak.SoakRunner(soak.SoakConfig())


# ---------------------------------------------------------------------------
# arrivals.py (tests/test_loadgen.py TestArrivals)
# ---------------------------------------------------------------------------


class TestArrivals:
    def test_poisson_seeded_and_rate_tracking(self):
        fn, mx = constant_rate(200.0)
        a = poisson_arrivals(fn, mx, 10.0, seed=7)
        b = poisson_arrivals(fn, mx, 10.0, seed=7)
        np.testing.assert_array_equal(a, b)
        assert poisson_arrivals(fn, mx, 10.0, seed=8).size != 0
        assert abs(len(a) - 2000) < 4 * np.sqrt(2000)
        assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 10.0

    def test_diurnal_shape(self):
        fn, mx = diurnal_rate(50.0, 250.0, period_s=100.0)
        assert fn(0.0) == pytest.approx(50.0)
        assert fn(50.0) == pytest.approx(250.0)
        assert mx == 250.0
        a = poisson_arrivals(fn, mx, 100.0, seed=1)
        first = ((a >= 25.0) & (a < 75.0)).sum()
        assert first > 1.4 * (len(a) - first)

    def test_flash_crowds_multiply(self):
        base, mx = constant_rate(100.0)
        fn, worst = flash_crowds(base, mx, [(5.0, 2.0, 4.0)])
        assert fn(4.9) == 100.0 and fn(5.5) == 400.0 and fn(7.1) == 100.0
        assert worst == 400.0
        a = poisson_arrivals(fn, worst, 10.0, seed=2)
        assert ((a >= 5.0) & (a < 7.0)).sum() > 2.5 * ((a >= 0.0) & (a < 2.0)).sum()

    def test_ramp_and_thinning_bound(self):
        fn, mx = ramp_rate(10.0, 100.0, 10.0)
        assert fn(0) == 10.0 and fn(10.0) == 100.0 and fn(99.0) == 100.0
        assert mx == 100.0
        with pytest.raises(ValueError, match="exceeds rate_max"):
            poisson_arrivals(lambda t: 50.0, 10.0, 5.0, seed=0)

    def test_split_slots_preserves_absolute_times(self):
        a = np.arange(10, dtype=np.float64)
        slots = split_slots(a, 3)
        assert sorted(np.concatenate(slots).tolist()) == a.tolist()
        np.testing.assert_array_equal(slots[1], [1.0, 4.0, 7.0])


# ---------------------------------------------------------------------------
# population.py (TestPopulation)
# ---------------------------------------------------------------------------


class TestPopulation:
    def test_regional_serve_train_mix(self):
        pop = UserPopulation(64, 256, regions=[Region("r1", weight=1.0, serve_frac=0.8)], seed=3)
        reqs = pop.request_stream(1000, seed=4)
        serve = sum(1 for r in reqs if r.kind == "serve")
        assert 740 <= serve <= 860
        assert {r.region for r in reqs} == {"r1"}

    def test_zipf_head_concentration_and_secret_head(self):
        pop = UserPopulation(128, 2048, zipf_s=1.1, seed=5)
        share = pop.head_share(20)
        assert 0.15 < share < 0.9
        hot = pop.hot_items(20)
        assert set(hot.tolist()) != set(range(20))
        reqs = pop.request_stream(600, seed=6)
        ids = np.concatenate([r.ids for r in reqs])
        assert np.isin(ids, hot).mean() > 0.6 * share

    def test_deterministic_streams(self):
        pop = UserPopulation(32, 64, seed=9)
        for x, y in zip(pop.request_stream(50, seed=1), pop.request_stream(50, seed=1)):
            assert x.kind == y.kind and x.user == y.user
            np.testing.assert_array_equal(x.ids, y.ids)


# ---------------------------------------------------------------------------
# overload.py: budget, breaker, shedders, brownout
# ---------------------------------------------------------------------------


class TestRetryBudget:
    def test_spend_exhaust_refill(self):
        reg = MetricsRegistry()
        b = RetryBudget(2.0, refill_per_success=0.5, registry=reg, worker="w0")
        assert b.try_spend() and b.try_spend()
        assert not b.try_spend()
        assert b.exhausted == 1
        for _ in range(2):
            b.on_success()
        assert b.tokens() == pytest.approx(1.0)
        assert b.try_spend() and not b.try_spend()
        gauges = [i for i in reg.instruments() if i.name == "retry_budget_tokens"]
        assert gauges and gauges[0].value == pytest.approx(0.0)
        counters = [i for i in reg.instruments() if i.name == "retry_budget_exhausted_total"]
        assert counters[0].value == 2.0

    def test_refill_caps_at_capacity(self):
        b = RetryBudget(1.5, refill_per_success=10.0, registry=False)
        b.on_success()
        assert b.tokens() == pytest.approx(1.5)


class TestCircuitBreaker:
    def test_full_cycle(self):
        clock = [0.0]
        br = CircuitBreaker(window_s=1.0, min_failures=3, failure_rate=0.5, cooldown_s=0.5,
                            clock=lambda: clock[0])
        assert br.allow() and br.state == "closed"
        for _ in range(3):
            br.fail()
        assert br.state == "open" and not br.allow()
        clock[0] = 0.6
        assert br.allow() and br.state == "half_open"
        assert not br.allow()
        br.ok()
        assert br.state == "closed" and br.allow()

    def test_half_open_probe_failure_reopens(self):
        clock = [0.0]
        br = CircuitBreaker(min_failures=2, cooldown_s=0.5, clock=lambda: clock[0])
        br.fail()
        br.fail()
        assert br.state == "open"
        clock[0] = 0.6
        assert br.allow()
        br.fail()
        assert br.state == "open" and not br.allow()
        clock[0] = 1.2
        assert br.allow()

    def test_failure_rate_gate(self):
        clock = [0.0]
        br = CircuitBreaker(min_failures=3, failure_rate=0.5, clock=lambda: clock[0])
        for _ in range(10):
            br.ok()
        for _ in range(4):
            br.fail()
        assert br.state == "closed"

    def test_board_keys_and_gauges(self):
        clock = [0.0]
        reg = MetricsRegistry()
        board = BreakerBoard(min_failures=2, cooldown_s=0.5, registry=reg, clock=lambda: clock[0])
        assert board.allow(0) and board.allow(1)
        board.fail(0)
        board.fail(0)
        assert not board.allow(0) and board.allow(1)
        assert board.open_count() == 1
        g = [i for i in reg.instruments() if i.name == "overload_breaker_open"][0]
        assert g.value == 1.0
        trans = [i for i in reg.instruments()
                 if i.name == "overload_breaker_transitions_total" and i.labels.get("state") == "open"][0]
        assert trans.value == 1.0


class TestShedders:
    def test_guard_priority_matrix(self):
        reg = MetricsRegistry()
        g = OverloadGuard(sheddable_depth=2, read_depth=8, write_depth=None, registry=reg, shard=0)
        assert g.admit("pull", None, depth=8)
        assert not g.admit("pull", None, depth=9)
        assert g.admit("pull", 2, depth=2)
        assert not g.admit("pull", 2, depth=3)
        assert not g.admit("lease", None, depth=3)
        assert g.admit("push", 2, depth=1000)
        assert g.admit("pull", 0, depth=1000)
        assert g.sheds == 3
        shed = {i.labels.get("verb"): i.value for i in reg.instruments() if i.name == "overload_shed_total"}
        assert shed["pull"] == 2.0 and shed["lease"] == 1.0

    def test_load_shedder_fractions(self):
        s = LoadShedder(shed_at=0.5, normal_at=0.75, registry=False)
        assert s.admit(1, 10)
        assert not s.admit(5, 10)
        assert s.admit(5, 10, priority=1)
        assert not s.admit(8, 10, priority=1)
        assert s.admit(10, 10, priority=0)
        assert s.sheds == 2


class TestBrownout:
    def test_enter_widen_exit(self):
        from flink_parameter_server_tpu_torch.hotcache.cache import HotRowCache

        clock = [0.0]
        cache = HotRowCache(4, registry=False)
        ctl = BrownoutController([cache], widen_factor=3.0, enter_sheds=3, window_s=1.0, exit_quiet_s=0.5,
                                 registry=False, clock=lambda: clock[0])
        for _ in range(3):
            ctl.note_shed()
        assert ctl.active and cache.widen_mult == 3.0
        assert ctl.entries == 1
        clock[0] = 0.3
        ctl.note_ok()
        assert ctl.active
        clock[0] = 0.9
        ctl.note_ok()
        assert not ctl.active and cache.widen_mult == 1.0

    def test_widen_serves_stale_within_widened_bound(self):
        from flink_parameter_server_tpu_torch.hotcache.cache import HotRowCache

        cache = HotRowCache(2, jitter_frac=0.0, registry=False)
        cache.fill([7], np.ones((1, 2), np.float32))
        for _ in range(3):
            cache.tick()
        assert cache.lookup([7]) == {}
        assert cache.stats()["stale_rejects"] == 1
        cache.fill([7], np.ones((1, 2), np.float32))
        for _ in range(3):
            cache.tick()
        cache.set_widen(2.0)
        assert 7 in cache.lookup([7])
        st = cache.stats()
        assert st["max_served_age"] == 3 and st["widen_mult"] == 2.0 and st["effective_bound"] == 4
        cache.tick()
        cache.tick()
        assert cache.lookup([7]) == {}

    def test_attach_during_brownout_widens_immediately(self):
        from flink_parameter_server_tpu_torch.hotcache.cache import HotRowCache

        ctl = BrownoutController([], widen_factor=2.0, enter_sheds=1, registry=False)
        ctl.note_shed()
        assert ctl.active
        cache = HotRowCache(4, registry=False)
        ctl.attach(cache)
        assert cache.widen_mult == 2.0


# ---------------------------------------------------------------------------
# the client: retry budget + retries counter + breaker wiring
# ---------------------------------------------------------------------------


class _StubView:
    def __init__(self, part, addrs):
        self.epoch = 1
        self.partitioner = part
        self.addresses = addrs
        self.replicas = []


class _StubMembership:
    def __init__(self, part, addrs):
        self._view = _StubView(part, addrs)

    def current(self):
        return self._view


class TestClientBudget:
    @staticmethod
    def _client(reg, budget):
        from flink_parameter_server_tpu_torch.cluster.client import ClusterClient
        from flink_parameter_server_tpu_torch.cluster.partition import ConsistentHashPartitioner

        part = ConsistentHashPartitioner(16, 1)
        client = ClusterClient(value_shape=(2,), membership=_StubMembership(part, [("127.0.0.1", 1)]),
                               registry=reg, worker="budget-test", retry_budget=budget)
        client.retry_sleep_s, client.retry_sleep_cap_s = 1e-4, 1e-3
        return client

    def test_storm_retries_spend_budget_and_fail_fast(self):
        reg = MetricsRegistry()
        budget = RetryBudget(2.0, registry=False)
        client = self._client(reg, budget)
        assert client.retry_budget is budget
        deadline = time.monotonic() + 60
        client._await_retry(deadline, 1, "pull", reason="conn")
        client._await_retry(deadline, 2, "pull", reason="conn")
        with pytest.raises(RetryBudgetExhausted):
            client._await_retry(deadline, 3, "pull", reason="conn")
        retries = [i for i in reg.instruments() if i.name == "client_retries_total"]
        assert retries
        labels = {(i.labels["verb"], i.labels["reason"]): i.value for i in retries}
        assert labels[("pull", "conn")] == 3.0

    def test_control_plane_retries_do_not_spend(self):
        budget = RetryBudget(1.0, registry=False)
        client = self._client(MetricsRegistry(), budget)
        budget.try_spend()  # dry
        deadline = time.monotonic() + 60
        client._await_retry(deadline, 1, "push", reason="stale-epoch")
        client._await_retry(deadline, 2, "push", reason="frozen")
        with pytest.raises(RetryBudgetExhausted):
            client._await_retry(deadline, 3, "push", reason="conn")

    def test_breaker_open_short_circuits_before_the_wire(self):
        from flink_parameter_server_tpu_torch.cluster.client import _Rejected

        board = BreakerBoard(min_failures=1, failure_rate=0.1, cooldown_s=60.0, registry=False)
        client = self._client(MetricsRegistry(), None)
        client.breakers = board
        board.fail(0)
        assert board.state(0) == "open"
        with pytest.raises(_Rejected) as e:
            client._request_frames(0, np.arange(2), lambda conn: ["pull 0,1 b64"], hedgeable=False)
        assert e.value.reason == "breaker_open"
        assert client._conns == {}


# ---------------------------------------------------------------------------
# the serving admission edge: reject reasons, shed, deadline
# ---------------------------------------------------------------------------


class TestServingAdmission:
    @staticmethod
    def _service(reg, **kw):
        from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
        from flink_parameter_server_tpu_torch.serving.batcher import RequestBatcher
        from flink_parameter_server_tpu_torch.serving.engine import QueryEngine
        from flink_parameter_server_tpu_torch.serving.server import ServingService
        from flink_parameter_server_tpu_torch.serving.snapshot import SnapshotManager
        from flink_parameter_server_tpu_torch.utils.initializers import normal_factor

        store = ShardedParamStore.create(16, (2,), init_fn=normal_factor(0, (2,)), device=CPU)
        mgr = SnapshotManager(store.spec)
        mgr.publish(store.table, step=0)
        batcher = RequestBatcher(max_batch=4, max_queue=kw.pop("max_queue", 4),
                                 deadline_ms=kw.pop("deadline_ms", None))
        return ServingService(QueryEngine(mgr), batcher=batcher, registry=reg, **kw)

    @staticmethod
    def _reason_counts(reg):
        return {i.labels.get("reason"): i.value for i in reg.instruments()
                if i.name == "serving_rejected_total" and "reason" in i.labels}

    def test_queue_full_reason(self):
        from flink_parameter_server_tpu_torch.serving.batcher import QueueFull

        reg = MetricsRegistry()
        svc = self._service(reg, max_queue=2)
        svc.submit_lookup([1])
        svc.submit_lookup([2])
        with pytest.raises(QueueFull):
            svc.submit_lookup([3])
        counts = self._reason_counts(reg)
        assert counts["queue_full"] == 1.0
        assert counts["shed"] == 0.0 and counts["deadline"] == 0.0
        svc.batcher.close()

    def test_shed_reason_below_hard_line(self):
        from flink_parameter_server_tpu_torch.serving.batcher import QueueFull

        reg = MetricsRegistry()
        svc = self._service(reg, max_queue=4, shedder=LoadShedder(shed_at=0.25, normal_at=0.5, registry=False))
        svc.submit_lookup([1])
        with pytest.raises(QueueFull):
            svc.submit_lookup([2])
        assert self._reason_counts(reg)["shed"] == 1.0
        assert svc.metrics.total_rejected == 1
        svc.batcher.close()

    def test_deadline_reason_and_wire_answer(self):
        from flink_parameter_server_tpu_torch.serving.batcher import DeadlineExceeded
        from flink_parameter_server_tpu_torch.serving.server import format_response

        reg = MetricsRegistry()
        svc = self._service(reg, deadline_ms=10.0)
        fut = svc.submit_lookup([1])
        time.sleep(0.05)
        svc.start()
        with pytest.raises(DeadlineExceeded):
            fut.result(5.0)
        assert self._reason_counts(reg)["deadline"] == 1.0
        assert format_response(svc.submit_lookup([1]).result(5.0)).startswith("ok ")
        svc.stop()

    def test_tcp_maps_deadline_to_err(self):
        from flink_parameter_server_tpu_torch.serving.server import ServingServer

        reg = MetricsRegistry()
        svc = self._service(reg, deadline_ms=1.0)
        srv = ServingServer(svc, request_timeout=5.0)
        fut = svc.submit_lookup([1])
        time.sleep(0.01)
        svc.start()
        with pytest.raises(Exception):
            fut.result(5.0)
        line = srv.respond("pull 1")
        assert line in ("err deadline",) or line.startswith("ok "), line
        svc.stop()


# ---------------------------------------------------------------------------
# elastic-controller flapping regression
# ---------------------------------------------------------------------------


class _Report:
    rows_moved = 0


class _StubDriver:
    """Just enough driver for the controller: a mutable shard count,
    recorded resize calls, everything alive."""

    class _Part:
        def __init__(self):
            self.num_shards = 2

    def __init__(self):
        self.partitioner = self._Part()
        self.actions = []

    def shard_alive(self, s):
        return True

    def scale_out(self, add=1):
        self.partitioner.num_shards += add
        self.actions.append(("out", time.monotonic()))
        return _Report()

    def scale_in(self, remove=1):
        self.partitioner.num_shards -= remove
        self.actions.append(("in", time.monotonic()))
        return _Report()


class TestControllerFlapping:
    def test_cooldown_and_hysteresis_bound_thrash(self):
        from flink_parameter_server_tpu_torch.elastic.controller import ElasticController, ScalePolicy

        policy = ScalePolicy(min_shards=1, max_shards=4, min_window_frames=5, cooldown_s=0.15,
                             scale_in_consecutive=2)
        reg = MetricsRegistry()
        h = reg.histogram("cluster_pull_rtt_seconds", component="cluster")
        driver = _StubDriver()
        ctl = ElasticController(driver, policy=policy, registry=reg)
        for i in range(40):
            v = 0.2 if i % 2 == 0 else 0.0001
            for _ in range(60):
                h.observe(v)
            ctl.step()
            time.sleep(0.01)
        assert len(driver.actions) <= 4, driver.actions
        for (kind_a, t_a), (kind_b, t_b) in zip(driver.actions, driver.actions[1:]):
            if kind_a == "out" and kind_b == "in":
                assert t_b - t_a >= policy.cooldown_s

    def test_single_idle_window_does_not_scale_in(self):
        from flink_parameter_server_tpu_torch.elastic.controller import ElasticController, ScalePolicy

        reg = MetricsRegistry()
        h = reg.histogram("cluster_pull_rtt_seconds", component="cluster")
        ctl = ElasticController(_StubDriver(), policy=ScalePolicy(
            min_shards=1, max_shards=4, min_window_frames=5, cooldown_s=0.0, scale_in_consecutive=2),
            registry=reg)
        for _ in range(60):
            h.observe(0.0001)
        assert ctl.step() is None
        for _ in range(60):
            h.observe(0.0001)
        act = ctl.step()
        assert act and act["action"] == "scale_in"
        assert act["idle_streak"] == 2
        for _ in range(60):
            h.observe(0.0001)
        assert ctl.step() is None


# ---------------------------------------------------------------------------
# the end-to-end soak smoke (marker: soak)
# ---------------------------------------------------------------------------


@pytest.mark.soak
class TestSoakSmoke:
    def test_short_soak_with_fault_holds_invariants(self):
        from flink_parameter_server_tpu_torch.nemesis.scenarios import NemesisOp

        cfg = soak.SoakConfig(
            duration_s=2.5, offered_rps=80.0, generators=2, train_workers=1, num_users=64, num_items=256,
            dim=4, num_shards=2, link_delay_ms=0.2, slo_ms=200.0, overload_control=True, warmup_requests=16,
            nemesis=((0.8, NemesisOp(0, "partition", shard=0, mode="both", ms=250.0)),), seed=11,
        )
        rep = soak.run_soak(cfg, device=CPU)
        s = rep.summary
        assert s["arrivals"] == s["ok"] + s["late"] + s["shed"] + s["error"]
        assert s["latency_anchor"] == "arrival"
        assert s["ok"] > 0
        for v in rep.verdicts:
            assert v.ok, f"{v.name}: {v.detail}"
        assert rep.faults.get("partition_both", 0) >= 1
        assert json.loads(json.dumps(rep.as_dict()))["ok"] is True

    def test_overload_arm_sheds_instead_of_erroring(self):
        cfg = soak.SoakConfig(
            duration_s=2.0, offered_rps=400.0, generators=2, train_workers=1, num_users=32, num_items=128,
            dim=4, num_shards=1, link_delay_ms=0.5, slo_ms=60.0, overload_control=True, warmup_requests=16,
            seed=13,
        )
        rep = soak.run_soak(cfg, device=CPU)
        s = rep.summary
        assert s["shed"] > 0, "overload must surface as typed sheds"
        assert s["error"] == 0
        assert s["arrivals"] == s["ok"] + s["late"] + s["shed"] + s["error"]
        ledger = next(v for v in rep.verdicts if v.name == "exactly_once_ledger")
        assert ledger.ok, ledger.detail


def test_closed_loop_capacity_on_the_cpu():
    """The calibration in the port: overload control forced off, no
    nemesis, every request completed and counted."""
    cfg = soak.SoakConfig(generators=2, num_users=64, num_items=256, dim=4, num_shards=1, link_delay_ms=0.0,
                          warmup_requests=8)
    cap = soak.closed_loop_capacity(cfg, requests_per_generator=20, device=CPU)
    assert cap["requests"] == 40 and cap["capacity_rps"] > 0
    assert 0 < cap["closed_p50_ms"] <= cap["closed_p99_ms"]
