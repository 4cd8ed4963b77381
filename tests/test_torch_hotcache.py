"""The port's hot-key lease cache (``hotcache/``) against the JAX package's.

Mirrors all 35 tests of tests/test_hotcache.py against the port's shard,
client and driver on the CPU (``device="cpu"``): the trailing-token idioms,
the shard's lease board, the client-edge cache, the wire protocol (``lease``
is an atomic read + grant, ``inv=`` piggybacks only to declared sessions,
the old-server downgrade), the consistency carve-out (BSP bypasses the
cache bitwise, SSP serves within the bound), the sketches' windowed decay,
the lease-staleness checker, the cached serving tier with its run-report
section, and ``psctl hot`` (the stdlib ``tools/psctl``, unchanged) against a
live 2-shard cluster.

Parity with the reference, on the same seeded numpy inputs:
  * the same op sequence on both ``LeaseBoard``s and both ``HotRowCache``s
    gives equal invalidation batches and equal ``stats()``;
  * a 2-shard, 1-worker SSP (bound 2) MF cluster with ``hot_cache=True`` in
    both packages, each client's lease policy set to the same static hot
    set (the drivers' sketch-driven policies refresh on a timer, so which
    keys are hot at a given round is not repeatable): equal hit, miss,
    fill, revocation and lease counts, and tables at rtol 1e-5, atol 1e-6
    (the port's MF parity tolerance);
  * ``CachedLookupService.top_k`` gives the reference's ids, scores at rtol
    1e-6 (both score in float32 products; the port sums them in float64).
The device rule: ``CachedLookupService()`` ranks on the card, so without one
it raises.  A stress test holds the lease's atomicity: readers leasing and
writers pushing one shard at once, each lease's rows are exactly the rows
as of its answered ``seq``.
"""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.cluster import ClusterConfig as RefConfig
from flink_parameter_server_tpu.cluster import ClusterDriver as RefDriver
from flink_parameter_server_tpu.cluster import ParamShard as RefShard
from flink_parameter_server_tpu.cluster import RangePartitioner as RefRange
from flink_parameter_server_tpu.cluster import ShardServer as RefServer
from flink_parameter_server_tpu.hotcache import cache as ref_cache
from flink_parameter_server_tpu.hotcache import leases as ref_leases
from flink_parameter_server_tpu.hotcache import serving as ref_serving
from flink_parameter_server_tpu.hotcache.policy import StaticHotSet as RefStaticHotSet
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch.cluster import (
    ClusterConfig,
    ClusterDriver,
    RangePartitioner,
)
from flink_parameter_server_tpu_torch.cluster.client import ClusterClient
from flink_parameter_server_tpu_torch.cluster.shard import ParamShard, ShardServer, parse_rows
from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
from flink_parameter_server_tpu_torch.data.streams import microbatches
from flink_parameter_server_tpu_torch.hotcache import (
    CachedLookupService,
    HotRowCache,
    LeaseBoard,
    LeasePolicy,
    StaticHotSet,
    cache_snapshots,
    parse_inv_token,
    register_cache,
    split_response_options,
    unregister_cache,
)
from flink_parameter_server_tpu_torch.models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
)
from flink_parameter_server_tpu_torch.nemesis.invariants import check_lease_staleness
from flink_parameter_server_tpu_torch.telemetry import hotkeys
from flink_parameter_server_tpu_torch.telemetry.hotkeys import (
    CountMinSketch,
    HotKeySketch,
    SpaceSavingTopK,
)
from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

torch.set_num_threads(2)

pytestmark = pytest.mark.hotcache

CPU = "cpu"
MF_TOL = dict(rtol=1e-5, atol=1e-6)  # the port's MF parity tolerance


@pytest.fixture()
def aggregator():
    """A CPU aggregator as the process default (the default one ranks on
    the card)."""
    agg = hotkeys.HotKeyAggregator(device=CPU)
    old = hotkeys.get_aggregator()
    hotkeys.set_aggregator(agg)
    yield agg
    hotkeys.set_aggregator(old)


# ---------------------------------------------------------------------------
# workload helpers (the repo's standard seeded MF stream)
# ---------------------------------------------------------------------------


def _mf_workload(rounds=6, batch=96, num_users=48, num_items=64, dim=4):
    cols = synthetic_ratings(num_users, num_items, rounds * batch, seed=3)
    return list(microbatches(cols, batch)), ranged_random_factor(7, (dim,))


def _mf_logic(num_users=48, dim=4):
    return OnlineMatrixFactorization(num_users, dim, updater=SGDUpdater(0.05), seed=1, device=CPU)


def _mini_cluster(value_shape=(2,), capacity=32, shards=2):
    part = RangePartitioner(capacity, shards)
    shard_objs, servers = [], []
    for s in range(shards):
        sh = ParamShard(s, part, value_shape, registry=False, device=CPU)
        sv = ShardServer(sh, port=0).start()
        shard_objs.append(sh)
        servers.append(sv)
    addrs = [(sv.host, sv.port) for sv in servers]
    return part, shard_objs, servers, addrs


def _teardown(servers, shards):
    for sv in servers:
        sv.stop()
    for sh in shards:
        sh.close()


# ---------------------------------------------------------------------------
# trailing-token idioms
# ---------------------------------------------------------------------------


class TestResponseOptions:
    def test_strips_only_known_keys(self):
        body, opts = split_response_options("ok n=2 b64:AAAA== inv=3,4")
        assert body == "ok n=2 b64:AAAA=="  # b64 '=' padding untouched
        assert opts == {"inv": "3,4"}

    def test_ok_fields_never_consumed(self):
        body, opts = split_response_options("ok applied=2 seq=5")
        assert body == "ok applied=2 seq=5" and opts == {}

    def test_text_payload_untouched(self):
        body, opts = split_response_options("ok n=1 1.0,2.0;3.0,4.0")
        assert body.endswith("1.0,2.0;3.0,4.0") and opts == {}

    def test_drop_all_marker(self):
        assert parse_inv_token("*") is None
        assert parse_inv_token("3,5").tolist() == [3, 5]


# ---------------------------------------------------------------------------
# LeaseBoard (shard side)
# ---------------------------------------------------------------------------


class TestLeaseBoard:
    def test_grant_note_write_take(self):
        b = LeaseBoard(registry=False)
        b.grant("A", [1, 2, 3])
        b.grant("B", [2])
        # B writes key 2: A gets an inv queued, B (the writer) does not
        assert b.note_write([2], writer="B") == 1
        assert b.take_invalidations("A") == "2"
        assert b.take_invalidations("A") is None  # drained
        assert b.take_invalidations("B") is None
        # A's grant on 2 was dropped with the queue entry
        assert not b.holds("A", 2) and b.holds("A", 1)

    def test_revoke_releases_without_inv(self):
        b = LeaseBoard(registry=False)
        b.grant("A", [1, 2])
        assert b.revoke("A", [1]) == 1
        assert b.revoke("A") == 1  # the rest
        assert b.take_invalidations("A") is None

    def test_drop_all_marks_every_session(self):
        b = LeaseBoard(registry=False)
        b.grant("A", [1])
        b.grant("B", [2])
        b.drop_all()
        assert b.take_invalidations("A") == "*"
        assert b.take_invalidations("B") == "*"
        assert b.active_leases() == 0

    def test_session_cap_evicts_lru(self):
        b = LeaseBoard(registry=False, max_sessions=2)
        b.grant("A", [1])
        b.grant("B", [2])
        b.grant("C", [3])  # evicts A (least recently contacted)
        assert b.sessions() == 2
        assert not b.holds("A", 1)
        assert b.sessions_evicted == 1

    def test_inv_batch_cap_spills_to_next_response(self):
        b = LeaseBoard(registry=False, inv_batch=2)
        b.grant("A", [1, 2, 3])
        b.note_write([1, 2, 3])
        first = b.take_invalidations("A")
        assert first == "1,2"
        assert b.take_invalidations("A") == "3"


# ---------------------------------------------------------------------------
# HotRowCache (client side)
# ---------------------------------------------------------------------------


class TestHotRowCache:
    def test_bound_enforced_at_lookup(self):
        c = HotRowCache(2, registry=False, jitter_frac=0.0)
        c.fill([7], np.array([[1.0, 1.0]]))
        c.tick()
        c.tick()
        assert 7 in c.lookup([7])  # age 2 == bound: servable
        c.tick()
        assert 7 not in c.lookup([7])  # age 3 > bound: falls through
        st = c.stats()
        assert st["stale_rejects"] == 1
        assert st["max_served_age"] <= 2

    def test_bsp_bound_zero_rejected(self):
        with pytest.raises(ValueError, match="bound=0"):
            HotRowCache(0, registry=False)

    def test_invalidate_and_drop_all(self):
        c = HotRowCache(8, registry=False)
        c.fill([1, 2, 3], np.ones((3, 2), np.float32))
        assert c.invalidate([2]) == 1
        assert 2 not in c.lookup([2])
        assert c.invalidate(None) == 2  # inv=* drop-everything
        assert len(c) == 0
        assert c.stats()["revocations"] == 3

    def test_capacity_evicts_oldest_fill(self):
        c = HotRowCache(8, capacity=2, registry=False)
        c.fill([1], np.ones((1, 2), np.float32))
        c.tick()
        c.fill([2], np.ones((1, 2), np.float32))
        c.tick()
        c.fill([3], np.ones((1, 2), np.float32))  # evicts 1
        assert 1 not in c.lookup([1]) and 3 in c.lookup([3])
        assert c.stats()["evictions"] == 1

    def test_ttl_jitter_only_shortens(self):
        c = HotRowCache(16, registry=False, jitter_frac=0.5)
        ids = np.arange(32, dtype=np.int64)
        c.fill(ids, np.ones((32, 2), np.float32))
        bounds = {e.bound for e in c._entries.values()}
        assert all(8 <= b <= 16 for b in bounds)
        assert len(bounds) > 1  # actually spread, not constant

    def test_registry_exposes_snapshots(self):
        c = HotRowCache(4, registry=False)
        register_cache("t-snap", c)
        try:
            c.fill([5], np.ones((1, 2), np.float32))
            c.lookup([5])
            snaps = cache_snapshots()
            assert "t-snap" in snaps
            assert snaps["t-snap"]["keys"][0]["key"] == 5
        finally:
            unregister_cache("t-snap")


# ---------------------------------------------------------------------------
# the wire protocol (in-process dispatch, no sockets needed)
# ---------------------------------------------------------------------------


def _bare_server(shard):
    from flink_parameter_server_tpu_torch.telemetry.profiler import resolve_profiler

    srv = ShardServer.__new__(ShardServer)
    srv.shard = shard
    srv.profiler = resolve_profiler(None)
    srv.tracer = None
    return srv


def _shard16():
    return ParamShard(0, RangePartitioner(16, 1), (2,), registry=False, device=CPU)


class TestWireProtocol:
    def test_lease_is_atomic_read_plus_grant(self):
        shard = _shard16()
        srv = _bare_server(shard)
        srv._execute("push 1,2 1.0,2.0;3.0,4.0")
        resp = srv._execute("lease 1,2 b64 sess=A ttl=8")
        assert resp.startswith("ok n=2 seq=1 ttl=8 b64:")
        assert shard.leases.holds("A", 1) and shard.leases.holds("A", 2)
        # leased rows == pulled rows, bitwise
        leased = parse_rows(resp.split(" ", 4)[4], (2,))
        pulled = parse_rows(srv._execute("pull 1,2 b64").split(" ", 2)[2], (2,))
        assert np.array_equal(leased, pulled)

    def test_inv_piggybacks_only_to_declared_sessions(self):
        shard = _shard16()
        srv = _bare_server(shard)
        srv._execute("push 1 1.0,1.0")
        srv._execute("lease 1 b64 sess=A")
        # writer B pushes the leased key
        srv._execute("push 1 2.0,2.0 sess=B")
        # a session-less pull never sees inv tokens
        assert "inv=" not in srv._execute("pull 1 b64")
        # A's next contact carries it, exactly once
        r = srv._execute("pull 1 b64 sess=A")
        assert r.endswith("inv=1")
        assert "inv=" not in srv._execute("pull 1 b64 sess=A")

    def test_writer_session_not_self_invalidated(self):
        shard = _shard16()
        srv = _bare_server(shard)
        srv._execute("lease 1 b64 sess=A")
        srv._execute("push 1 1.0,1.0 sess=A")  # own write
        assert "inv=" not in srv._execute("pull 1 b64 sess=A")

    def test_revoke_and_unknown_tokens_ignored(self):
        shard = _shard16()
        srv = _bare_server(shard)
        srv._execute("lease 1,2 b64 sess=A")
        assert srv._execute("revoke 1 sess=A") == "ok revoked=1"
        assert srv._execute("revoke all sess=A") == "ok revoked=1"
        # the versioning contract: unknown trailing key=value tokens
        # parse-and-ignore (an old server facing a new client)
        assert srv._execute("push 3 1.0,1.0 zz=42").startswith("ok")

    def test_lease_requires_session(self):
        shard = _shard16()
        srv = _bare_server(shard)
        assert srv._respond_supervised("lease 1 b64").startswith("err bad-request")

    def test_epoch_flip_queues_drop_all(self):
        shard = _shard16()
        srv = _bare_server(shard)
        srv._execute("lease 1 b64 sess=A")
        shard.install_epoch(1, RangePartitioner(16, 1))
        r = srv._execute("pull 1 b64 sess=A")
        assert r.endswith("inv=*")


# ---------------------------------------------------------------------------
# client integration over real TCP
# ---------------------------------------------------------------------------


class TestClientIntegration:
    # "auto" negotiates the binary framing (leases and inv= as TLVs),
    # "line" keeps the text protocol (trailing tokens)
    @pytest.mark.parametrize("wire_proto", ["auto", "line"])
    def test_lease_hit_invalidate_cycle(self, wire_proto):
        part, shards, servers, addrs = _mini_cluster()
        cache = HotRowCache(4, registry=False)
        a = ClusterClient(addrs, part, (2,), registry=False, wire_proto=wire_proto,
                          hotcache=cache, lease_policy=StaticHotSet([0, 1, 17]))
        b = ClusterClient(addrs, part, (2,), registry=False, wire_proto=wire_proto)
        try:
            ids = np.array([0, 1, 5, 17])
            v1 = a.pull_batch(ids)  # misses; hot ids leased
            assert a.leases_acquired == 3
            a.pull_batch(ids)
            assert cache.stats()["hits"] == 3  # hot ids served locally
            # invalidate-on-push lands within ONE round: B pushes a
            # leased key; A's next round (which still touches the
            # shard for cold id 5) carries the inv and drops it, and
            # the round after serves the fresh value
            b.push_batch(np.array([1]), np.array([[9.0, 9.0]]))
            a.pull_batch(ids)
            assert cache.stats()["revocations"] >= 1
            v3 = a.pull_batch(ids)
            assert np.allclose(v3[1], v1[1] + [9.0, 9.0])
        finally:
            a.close()
            b.close()
            _teardown(servers, shards)

    def test_close_revokes_session(self):
        part, shards, servers, addrs = _mini_cluster()
        cache = HotRowCache(4, registry=False)
        c = ClusterClient(addrs, part, (2,), registry=False,
                          hotcache=cache, lease_policy=StaticHotSet([0, 17]))
        try:
            c.pull_batch(np.array([0, 17]))
            assert sum(sh.leases.active_leases() for sh in shards) == 2
            c.close()
            assert sum(sh.leases.active_leases() for sh in shards) == 0
        finally:
            _teardown(servers, shards)

    def test_own_push_invalidates_locally(self):
        part, shards, servers, addrs = _mini_cluster()
        cache = HotRowCache(8, registry=False)
        c = ClusterClient(addrs, part, (2,), registry=False,
                          hotcache=cache, lease_policy=StaticHotSet([3]))
        try:
            c.pull_batch(np.array([3]))
            assert len(cache) == 1
            c.push_batch(np.array([3]), np.array([[1.0, 1.0]]))
            assert len(cache) == 0  # write-through invalidate
            v = c.pull_batch(np.array([3]))
            assert np.allclose(v[0], [1.0, 1.0])
        finally:
            c.close()
            _teardown(servers, shards)


# ---------------------------------------------------------------------------
# the consistency carve-out
# ---------------------------------------------------------------------------


class TestConsistencyCarveOut:
    def test_bsp_bypasses_cache_bitwise_parity(self):
        """BSP + hot_cache=True: the driver must NOT attach caches
        (bound-0 reads must see every previous-round write) and a
        1-worker run — deterministic push order — lands bitwise equal
        to the cache-off run."""
        batches, init = _mf_workload()

        def run(hot_cache):
            d = ClusterDriver(
                _mf_logic(), capacity=64, value_shape=(4,), init_fn=init,
                config=ClusterConfig(num_shards=2, num_workers=1, partition="hash",
                                     staleness_bound=0, hot_cache=hot_cache),
                registry=False, device=CPU,
            )
            with d:
                values = d.run(batches).values
                caches = [c.hotcache for c in d._clients]
            return values, caches

        v_off, _ = run(False)
        v_on, caches = run(True)
        assert all(c is None for c in caches), "BSP client got a cache"
        assert np.array_equal(v_off, v_on)

    def test_ssp_workers_get_cache(self):
        batches, init = _mf_workload()
        d = ClusterDriver(
            _mf_logic(), capacity=64, value_shape=(4,), init_fn=init,
            config=ClusterConfig(num_shards=2, num_workers=2, partition="hash",
                                 staleness_bound=2, hot_cache=True),
            registry=False, device=CPU,
        )
        with d:
            assert all(c.hotcache is not None for c in d._clients)
            assert all(c.hotcache.bound == 2 for c in d._clients)  # bound defaults to the SSP bound
            result = d.run(batches)
            # the final dump is the table of record: it must be shard
            # truth, never a cached row (final_values clears first)
            truth = np.concatenate([sh.values() for sh in d.shards])[
                np.argsort(np.concatenate([sh.owned for sh in d.shards]))
            ]
            assert np.array_equal(result.values, truth)

    def test_ssp_bound_enforced_at_cache(self):
        """A cached entry is never served past the bound: reads past
        it fall through to the shard and observe the shard's CURRENT
        row even when no invalidation ever arrived (the
        lost-invalidation safety net)."""
        part, shards, servers, addrs = _mini_cluster(shards=1)
        cache = HotRowCache(2, registry=False, jitter_frac=0.0)
        reader = ClusterClient(addrs, part, (2,), registry=False,
                               hotcache=cache, lease_policy=StaticHotSet([4]))
        try:
            reader.pull_batch(np.array([4]))  # lease at tick 1
            # out-of-band write, simulating an invalidation the reader
            # never receives (it will not contact the shard again
            # until the bound expires)
            shards[0].push(np.array([4]), np.array([[5.0, 5.0]]))
            vals = [reader.pull_batch(np.array([4]))[0] for _ in range(4)]
            # within the bound: the stale copy may legally be served
            assert np.allclose(vals[0], 0.0)
            # past the bound: fell through, fresh row observed
            assert np.allclose(vals[-1], [5.0, 5.0])
            assert cache.stats()["max_served_age"] <= 2
            assert cache.stats()["stale_rejects"] >= 1
        finally:
            reader.close()
            _teardown(servers, shards)

    def test_old_server_downgrade(self):
        """Protocol versioning: against a server whose dispatch has no
        lease verb, the client downgrades to plain pulls permanently
        after one err bad-request — reads keep working, nothing
        cached."""
        part, shards, servers, addrs = _mini_cluster(shards=1)
        orig = ShardServer._execute

        def no_lease(self, line):
            # a pre-hotcache server predates the binary handshake too:
            # hello errs (the client stays on the line protocol, where
            # the lease downgrade below is then exercised)
            if line.split()[0].lower() in ("lease", "revoke", "hello"):
                return "err bad-request: unknown command"
            return orig(self, line)

        ShardServer._execute = no_lease
        try:
            cache = HotRowCache(4, registry=False)
            c = ClusterClient(addrs, part, (2,), registry=False,
                              hotcache=cache, lease_policy=StaticHotSet([1]))
            v = c.pull_batch(np.array([1, 2]))
            assert v.shape == (2, 2)
            assert not c._lease_supported
            assert len(cache) == 0
            c.pull_batch(np.array([1, 2]))  # stays on the plain path
            c.close()
        finally:
            ShardServer._execute = orig
            _teardown(servers, shards)


# ---------------------------------------------------------------------------
# sketch decay (the fossilized-top-K fix)
# ---------------------------------------------------------------------------


class TestSketchDecay:
    def test_popularity_shift_tracked_with_decay(self):
        """Without decay a long stream's top-K fossilizes on
        early-epoch keys; with windowed halving the NEW regime
        overtakes within ~a window."""
        rng = np.random.default_rng(0)
        old_keys = np.arange(10)
        new_keys = np.arange(100, 110)

        def shifted_stream(sketch):
            for _ in range(100):  # phase A: old keys hot, long
                sketch.observe(rng.choice(old_keys, 256))
            for _ in range(30):  # phase B: popularity shifts
                sketch.observe(rng.choice(new_keys, 256))

        fossil = HotKeySketch(64, buffer_ids=1)
        shifted_stream(fossil)
        fossil_top = {d["key"] for d in fossil.top_k(10)}
        assert fossil_top == set(old_keys)  # fossilized

        fresh = HotKeySketch(64, buffer_ids=1, decay_window=4_000)
        shifted_stream(fresh)
        fresh_top = {d["key"] for d in fresh.top_k(10)}
        assert fresh_top == set(new_keys)  # tracks the shift
        assert fresh.decays > 0

    def test_halve_preserves_ordering_and_drops_zeros(self):
        ss = SpaceSavingTopK(8)
        ss.update([1] * 10 + [2] * 4 + [3])
        ss.halve()
        counts = dict((k, c) for k, c, _ in ss.items())
        assert counts[1] == 5 and counts[2] == 2
        assert 3 not in counts  # 1 >> 1 == 0: dropped
        cms = CountMinSketch(width=64, depth=2)
        cms.add([1] * 10)
        cms.halve()
        assert cms.estimate([1])[0] == 5
        assert cms.total == 5

    def test_policy_follows_decayed_sketch(self):
        sketch = HotKeySketch(16, buffer_ids=1, decay_window=2_000)
        rng = np.random.default_rng(1)
        policy = LeasePolicy(sketch, top_n=10, min_count=4, async_refresh=False)
        for _ in range(20):
            sketch.observe(rng.choice(np.arange(10), 256))
        assert set(policy.refresh().tolist()) == set(range(10))
        for _ in range(20):
            sketch.observe(rng.choice(np.arange(50, 60), 256))
        hot = set(policy.refresh().tolist())
        assert hot & set(range(50, 60))
        assert policy.is_hot(np.array([55]))[0]


# ---------------------------------------------------------------------------
# invariant checker
# ---------------------------------------------------------------------------


class TestLeaseStalenessChecker:
    def test_verdicts(self):
        ok = check_lease_staleness(
            {"hits": 10, "max_served_age": 3, "revocations": 2, "stale_rejects": 1}, bound=3,
        )
        assert ok.ok
        violated = check_lease_staleness({"hits": 10, "max_served_age": 4}, bound=3)
        assert not violated.ok and "BOUND VIOLATED" in violated.detail
        vacuous = check_lease_staleness({"hits": 0, "max_served_age": 0}, bound=3)
        assert not vacuous.ok and "vacuous" in vacuous.detail


# ---------------------------------------------------------------------------
# serving tier + observability surfaces
# ---------------------------------------------------------------------------


class TestCachedServing:
    def test_cached_lookup_and_topk_fanout(self):
        part, shards, servers, addrs = _mini_cluster(value_shape=(4,), capacity=32)
        svc = CachedLookupService(
            addresses=addrs, partitioner=part, value_shape=(4,),
            policy=StaticHotSet(np.arange(8)),
            bound=8, hedge_after_s=None, registry=False, device=CPU,
        )
        try:
            rng = np.random.default_rng(0)
            rows = rng.normal(size=(32, 4)).astype(np.float32)
            for s in shards:
                s.push(s.owned, rows[s.owned])
            r1 = svc.lookup(np.arange(8))
            assert r1.cache_misses == 8 and r1.cache_hits == 0
            r2 = svc.lookup(np.arange(8))
            assert r2.cache_hits == 8 and r2.cache_misses == 0
            assert np.allclose(r2.values, rows[:8])
            # cross-shard fan-out top-K == the numpy oracle
            q = rng.normal(size=4).astype(np.float32)
            cand = np.arange(32, dtype=np.int64)
            scores, ids = svc.top_k(q, cand, k=5)
            oracle = np.argsort(-(rows @ q))[:5]
            assert set(ids.tolist()) == set(oracle.tolist())
            assert np.allclose(np.sort(scores)[::-1], np.sort(rows @ q)[::-1][:5], rtol=1e-5)
        finally:
            svc.close()
            _teardown(servers, shards)

    def test_run_report_section(self, aggregator):
        from flink_parameter_server_tpu_torch.telemetry.report import (
            build_run_report,
            render_markdown,
        )

        cache = HotRowCache(4, registry=False)
        cache.fill([1], np.ones((1, 2), np.float32))
        cache.lookup([1, 2])
        register_cache("t-report", cache)
        try:
            report = build_run_report(MetricsRegistry())
            assert report["hotcache"]["hits"] == 1
            assert report["hotcache"]["misses"] == 1
            md = render_markdown(report)
            assert "Hot-key lease cache" in md and "t-report" in md
        finally:
            unregister_cache("t-report")


class TestPsctlHot:
    def test_live_table_against_2_shard_cluster(self, aggregator):
        """`psctl hot` end to end: live 2-shard cluster with sketches
        on, a registered client-edge cache, the TelemetryServer's hot
        path, and the CLI rendering."""
        from flink_parameter_server_tpu_torch.telemetry.exporter import TelemetryServer
        from tools import psctl

        reg = MetricsRegistry()
        batches, init = _mf_workload(rounds=4)
        d = ClusterDriver(
            _mf_logic(), capacity=64, value_shape=(4,), init_fn=init,
            config=ClusterConfig(num_shards=2, num_workers=1, partition="hash",
                                 staleness_bound=None, hot_keys=True),
            registry=reg, device=CPU,
        )
        tel = None
        cache = HotRowCache(8, registry=False)
        try:
            with d:
                d.run(batches)  # populate the sketches
                client = d._make_client(worker="psctl-hot")
                client.attach_hotcache(cache, StaticHotSet(np.arange(16)))
                client.pull_batch(np.arange(16, dtype=np.int64))
                client.pull_batch(np.arange(16, dtype=np.int64))
                register_cache("psctl-hot", cache)
                tel = TelemetryServer(reg, port=0).start()
                # the raw endpoint payload
                doc = json.loads(psctl.scrape(tel.host, tel.port, "hot"))["hot"]
                assert doc["top"], "sketches saw traffic"
                assert doc["caches"]["psctl-hot"]["hits"] == 16
                leased = [t for t in doc["top"] if t.get("leased")]
                assert leased, "top keys show lease state"
                # the CLI rendering
                buf = io.StringIO()
                with redirect_stdout(buf):
                    rc = psctl.main(["hot", "--metrics", f"{tel.host}:{tel.port}",
                                     "--iterations", "1", "--raw"])
                out = buf.getvalue()
                assert rc == 0
                assert "psctl hot" in out and "cache[psctl-hot]" in out
                assert "rank" in out
                client.close()
        finally:
            unregister_cache("psctl-hot")
            if tel is not None:
                tel.stop()


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def _board_script(board_cls):
    """One seeded op sequence on a LeaseBoard: grants, writes by other
    sessions and by a holder, a revoke, an epoch drop-all and a session
    eviction; returns every invalidation batch taken and the stats."""
    rng = np.random.default_rng(11)
    b = board_cls(registry=False, max_sessions=3, inv_batch=4)
    taken = []
    sessions = ["A", "B", "C", "D"]
    for step in range(60):
        sess = sessions[int(rng.integers(0, 4))]
        ids = rng.integers(0, 40, int(rng.integers(1, 9)))
        op = int(rng.integers(0, 5))
        if op <= 1:
            b.grant(sess, ids)
        elif op == 2:
            b.note_write(ids, writer=sess if rng.random() < 0.5 else None)
        elif op == 3:
            taken.append((step, sess, b.take_invalidations(sess)))
        else:
            b.revoke(sess, None if rng.random() < 0.3 else ids)
        if step == 40:
            b.drop_all()
    for sess in sessions:
        taken.append(("end", sess, b.take_invalidations(sess)))
    return taken, b.stats(), sorted(b.leased_ids().tolist())


def _cache_script(cache_cls):
    rng = np.random.default_rng(12)
    c = cache_cls(4, capacity=16, registry=False, jitter_frac=0.25)
    served = []
    for step in range(80):
        op = int(rng.integers(0, 4))
        ids = rng.integers(0, 48, int(rng.integers(1, 7)))
        if op == 0:
            c.fill(np.unique(ids), rng.normal(size=(len(np.unique(ids)), 3)).astype(np.float32))
        elif op == 1:
            got = c.lookup(ids)
            served.append({k: v.tolist() for k, v in sorted(got.items())})
        elif op == 2:
            c.invalidate(None if rng.random() < 0.1 else ids)
        else:
            c.tick()
    stats = c.stats()
    snap = c.snapshot(8)
    return served, stats, snap


class TestParity:
    def test_lease_board_matches_the_reference(self):
        assert _board_script(LeaseBoard) == _board_script(ref_leases.LeaseBoard)

    def test_hot_row_cache_matches_the_reference(self):
        assert _cache_script(HotRowCache) == _cache_script(ref_cache.HotRowCache)

    def test_ssp_cluster_with_hot_cache_matches_the_reference(self):
        batches, init = _mf_workload(rounds=8)
        items = np.concatenate([b["item"] for b in batches])
        hot = np.argsort(-np.bincount(items, minlength=64), kind="stable")[:16]
        cfg = dict(num_shards=2, num_workers=1, partition="range", staleness_bound=2, hot_cache=True)

        def counts(d):
            (client,) = d._clients
            st = client.hotcache.stats()
            return dict(
                hits=st["hits"], misses=st["misses"], fills=st["fills"],
                revocations=st["revocations"], stale_rejects=st["stale_rejects"],
                max_served_age=st["max_served_age"], leases=client.leases_acquired,
                granted=sum(s.leases.stats()["leases_granted"] for s in d.shards),
                queued=sum(s.leases.stats()["invalidations_queued"] for s in d.shards),
            )

        def read_hot(d):
            # a read of the hot set on the worker's own client before
            # each round: it leases, and the round's own pull then hits
            # until the round's push invalidates (one worker pushes
            # every item it pulls, so training alone never hits)
            return lambda w, t: d._clients[w].pull_batch(hot)

        port = ClusterDriver(_mf_logic(), capacity=64, value_shape=(4,), init_fn=init,
                             config=ClusterConfig(**cfg), registry=False, device=CPU)
        with port:
            (client,) = port._clients
            client.lease_policy = StaticHotSet(hot)
            got = port.run(batches, round_hook=read_hot(port)).values
            got_counts = counts(port)
        ref = RefDriver(
            ref_mf.OnlineMatrixFactorization(48, 4, updater=ref_mf.SGDUpdater(0.05), seed=1),
            capacity=64, value_shape=(4,), init_fn=ref_init(7, (4,)),
            config=RefConfig(**cfg), registry=False,
        )
        with ref:
            (client,) = ref._clients
            client.lease_policy = RefStaticHotSet(hot)
            want = ref.run(batches, round_hook=read_hot(ref)).values
            want_counts = counts(ref)
        assert got_counts["hits"] > 0 and got_counts["leases"] > 0
        assert got_counts == want_counts
        np.testing.assert_allclose(got, want, **MF_TOL)

    def test_cached_top_k_matches_the_reference(self):
        rng = np.random.default_rng(5)
        rows = rng.normal(size=(48, 8)).astype(np.float32)
        q = rng.normal(size=8).astype(np.float32)
        cand = rng.choice(48, 30, replace=False)

        part, shards, servers, addrs = _mini_cluster(value_shape=(8,), capacity=48, shards=3)
        rpart = RefRange(48, 3)
        rshards = [RefShard(s, rpart, (8,), registry=False) for s in range(3)]
        rservers = [RefServer(sh, port=0).start() for sh in rshards]
        svc = CachedLookupService(addresses=addrs, partitioner=part, value_shape=(8,),
                                  policy=StaticHotSet(np.arange(12)), hedge_after_s=None,
                                  registry=False, device=CPU)
        rsvc = ref_serving.CachedLookupService(
            addresses=[(sv.host, sv.port) for sv in rservers], partitioner=rpart, value_shape=(8,),
            policy=RefStaticHotSet(np.arange(12)), hedge_after_s=None, registry=False,
        )
        try:
            for s, rs in zip(shards, rshards):
                s.push(s.owned, rows[s.owned])
                rs.push(rs.owned, rows[rs.owned])
            for k in (1, 5, 30, 40):  # 40: more than the candidates, padded
                scores, ids = svc.top_k(q, cand, k=k)
                rscores, rids = rsvc.top_k(q, cand, k=k)
                assert np.array_equal(ids, rids), k
                np.testing.assert_allclose(scores, rscores, rtol=1e-6)
            assert np.array_equal(svc.top_k(q, [], k=3)[1], rsvc.top_k(q, [], k=3)[1])
        finally:
            svc.close()
            rsvc.close()
            _teardown(servers, shards)
            _teardown(rservers, rshards)

    def test_service_without_a_device_takes_the_card(self):
        part, shards, servers, addrs = _mini_cluster()
        try:
            if torch.cuda.is_available():
                svc = CachedLookupService(addresses=addrs, partitioner=part, value_shape=(2,),
                                          hedge_after_s=None, registry=False)
                assert svc.device.type == "cuda"
                svc.close()
            else:
                with pytest.raises(RuntimeError, match="cuda"):
                    CachedLookupService(addresses=addrs, partitioner=part, value_shape=(2,),
                                        hedge_after_s=None, registry=False)
        finally:
            _teardown(servers, shards)


class TestLeaseAtomicity:
    def test_leased_rows_are_the_rows_at_the_answered_seq_under_contention(self):
        """Readers leasing and writers pushing one shard at once, more
        threads than cores and a short switch interval: every lease's rows
        equal the rows as of its answered ``seq`` (each push adds 1.0 to
        every id, so the rows at ``seq`` are ``seq`` everywhere), and no
        reader or writer fails."""
        import sys
        import threading

        shard = ParamShard(0, RangePartitioner(256, 1), (4,), registry=False, device=CPU)
        ids = np.arange(0, 256, 3, dtype=np.int64)
        ones = np.ones((len(ids), 4), np.float32)
        errs, seqs = [], []
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)

        def writer(sess):
            try:
                for _ in range(150):
                    shard.push(ids, ones, sess=sess)
            except BaseException as e:  # noqa: BLE001 — asserted below
                errs.append(e)

        def reader(sess):
            try:
                for _ in range(150):
                    rows, seq, _ttl = shard.lease_rows(ids, sess)
                    if not np.array_equal(rows, np.full(rows.shape, float(seq), np.float32)):
                        errs.append(AssertionError(f"{sess}: rows at seq {seq} are {rows[0]}"))
                    seqs.append(seq)
            except BaseException as e:  # noqa: BLE001 — asserted below
                errs.append(e)

        threads = [threading.Thread(target=writer, args=(f"w{i}",)) for i in range(2)]
        threads += [threading.Thread(target=reader, args=(f"r{i}",)) for i in range(6)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs[:3]
        assert shard.stats()["push_seq"] == 300 and len(set(seqs)) > 1
        # the six readers hold sessions (a writer that never leases holds
        # none); the writers' pushes queued invalidations for them
        assert shard.leases.stats()["sessions"] == 6 and shard.leases.stats()["invalidations_queued"] > 0
        shard.close()
