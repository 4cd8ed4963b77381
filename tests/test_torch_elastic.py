"""The port's elastic control plane (``elastic/``) against the JAX package's.

Thread-backed shards over real TCP on the CPU (the port with
``device="cpu"``), so the epoch protocol, the migration wire verbs and the
hedging race run for real.  Tolerances:
  * ``plan_moves``: the move lists (source, destination, ids) identical to
    the reference's for growth and shrink;
  * migrated rows: bitwise at handoff (the migration verify), and the
    shard WAL ledger balances (``acked == applied``);
  * live resize / scale-in / replacement: the final MF table within rtol
    1e-4 / atol 1e-6 (the reference's cluster bar) of an uninterrupted
    static run, and the 1 -> 2 live resize within the same bar of the
    reference's ``ElasticClusterDriver`` resized the same way on the same
    stream.

Mirrors tests/test_elastic.py's TestMembership (4), TestPlanMoves (4),
TestEpochWire (5), TestMigration (4), TestHedging (3), TestLiveResize (4),
TestController (3) and ``test_lineserver_stop_joins_handler_threads``: 28
of its 31 tests.  The metric-line lint, run-report and bench-line tests
wait for ``tools/``, ``telemetry/report.py`` and the benchmark cells (ROADMAP
Queue 1).
"""
import threading
import time
import types

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.cluster import ConsistentHashPartitioner as RefHash
from flink_parameter_server_tpu.data.movielens import synthetic_ratings as ref_ratings
from flink_parameter_server_tpu.elastic import ElasticClusterConfig as RefElasticConfig
from flink_parameter_server_tpu.elastic import ElasticClusterDriver as RefElasticDriver
from flink_parameter_server_tpu.elastic import plan_moves as ref_plan_moves
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.telemetry.registry import MetricsRegistry as RefRegistry
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch.cluster import (
    ClusterConfig,
    ClusterDriver,
    ConsistentHashPartitioner,
    ParamShard,
    RangePartitioner,
    ShardServer,
)
from flink_parameter_server_tpu_torch.cluster.client import ClusterClient
from flink_parameter_server_tpu_torch.cluster.shard import format_rows, parse_rows
from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
from flink_parameter_server_tpu_torch.data.streams import microbatches
from flink_parameter_server_tpu_torch.elastic import (
    ElasticClusterConfig,
    ElasticClusterDriver,
    ElasticController,
    HedgeBudget,
    Hedger,
    MembershipService,
    ScalePolicy,
    execute_moves,
    plan_moves,
)
from flink_parameter_server_tpu_torch.loadgen.overload import RetryBudget, RetryBudgetExhausted
from flink_parameter_server_tpu_torch.models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
)
from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor
from flink_parameter_server_tpu_torch.utils.net import LineServer, request_lines

torch.set_num_threads(2)

pytestmark = pytest.mark.elastic

CPU = "cpu"
BAR = dict(rtol=1e-4, atol=1e-6)  # the reference's cluster parity bar


def _shard(shard_id, part, tmp_path=None, name="wal", **kw):
    return ParamShard(
        shard_id, part, (4,), init_fn=ranged_random_factor(3, (4,)),
        wal_dir=None if tmp_path is None else str(tmp_path / name),
        registry=False, device=CPU, **kw,
    )


def _init_rows(ids):
    return ranged_random_factor(3, (4,))(
        torch.as_tensor(np.asarray(ids), dtype=torch.int32)
    ).numpy()


# ---------------------------------------------------------------------------
# membership epochs
# ---------------------------------------------------------------------------


class TestMembership:
    def test_epochs_are_monotone_and_immutable(self):
        p1 = ConsistentHashPartitioner(64, 1)
        m = MembershipService(p1, [("h", 1)], registry=False)
        assert m.current().epoch == 0
        p2 = p1.grown(2)
        v = m.publish(p2, [("h", 1), ("h", 2)])
        assert v.epoch == 1
        assert m.current().partitioner is p2
        with pytest.raises(Exception):
            v.epoch = 5  # frozen dataclass

    def test_publish_validates_address_count(self):
        p1 = ConsistentHashPartitioner(64, 2)
        m = MembershipService(p1, [("h", 1), ("h", 2)], registry=False)
        with pytest.raises(ValueError):
            m.publish(p1.grown(3), [("h", 1), ("h", 2)])

    def test_subscribe_fires_and_unsubscribes(self):
        p1 = ConsistentHashPartitioner(64, 1)
        m = MembershipService(p1, [("h", 1)], registry=False)
        seen = []
        unsub = m.subscribe(lambda v: seen.append(v.epoch))
        m.publish(p1.grown(2), [("h", 1), ("h", 2)])
        unsub()
        m.publish(p1.grown(3), [("h", 1), ("h", 2), ("h", 3)])
        assert seen == [1]

    def test_registry_instruments(self):
        reg = MetricsRegistry()
        p1 = ConsistentHashPartitioner(64, 1)
        m = MembershipService(p1, [("h", 1)], registry=reg)
        m.publish(p1.grown(2), [("h", 1), ("h", 2)])
        snap = {i.name: i.value for i in reg.instruments()}
        assert snap["elastic_epoch"] == 1
        assert snap["elastic_epoch_flips_total"] == 1


# ---------------------------------------------------------------------------
# migration planning
# ---------------------------------------------------------------------------


def _same_moves(moves, ref_moves):
    assert [(m.src, m.dst) for m in moves] == [(m.src, m.dst) for m in ref_moves]
    for m, r in zip(moves, ref_moves):
        assert np.array_equal(m.ids, r.ids)


class TestPlanMoves:
    def test_growth_moves_only_to_new_shards(self):
        old = ConsistentHashPartitioner(512, 2, seed=3)
        new = old.grown(4)
        moves = plan_moves(old, new)
        assert moves  # growth takes a real share
        for mv in moves:
            assert mv.dst >= 2  # only ONTO new shards
            assert (old.shard_of(mv.ids) == mv.src).all()
            assert (new.shard_of(mv.ids) == mv.dst).all()
        ref_old = RefHash(512, 2, seed=3)
        _same_moves(moves, ref_plan_moves(ref_old, ref_old.grown(4)))

    def test_shrink_moves_only_off_retired_shards(self):
        old = ConsistentHashPartitioner(512, 4, seed=3)
        new = old.shrunk(2)
        moves = plan_moves(old, new)
        assert moves
        for mv in moves:
            assert mv.src >= 2  # only OFF the retired shards
            assert mv.dst < 2
        ref_old = RefHash(512, 4, seed=3)
        _same_moves(moves, ref_plan_moves(ref_old, ref_old.shrunk(2)))

    def test_moves_cover_exactly_the_ownership_diff(self):
        old = ConsistentHashPartitioner(1024, 3, seed=9)
        new = old.grown(5)
        moves = plan_moves(old, new)
        moved = (
            np.concatenate([mv.ids for mv in moves])
            if moves else np.empty(0, np.int64)
        )
        assert len(np.unique(moved)) == len(moved)  # no key twice
        ids = np.arange(1024)
        expect = ids[old.shard_of(ids) != new.shard_of(ids)]
        assert np.array_equal(np.sort(moved), expect)
        ref_old = RefHash(1024, 3, seed=9)
        _same_moves(moves, ref_plan_moves(ref_old, ref_old.grown(5)))

    def test_capacity_mismatch_rejected(self):
        with pytest.raises(ValueError):
            plan_moves(
                ConsistentHashPartitioner(64, 2),
                ConsistentHashPartitioner(128, 2),
            )


# ---------------------------------------------------------------------------
# the epoch-fenced wire protocol
# ---------------------------------------------------------------------------


class TestEpochWire:
    @pytest.fixture()
    def served(self, tmp_path):
        part = ConsistentHashPartitioner(64, 1, seed=5)
        shard = _shard(0, part, tmp_path)
        server = ShardServer(shard, supervised=False).start()
        yield part, shard, server
        server.stop()
        shard.close()

    def test_stale_epoch_write_rejected(self, served):
        part, shard, server = served
        (ok,) = request_lines(
            server.host, server.port,
            ["push 1 " + format_rows(np.ones((1, 4), np.float32)) + " e=0"],
        )
        assert ok.startswith("ok")
        new = part.grown(2)
        moving = np.arange(64)[new.shard_of(np.arange(64)) == 1]
        shard.freeze(moving)
        shard.install_epoch(1, new)
        kept = int(shard.owned[0])
        (r,) = request_lines(
            server.host, server.port,
            [f"push {kept} " + format_rows(np.ones((1, 4), np.float32)) + " e=0"],
        )
        assert r.startswith("err stale-epoch"), r
        assert "epoch=1" in r
        # current-epoch write goes through
        (r2,) = request_lines(
            server.host, server.port,
            [f"push {kept} " + format_rows(np.ones((1, 4), np.float32)) + " e=1"],
        )
        assert r2.startswith("ok"), r2

    def test_future_epoch_frame_accepted_when_routable(self, served):
        """Mid-flip, a client on the NEWER map may reach a shard that
        has not flipped yet; if the ids route here under both maps the
        write is correctly placed and must not bounce."""
        part, shard, server = served
        kept = int(shard.owned[0])
        (r,) = request_lines(
            server.host, server.port,
            [f"push {kept} " + format_rows(np.ones((1, 4), np.float32)) + " e=7"],
        )
        assert r.startswith("ok"), r

    def test_frozen_range_rejects_push_but_serves_pull(self, served):
        part, shard, server = served
        frozen_id = 5
        shard.freeze([frozen_id])
        r_push, r_pull, r_other = request_lines(
            server.host, server.port,
            [
                f"push {frozen_id} " + format_rows(np.ones((1, 4), np.float32)),
                f"pull {frozen_id} b64",
                "push 6 " + format_rows(np.ones((1, 4), np.float32)),
            ],
        )
        assert r_push == "err frozen"
        assert r_pull.startswith("ok")  # reads never block
        assert r_other.startswith("ok")  # non-moving keys never block
        shard.unfreeze()

    def test_xfer_load_roundtrip_bitwise(self, served):
        part, shard, server = served
        ids = shard.owned[:8]
        rng = np.random.default_rng(0)
        shard.push(ids, rng.normal(size=(8, 4)).astype(np.float32))
        (resp,) = request_lines(
            server.host, server.port,
            ["xfer " + ",".join(str(int(i)) for i in ids)],
        )
        assert resp.startswith("ok")
        _ok, _n, seq_tok, payload = resp.split(" ", 3)
        assert int(seq_tok.partition("=")[2]) == shard._push_seq
        rows = parse_rows(payload, (4,))
        assert np.array_equal(rows, shard.values()[:8])  # BITWISE
        # load assigns bitwise (no delta arithmetic)
        target = rng.normal(size=(8, 4)).astype(np.float32)
        (r2,) = request_lines(
            server.host, server.port,
            ["load " + ",".join(str(int(i)) for i in ids) + " "
             + format_rows(target, "b64")],
        )
        assert r2.startswith("ok loaded=8")
        assert np.array_equal(shard.values()[:8], target)

    def test_pid_dedupe_exactly_once(self, served):
        """A retried push frame (lost ack) is acked but applied once —
        including after a crash + WAL rebuild."""
        part, shard, server = served
        gid = int(shard.owned[0])
        line = (
            f"push {gid} " + format_rows(np.ones((1, 4), np.float32)) + " pid=w0.1 e=0"
        )
        (r1,) = request_lines(server.host, server.port, [line])
        after_first = shard.values().copy()
        (r2,) = request_lines(server.host, server.port, [line])  # retry
        assert r1.startswith("ok") and r2.startswith("ok")
        assert np.array_equal(shard.values(), after_first)
        assert shard.rows_applied == 1
        # the dedupe window survives a crash (pairs ride the WAL)
        shard.crash()
        shard.restart()
        (r3,) = request_lines(server.host, server.port, [line])
        assert r3.startswith("ok")
        assert np.array_equal(shard.values(), after_first)


# ---------------------------------------------------------------------------
# migration execution
# ---------------------------------------------------------------------------


class TestMigration:
    def _topology(self, tmp_path, *, wal=True):
        old = ConsistentHashPartitioner(256, 1, seed=2)
        new = old.grown(2)
        src = _shard(0, old, tmp_path if wal else None, "wal0")
        dst = _shard(1, new, tmp_path if wal else None, "wal1")
        servers = [
            ShardServer(src, supervised=False).start(),
            ShardServer(dst, supervised=False).start(),
        ]
        return old, new, src, dst, servers

    @staticmethod
    def _addrs(servers):
        return {i: (s.host, s.port) for i, s in enumerate(servers)}

    @staticmethod
    def _teardown(servers, *shards):
        for s in servers:
            s.stop()
        for sh in shards:
            sh.close()

    def test_migrated_rows_bitwise_equal_at_handoff(self, tmp_path):
        old, new, src, dst, servers = self._topology(tmp_path)
        try:
            rng = np.random.default_rng(1)
            ids = np.unique(rng.integers(0, 256, 64))
            src.push(ids, rng.normal(size=(len(ids), 4)).astype(np.float32))
            moves = plan_moves(old, new)
            pre = {mv.dst: src.snapshot_rows(mv.ids)[0] for mv in moves}
            report = execute_moves(
                moves, {0: src, 1: dst}, self._addrs(servers),
                (4,), verify=True, registry=False,
            )
            assert report.verified and report.mismatches == 0
            assert report.rows_moved == sum(len(m.ids) for m in moves)
            for mv in moves:
                got = dst.peek_rows(mv.ids)
                assert np.array_equal(got, pre[mv.dst])  # BITWISE
            assert 0 in report.freeze_started
        finally:
            self._teardown(servers, src, dst)

    def test_wal_tail_catches_up_writes_racing_the_snapshot(self, tmp_path):
        """A push landing between the bulk snapshot and the freeze is
        caught up from the WAL tail — and the caught-up rows are
        bitwise the source's."""
        old, new, src, dst, servers = self._topology(tmp_path)
        try:
            moves = plan_moves(old, new)
            racing_id = int(moves[0].ids[0])
            orig_freeze = src.freeze
            raced = []

            def freeze_with_race(ids):
                if not raced:  # one race, at the real freeze point
                    raced.append(True)
                    src.push(np.array([racing_id]), np.full((1, 4), 0.125, np.float32))
                orig_freeze(ids)

            src.freeze = freeze_with_race
            report = execute_moves(
                moves, {0: src, 1: dst}, self._addrs(servers),
                (4,), verify=True, registry=False,
            )
            assert raced
            assert report.tail_rows >= 1
            assert report.verified and report.mismatches == 0
            src_row, _ = src.snapshot_rows(np.array([racing_id]))
            dst_row = dst.peek_rows(np.array([racing_id]))
            assert np.array_equal(src_row, dst_row)  # BITWISE
            assert np.array_equal(dst_row, _init_rows([racing_id]) + np.float32(0.125))
        finally:
            self._teardown(servers, src, dst)

    def test_no_wal_falls_back_to_freeze_first(self, tmp_path):
        old, new, src, dst, servers = self._topology(tmp_path, wal=False)
        try:
            moves = plan_moves(old, new)
            report = execute_moves(
                moves, {0: src, 1: dst}, self._addrs(servers),
                (4,), verify=True, registry=False,
            )
            assert report.verified and report.tail_rows == 0
        finally:
            self._teardown(servers, src, dst)

    def test_install_epoch_snapshot_survives_fresh_process(self, tmp_path):
        """After a flip, a brand-new ParamShard over the same WAL dir
        rebuilds the post-flip slice bitwise (the snapshot barrier) —
        the dead-shard replacement path across a resharding."""
        part = ConsistentHashPartitioner(64, 1, seed=4)
        sh = _shard(0, part, tmp_path)
        sh.push(np.arange(10), np.ones((10, 4), np.float32), pid="a.0")
        p2 = part.grown(2)
        sh.install_epoch(1, p2)
        before = sh.values().copy()
        pairs = list(sh._applied_pairs)
        sh.close()
        reborn = _shard(0, p2, tmp_path)
        assert np.array_equal(reborn.values(), before)  # BITWISE
        assert list(reborn._applied_pairs) == pairs  # dedupe survives
        reborn.close()


# ---------------------------------------------------------------------------
# hedging
# ---------------------------------------------------------------------------


class _SlowOnceServer(ShardServer):
    """Delays exactly one pull frame (the straggler injection) —
    hooked on BOTH framings (clients negotiate binary by default)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.slow = threading.Event()
        self.delay_s = 0.5

    def _maybe_stall(self, verb: str) -> None:
        if verb == "pull" and self.slow.is_set():
            self.slow.clear()
            time.sleep(self.delay_s)

    def respond(self, line):
        self._maybe_stall(line.split(None, 1)[0].lower() if line else "")
        return super().respond(line)

    def respond_frame(self, data):
        from flink_parameter_server_tpu_torch.utils import frames as wire

        self._maybe_stall(wire.peek_verb_name(data))
        return super().respond_frame(data)


class TestHedging:
    @pytest.fixture()
    def slow_topology(self):
        part = RangePartitioner(64, 1)
        shard = _shard(0, part)
        server = _SlowOnceServer(shard, supervised=False).start()
        yield part, shard, server
        server.stop()

    def test_budget_caps_hedges(self):
        b = HedgeBudget(max_fraction=0.5, burst=1)
        b.note_requests(2)
        assert b.allow(1)  # 1 <= 2*0.5 + 1
        assert b.allow(1)  # 2 <= 2
        assert not b.allow(1)
        b.refund(1)
        assert b.allow(1)
        with pytest.raises(ValueError):
            HedgeBudget(max_fraction=1.5)

    def test_hedge_beats_straggler_and_never_double_applies(self, slow_topology):
        part, shard, server = slow_topology
        reg = MetricsRegistry()
        hedger = Hedger(0.05, budget=HedgeBudget(1.0, burst=16), registry=reg)
        mem = MembershipService(part, [(server.host, server.port)], registry=False)
        client = ClusterClient(
            value_shape=(4,), membership=mem, hedge=hedger, registry=False, chunk=64,
        )
        try:
            client.pull_batch(np.arange(4))  # warm the primary conn
            server.slow.set()
            t0 = time.perf_counter()
            vals = client.pull_batch(np.arange(8))
            wall = time.perf_counter() - t0
            assert wall < server.delay_s / 2, wall  # the hedge won
            assert hedger.hedges_won >= 1
            assert np.array_equal(vals, _init_rows(np.arange(8)))  # delivered ONCE, exact
            # pushes are never hedged; state advances exactly once
            before = client.pull_batch(np.array([3]))[0]
            client.push_batch(np.array([3]), np.ones((1, 4), np.float32))
            after = client.pull_batch(np.array([3]))[0]
            assert np.allclose(after - before, 1.0)
            assert shard.rows_applied == 1
            counters = {i.name: i.value for i in reg.instruments()}
            assert counters["elastic_hedged_pulls_total"] >= 1
            assert counters["elastic_hedges_won_total"] >= 1
        finally:
            client.close()

    def test_zero_budget_never_hedges(self, slow_topology):
        part, shard, server = slow_topology
        server.delay_s = 0.2
        hedger = Hedger(0.02, budget=HedgeBudget(0.0, burst=0), registry=False)
        mem = MembershipService(part, [(server.host, server.port)], registry=False)
        client = ClusterClient(
            value_shape=(4,), membership=mem, hedge=hedger, registry=False, chunk=64,
        )
        try:
            client.pull_batch(np.arange(4))
            server.slow.set()
            t0 = time.perf_counter()
            client.pull_batch(np.arange(4))
            assert time.perf_counter() - t0 >= server.delay_s * 0.9
            assert hedger.hedges_issued == 0
        finally:
            client.close()


# ---------------------------------------------------------------------------
# the acceptance anchors
# ---------------------------------------------------------------------------


def _mf_fixture(num_users=64, num_items=96, dim=8, batch=128, rounds=16):
    cols = synthetic_ratings(num_users, num_items, rounds * batch, seed=3)
    batches = list(microbatches(cols, batch))
    init = ranged_random_factor(7, (dim,))
    return batches, init, num_users, num_items, dim


def _logic(nu, dim):
    return OnlineMatrixFactorization(nu, dim, updater=SGDUpdater(0.05), seed=1, device=CPU)


def _static_table(batches, init, nu, ni, dim, *, num_shards, workers=2):
    driver = ClusterDriver(
        _logic(nu, dim), capacity=ni, value_shape=(dim,), init_fn=init,
        config=ClusterConfig(num_shards=num_shards, num_workers=workers, partition="hash"),
        registry=False, device=CPU,
    )
    with driver:
        return driver.run(batches, timeout=120).values


def _elastic(logic, ni, dim, init, tmp_path, reg, num_shards, **cfg):
    driver = ElasticClusterDriver(
        logic, capacity=ni, value_shape=(dim,), init_fn=init,
        config=ElasticClusterConfig(
            num_shards=num_shards, num_workers=2, wal_dir=str(tmp_path / "wal"), **cfg
        ),
        registry=reg, device=CPU,
    )
    driver.start()
    return driver


def _control_after(reg_counter, rounds, action, out, errors):
    def control():
        try:
            deadline = time.monotonic() + 60
            while reg_counter.value < rounds and time.monotonic() < deadline:
                time.sleep(0.002)
            out.append(action())
        except BaseException as e:  # pragma: no cover
            errors.append(e)

    t = threading.Thread(target=control, daemon=True)
    t.start()
    return t


def _ref_live_resize_table(nu, ni, dim, batch, rounds, tmp_path):
    """The reference's ElasticClusterDriver: 1 shard scaled out to 2
    after 8 worker rounds, on the same stream (the reference's own
    data and init, which the port equals bitwise)."""
    from flink_parameter_server_tpu.data.streams import microbatches as ref_micro

    batches = list(ref_micro(ref_ratings(nu, ni, rounds * batch, seed=3), batch))
    reg = RefRegistry()
    driver = RefElasticDriver(
        ref_mf.OnlineMatrixFactorization(nu, dim, updater=ref_mf.SGDUpdater(0.05), seed=1),
        capacity=ni, value_shape=(dim,), init_fn=ref_init(7, (dim,)),
        config=RefElasticConfig(num_shards=1, num_workers=2, wal_dir=str(tmp_path / "refwal")),
        registry=reg,
    )
    driver.start()
    rounds_c = reg.counter("cluster_worker_rounds_total", component="cluster")
    out, errors = [], []
    t = _control_after(rounds_c, 8, driver.scale_out, out, errors)
    try:
        result = driver.run(batches, timeout=120)
        t.join(timeout=60)
        assert not errors and out and out[0].verified, errors
        return result.values
    finally:
        driver.stop()


class TestLiveResize:
    def test_live_resize_parity_e2e(self, tmp_path):
        """ACCEPTANCE: 1 shard → scale out to 2 mid-stream against
        concurrent 2-worker traffic → train to completion.  Final
        table allclose-equal fp32 to an uninterrupted static 2-shard
        run and to the reference's elastic driver resized the same way;
        migrated rows bitwise at handoff (migration verify); the WAL
        ledger audit balances (zero updates lost or double-applied)."""
        batches, init, nu, ni, dim = _mf_fixture()
        base = _static_table(batches, init, nu, ni, dim, num_shards=2)
        reg = MetricsRegistry()
        driver = _elastic(_logic(nu, dim), ni, dim, init, tmp_path, reg, 1)
        rounds_c = reg.counter("cluster_worker_rounds_total", component="cluster")
        scaled, errors = [], []
        t = _control_after(rounds_c, 8, driver.scale_out, scaled, errors)
        try:
            result = driver.run(batches, timeout=120)
            t.join(timeout=60)
            assert not errors, errors
            assert scaled, "scale_out never fired"
            report = scaled[0]
            # migrated rows were verified bitwise before the flip
            assert report.verified and report.mismatches == 0
            assert report.rows_moved > 0
            np.testing.assert_allclose(result.values, base, **BAR)
            # the ledger audit: every unique delta row acked by a
            # worker client was applied on exactly one shard
            acked = sum(c.rows_pushed for c in driver._clients)
            applied = sum(sh.rows_applied for sh in driver.all_shards)
            assert acked == applied
            assert acked > 0
            # topology really flipped
            assert driver.partitioner.num_shards == 2
            assert driver.membership.current().epoch == 1
        finally:
            driver.stop()
        ref = _ref_live_resize_table(nu, ni, dim, 128, 16, tmp_path)
        np.testing.assert_allclose(result.values, ref, **BAR)

    def test_scale_in_parity_e2e(self, tmp_path):
        """Drain-and-retire: 3 shards → 2 mid-stream; parity against a
        static 2-shard run, retired shard fully drained."""
        batches, init, nu, ni, dim = _mf_fixture(rounds=12)
        base = _static_table(batches, init, nu, ni, dim, num_shards=2)
        reg = MetricsRegistry()
        driver = _elastic(_logic(nu, dim), ni, dim, init, tmp_path, reg, 3)
        rounds_c = reg.counter("cluster_worker_rounds_total", component="cluster")
        done, errors = [], []
        t = _control_after(rounds_c, 6, driver.scale_in, done, errors)
        try:
            result = driver.run(batches, timeout=120)
            t.join(timeout=60)
            assert not errors, errors
            assert done and done[0].verified
            assert driver.partitioner.num_shards == 2
            np.testing.assert_allclose(result.values, base, **BAR)
            acked = sum(c.rows_pushed for c in driver._clients)
            applied = sum(sh.rows_applied for sh in driver.all_shards)
            assert acked == applied
            retired = driver._retired[0][0]
            assert retired.stats()["frozen"] == len(retired.owned)
        finally:
            driver.stop()

    def test_killed_shard_replaced_latency_not_errors(self, tmp_path):
        """ACCEPTANCE: kill a shard mid-stream (server down + slice
        gone), replace it from its WAL — the run completes with no
        errors, parity holds, and the replacement is counted."""
        batches, init, nu, ni, dim = _mf_fixture(rounds=12)
        base = _static_table(batches, init, nu, ni, dim, num_shards=2)
        reg = MetricsRegistry()
        driver = _elastic(_logic(nu, dim), ni, dim, init, tmp_path, reg, 2)
        rounds_c = reg.counter("cluster_worker_rounds_total", component="cluster")
        acted, errors = [], []

        def kill_and_replace():
            driver.kill_shard(1)
            time.sleep(0.02)  # the window where clients retry
            return driver.replace_shard(1)

        t = _control_after(rounds_c, 6, kill_and_replace, acted, errors)
        try:
            result = driver.run(batches, timeout=120)
            t.join(timeout=60)
            assert not errors, errors
            assert acted, "replacement never ran"
            np.testing.assert_allclose(result.values, base, **BAR)
            counters = {
                i.name: i.value for i in reg.instruments()
                if i.labels.get("component") == "elastic"
            }
            assert counters["elastic_shard_replacements_total"] == 1
            # the epoch bumped so clients re-resolved the address
            assert driver.membership.current().epoch == 1
        finally:
            driver.stop()

    def test_epoch_refresh_counter_counts_replays(self, tmp_path):
        """A stale-epoch rejection refreshes the membership view and
        replays the frame instead of raising — visible on
        elastic_epoch_refreshes_total."""
        reg = MetricsRegistry()
        part = ConsistentHashPartitioner(64, 1, seed=5)
        shard0 = _shard(0, part, tmp_path, "w0")
        srv0 = ShardServer(shard0, supervised=False).start()
        mem = MembershipService(part, [(srv0.host, srv0.port)], registry=False)
        client = ClusterClient(
            value_shape=(4,), membership=mem, registry=reg, worker="0", chunk=64,
        )
        try:
            # resize happens while the client holds the old view
            new = part.grown(2)
            shard1 = _shard(1, new, tmp_path, "w1")
            srv1 = ShardServer(shard1, supervised=False).start()
            moves = plan_moves(part, new)
            execute_moves(
                moves, {0: shard0, 1: shard1},
                {0: (srv0.host, srv0.port), 1: (srv1.host, srv1.port)},
                (4,), verify=True, registry=False,
            )
            shard1.install_epoch(1, new)
            shard0.install_epoch(1, new)
            mem.publish(new, [(srv0.host, srv0.port), (srv1.host, srv1.port)])
            # client still routes by the OLD map; a moved key's push is
            # rejected, refreshed, replayed — not raised
            moved_id = int(moves[0].ids[0])
            before = client.pull_batch(np.array([moved_id]))[0]
            n = client.push_batch(np.array([moved_id]), np.ones((1, 4), np.float32))
            assert n == 1
            after = client.pull_batch(np.array([moved_id]))[0]
            assert np.allclose(after - before, 1.0)  # applied ONCE
            refreshes = [
                i.value for i in reg.instruments()
                if i.name == "elastic_epoch_refreshes_total"
            ]
            assert refreshes and refreshes[0] >= 1
            assert client.partitioner.num_shards == 2
            srv1.stop()
            shard1.close()
        finally:
            client.close()
            srv0.stop()
            shard0.close()


# ---------------------------------------------------------------------------
# the controller policy
# ---------------------------------------------------------------------------


class TestController:
    def _driver(self, tmp_path, reg):
        d = ElasticClusterDriver(
            _logic(32, 4), capacity=64, value_shape=(4,),
            init_fn=ranged_random_factor(3, (4,)),
            config=ElasticClusterConfig(
                num_shards=1, num_workers=1, wal_dir=str(tmp_path / "wal"),
            ),
            registry=reg, device=CPU,
        )
        d.start()
        return d

    @staticmethod
    def _rtt(reg):
        return [i for i in reg.instruments() if i.name == "cluster_pull_rtt_seconds"][0]

    def test_pressure_scales_out_idle_scales_in(self, tmp_path):
        reg = MetricsRegistry()
        d = self._driver(tmp_path, reg)
        try:
            ctl = ElasticController(
                d, policy=ScalePolicy(max_shards=4, min_window_frames=5, cooldown_s=0.0),
                registry=reg,
            )
            assert ctl.step() is None  # no signal, no action
            h = self._rtt(reg)
            for _ in range(50):
                h.observe(0.2)  # fat tail → pressure
            act = ctl.step()
            assert act and act["action"] == "scale_out" and act["ok"]
            assert d.partitioner.num_shards == 2
            for _ in range(50):
                h.observe(0.0001)  # idle tail → drain
            act = ctl.step()
            assert act and act["action"] == "scale_in" and act["ok"]
            assert d.partitioner.num_shards == 1
        finally:
            d.stop()

    def test_dead_shard_replaced_first(self, tmp_path):
        reg = MetricsRegistry()
        d = self._driver(tmp_path, reg)
        try:
            ctl = ElasticController(d, policy=ScalePolicy(cooldown_s=100.0), registry=reg)
            d.kill_shard(0)
            act = ctl.step()  # replace ignores cooldown
            assert act and act["action"] == "replace" and act["ok"]
            assert d.shard_alive(0)
        finally:
            d.stop()

    def test_cooldown_gates_resizes(self, tmp_path):
        reg = MetricsRegistry()
        d = self._driver(tmp_path, reg)
        try:
            ctl = ElasticController(
                d, policy=ScalePolicy(max_shards=4, min_window_frames=5, cooldown_s=100.0),
                registry=reg,
            )
            h = self._rtt(reg)
            for _ in range(50):
                h.observe(0.2)
            assert ctl.step()["action"] == "scale_out"
            for _ in range(50):
                h.observe(0.2)
            assert ctl.step() is None  # cooling down
        finally:
            d.stop()


def test_elastic_driver_defaults_and_knobs_that_raise(tmp_path):
    """The elastic driver runs on the card unless asked for the CPU; what
    leads into modules not ported yet raises naming its item.  The adaptive
    knobs are served: ``drain_shard`` moves every key off the drained shard,
    and worker clients take a push hedger.  A client keeps its retry budget
    and spends it on a storm-class replay round."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ElasticClusterDriver(_logic(8, 4), capacity=16, value_shape=(4,), registry=False)
    with pytest.raises(ValueError, match="consistent-hash"):
        ElasticClusterDriver(_logic(8, 4), capacity=16, value_shape=(4,), registry=False,
                             config=ElasticClusterConfig(partition="range"), device=CPU)
    d = ElasticClusterDriver(_logic(8, 4), capacity=16, value_shape=(4,), registry=False,
                             config=ElasticClusterConfig(shard_procs=True), device=CPU)
    with pytest.raises(NotImplementedError, match="shard_procs"):
        d.start()
    d = ElasticClusterDriver(_logic(8, 4), capacity=16, value_shape=(4,), registry=False,
                             config=ElasticClusterConfig(num_shards=2, wal_dir=str(tmp_path),
                                                         adaptive=True,
                                                         adaptive_push_hedge_after_s=0.01),
                             device=CPU)
    with d:
        assert all(type(c.push_hedge).__name__ == "PushHedger" for c in d._clients)
        before = {int(g): row for s in d.shards for g, row in zip(s.owned, s.values())}
        report = d.drain_shard(0)
        assert report.verified and report.mismatches == 0
        assert d.partitioner.owned_ids(0).size == 0 and len(d.shards[0].owned) == 0
        after = {int(g): row for s in d.shards for g, row in zip(s.owned, s.values())}
        assert sorted(after) == sorted(before)
        assert all(after[g].tobytes() == before[g].tobytes() for g in before)
    part = ConsistentHashPartitioner(16, 1)
    # the retry budget is kept, and a storm-class replay round spends it
    budget = RetryBudget(1.0, registry=False)
    view = types.SimpleNamespace(epoch=1, partitioner=part, addresses=[("h", 1)], replicas=[])
    c = ClusterClient(value_shape=(4,), membership=types.SimpleNamespace(current=lambda: view),
                      registry=False, retry_budget=budget)
    assert c.retry_budget is budget
    c.retry_sleep_s = c.retry_sleep_cap_s = 1e-4
    c._await_retry(time.monotonic() + 60, 1, "pull", reason="conn")
    assert budget.tokens() == 0.0
    with pytest.raises(RetryBudgetExhausted):
        c._await_retry(time.monotonic() + 60, 2, "pull", reason="conn")
    hedger = object()
    c = ClusterClient([("h", 1)], part, (4,), registry=False, push_hedge=hedger)
    assert c.push_hedge is hedger


@pytest.mark.parametrize("workload, bound", [("mf", 0), ("sketch", 2)])
def test_elastic_clients_take_the_requested_wire_format(workload, bound):
    """The elastic driver hands its worker clients ``wire_format`` as
    configured, as the reference's does
    (``elastic/controller.py`` ``_make_client``): unlike the static
    ``ClusterDriver``, it applies neither the BSP carve-out (q8 at
    staleness bound 0) nor the increment carve-out (the sketch).  Both
    drivers' clients end up with the same format and compressor."""
    from flink_parameter_server_tpu.workloads import WorkloadParams as RefParams
    from flink_parameter_server_tpu.workloads import build_cluster_driver as ref_build
    from flink_parameter_server_tpu_torch.workloads import (
        WorkloadParams,
        build_cluster_driver,
    )

    params = dict(rounds=2, batch=32, num_items=48, num_users=16, dim=4, seed=0)
    cfg = dict(num_shards=1, num_workers=1, staleness_bound=bound, wire_format="q8")

    def probe(driver):
        with driver:
            client = driver._make_client(worker="probe")
            try:
                return client.wire_format, client._compressor is None
            finally:
                client.close()

    got = probe(build_cluster_driver(
        workload, params=WorkloadParams(**params), config=ElasticClusterConfig(**cfg),
        driver_cls=ElasticClusterDriver, registry=False, device=CPU,
    ))
    want = probe(ref_build(
        workload, params=RefParams(**params), config=RefElasticConfig(**cfg),
        driver_cls=RefElasticDriver, registry=False,
    ))
    assert got == want == ("q8", False)


# ---------------------------------------------------------------------------
# LineServer thread hygiene
# ---------------------------------------------------------------------------


class _Echo(LineServer):
    def respond(self, line):
        return "ok " + line


def test_lineserver_stop_joins_handler_threads():
    """stop() joins the per-connection dispatcher threads — including
    one still BLOCKED in its linger-recv on an open client connection —
    so repeated scale-in/out cycles in one process don't leak a thread
    per connection ever accepted."""
    import socket as socket_mod

    for _ in range(5):
        srv = _Echo().start()
        for _ in range(3):
            assert request_lines(srv.host, srv.port, ["ping"]) == ["ok ping"]
        idle = socket_mod.create_connection((srv.host, srv.port))
        idle.sendall(b"ping\n")
        assert idle.recv(1 << 12) == b"ok ping\n"
        deadline = time.monotonic() + 5
        live = []
        while not live and time.monotonic() < deadline:
            live = [t for t in srv._handlers if t.is_alive()]
            time.sleep(0.002)
        assert live, "dispatcher thread never spawned"
        srv.stop()
        deadline = time.monotonic() + 5
        while (
            any(t.is_alive() for t in live + srv._handlers)
            and time.monotonic() < deadline
        ):
            time.sleep(0.01)
        assert not any(t.is_alive() for t in live)  # joined, not leaked
        assert not any(t.is_alive() for t in srv._handlers)
        idle.close()
