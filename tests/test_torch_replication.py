"""The port's replica chains (``replication/``, ``serving/follower.py``)
against the JAX package's.

Thread-backed shards over real TCP on the CPU (the port with
``device="cpu"``), so shipping, the follower's asynchronous apply, the
chain-routed reads and the promotion run for real.  Tolerances:
  * the WAL record framing: bitwise across the packages (a frame one
    encodes, the other decodes to the same record);
  * a caught-up follower: bitwise its own primary, and bitwise the
    reference's follower fed the same pushes (unique ids a push, so each
    row takes one float32 add in either package);
  * the failover storyline: the final table bitwise an uninterrupted
    static run of the port on the same stream (the reference's own
    acceptance bar), and within rtol 1e-4 / atol 1e-6 (the reference's
    cluster bar) of the reference's static cluster on that stream.

Mirrors tests/test_replication.py's TestReplFrames (2), TestShipping (6),
TestReadRouting (4) and TestFailover (3).  Of TestObservability, the
failover SLO is mirrored in tests/test_torch_hotkeys_slo.py and the
``/metrics`` lag gauges in tests/test_torch_telemetry_surfaces.py, with
TestWitnessedReplicationOracle; the metric-line lint waits for the tooling
(ROADMAP Queue 1 #7h).
"""
import base64
import socket as socket_mod
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.cluster import ClusterConfig as RefClusterConfig
from flink_parameter_server_tpu.cluster import ClusterDriver as RefClusterDriver
from flink_parameter_server_tpu.cluster import ConsistentHashPartitioner as RefHash
from flink_parameter_server_tpu.cluster import ParamShard as RefParamShard
from flink_parameter_server_tpu.cluster import ShardServer as RefShardServer
from flink_parameter_server_tpu.data.movielens import synthetic_ratings as ref_ratings
from flink_parameter_server_tpu.data.streams import microbatches as ref_microbatches
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.replication import ReplHub as RefReplHub
from flink_parameter_server_tpu.replication import ReplicaShard as RefReplicaShard
from flink_parameter_server_tpu.replication import WALShipper as RefWALShipper
from flink_parameter_server_tpu.resilience import wal as ref_wal
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch.cluster import (
    ClusterConfig,
    ClusterDriver,
    ConsistentHashPartitioner,
    ParamShard,
    ShardServer,
)
from flink_parameter_server_tpu_torch.cluster import client as client_mod
from flink_parameter_server_tpu_torch.cluster.client import ClusterClient
from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
from flink_parameter_server_tpu_torch.data.streams import microbatches
from flink_parameter_server_tpu_torch.elastic import (
    ElasticController,
    MembershipService,
    PartitionEpoch,
    ScalePolicy,
)
from flink_parameter_server_tpu_torch.models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
)
from flink_parameter_server_tpu_torch.replication import (
    ReplHub,
    ReplicaShard,
    ReplicatedClusterConfig,
    ReplicatedClusterDriver,
    WALShipper,
)
from flink_parameter_server_tpu_torch.replication.failover import verify_against_log
from flink_parameter_server_tpu_torch.resilience.chaos import FaultPlan
from flink_parameter_server_tpu_torch.resilience.wal import (
    decode_frame,
    decode_frame_bytes,
    encode_frame,
    encode_frame_bytes,
)
from flink_parameter_server_tpu_torch.serving.follower import FollowerLookupService
from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor
from flink_parameter_server_tpu_torch.utils.net import request_lines

torch.set_num_threads(2)

pytestmark = pytest.mark.replication

CPU = "cpu"
BAR = dict(rtol=1e-4, atol=1e-6)  # the reference's cluster parity bar


def _init(dim=4):
    def fn(ids):
        return torch.as_tensor(ids, dtype=torch.float32)[:, None] * torch.ones((1, dim))

    return fn


def _ref_init(dim=4):
    def fn(ids):
        return jnp.asarray(ids, jnp.float32)[:, None] * jnp.ones((1, dim), jnp.float32)

    return fn


def _wait_for(cond, timeout=10.0, interval=0.005, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


# ---------------------------------------------------------------------------
# the CRC wire framing
# ---------------------------------------------------------------------------


class TestReplFrames:
    def test_roundtrip(self):
        payload = {"ids": np.array([1, 2]), "deltas": np.ones((2, 4))}
        tok = encode_frame(7, 1, payload)
        # the same bytes as the reference's framing, in both directions
        assert tok == ref_wal.encode_frame(7, 1, payload)
        assert encode_frame_bytes(7, 1, payload) == base64.b64decode(tok)
        for rec in (decode_frame(tok), ref_wal.decode_frame(tok),
                    decode_frame_bytes(ref_wal.encode_frame_bytes(7, 1, payload))):
            assert (rec.start_step, rec.n_steps, rec.end_step) == (7, 1, 8)
            np.testing.assert_array_equal(rec.payload["ids"], [1, 2])

    def test_corruption_rejected(self):
        tok = encode_frame(0, 1, {"ids": np.array([3])})
        raw = bytearray(base64.b64decode(tok))
        raw[-1] ^= 0xFF  # flip a payload byte: CRC must catch it
        bad = base64.b64encode(bytes(raw)).decode()
        for decode in (decode_frame, ref_wal.decode_frame):
            with pytest.raises(ValueError, match="CRC"):
                decode(bad)
            with pytest.raises(ValueError):
                decode("not-base64!!")


# ---------------------------------------------------------------------------
# shipping + follower apply
# ---------------------------------------------------------------------------


def _chain_fixture(tmp_path, *, bound=None, fault_hook=None):
    part = ConsistentHashPartitioner(64, 1)
    primary = ParamShard(
        0, part, (4,), init_fn=_init(), wal_dir=str(tmp_path / "p"),
        registry=False, device=CPU,
    )
    psrv = ShardServer(primary, supervised=False).start()
    follower = ReplicaShard(
        0, part, (4,), init_fn=_init(), wal_dir=str(tmp_path / "f"),
        staleness_bound=bound, registry=False, device=CPU,
    )
    fsrv = ShardServer(follower, supervised=False).start()
    hub = ReplHub()
    ship = WALShipper(
        primary, (fsrv.host, fsrv.port), hub.subscribe(),
        registry=False, fault_hook=fault_hook,
    ).start()
    primary.attach_repl_sink(hub)
    return part, primary, psrv, follower, fsrv, ship


def _ref_follower_values(tmp_path, pushes):
    """The reference's chain fed the same pushes: its caught-up
    follower's slice."""
    part = RefHash(64, 1)
    primary = RefParamShard(0, part, (4,), init_fn=_ref_init(),
                            wal_dir=str(tmp_path / "ref-p"), registry=False)
    follower = RefReplicaShard(0, part, (4,), init_fn=_ref_init(),
                               wal_dir=str(tmp_path / "ref-f"), registry=False)
    fsrv = RefShardServer(follower, supervised=False).start()
    hub = RefReplHub()
    ship = RefWALShipper(primary, (fsrv.host, fsrv.port), hub.subscribe(),
                         registry=False).start()
    primary.attach_repl_sink(hub)
    try:
        for ids, deltas in pushes:
            primary.push(ids, deltas)
        _wait_for(lambda: follower.repl_state()["applied"] == primary.head_seq(),
                  msg="reference follower caught up")
        return np.asarray(follower.values())
    finally:
        ship.stop(); fsrv.stop()
        primary.close(); follower.close()


class TestShipping:
    def test_follower_lands_bitwise(self, tmp_path):
        """Shipped records apply through the same scatter path: a
        caught-up follower's slice is BITWISE the primary's, and the
        reference's follower fed the same pushes."""
        _, primary, psrv, follower, fsrv, ship = _chain_fixture(tmp_path)
        rng = np.random.default_rng(0)
        pushes = [(rng.choice(64, 5, replace=False), rng.normal(size=(5, 4)).astype(np.float32))
                  for _ in range(6)]
        try:
            for ids, deltas in pushes:
                primary.push(ids, deltas)
            _wait_for(
                lambda: follower.repl_state()["applied"] == primary.head_seq(),
                msg="follower caught up",
            )
            assert np.array_equal(primary.values(), follower.values())
            assert ship.lag() == 0
            assert follower.store.table.device.type == "cpu"
        finally:
            ship.stop(); psrv.stop(); fsrv.stop()
            primary.close(); follower.close()
        assert np.array_equal(follower.values(), _ref_follower_values(tmp_path, pushes))

    def test_repl_ack_idempotent_over_wire(self, tmp_path):
        """Re-shipping an acked record answers the same durable seq
        without re-applying (the resync/fast-path race is safe); a frame
        the reference encoded is accepted the same way."""
        _, primary, psrv, follower, fsrv, ship = _chain_fixture(tmp_path)
        try:
            primary.push(np.array([1, 2]), np.ones((2, 4), np.float32))
            _wait_for(lambda: follower.repl_state()["applied"] == 1, msg="first apply")
            before = follower.values().copy()
            rec = primary.repl_backlog(-1)[0]
            line = "repl " + encode_frame(rec.start_step, rec.n_steps, rec.payload) + " head=1"
            ref_line = "repl " + ref_wal.encode_frame(rec.start_step, rec.n_steps, rec.payload) + " head=1"
            r1, r2, r3 = request_lines(fsrv.host, fsrv.port, [line, line, ref_line])
            for r in (r1, r2, r3):
                assert r.startswith("ok acked") and "seq=1" in r, r
            time.sleep(0.05)
            assert np.array_equal(follower.values(), before)
            # the primary refuses the stream: repl frames route to followers
            (resp,) = request_lines(psrv.host, psrv.port, [line])
            assert resp.startswith("err bad-request") and "follower" in resp
        finally:
            ship.stop(); psrv.stop(); fsrv.stop()
            primary.close(); follower.close()

    def test_writes_rejected_on_follower(self, tmp_path):
        _, primary, psrv, follower, fsrv, ship = _chain_fixture(tmp_path)
        try:
            resp = request_lines(fsrv.host, fsrv.port, ["push 1 b64:AAAAAAAAAAAAAAAAAAAAAA=="])
            assert resp == ["err not-primary"]
            # a migration load is a write too
            resp = request_lines(fsrv.host, fsrv.port, ["load 1 b64:AAAAAAAAAAAAAAAAAAAAAA=="])
            assert resp == ["err not-primary"]
        finally:
            ship.stop(); psrv.stop(); fsrv.stop()
            primary.close(); follower.close()

    def test_staleness_bound_rejects_reads(self, tmp_path):
        """The read-staleness contract: lag past the bound answers
        ``err lagging`` on the wire; inside the bound, reads serve."""
        _, primary, psrv, follower, fsrv, ship = _chain_fixture(tmp_path, bound=2)
        try:
            primary.push(np.array([1]), np.ones((1, 4), np.float32))
            _wait_for(lambda: follower.repl_state()["applied"] == 1, msg="apply")
            ok = request_lines(fsrv.host, fsrv.port, ["pull 1 b64"])[0]
            assert ok.startswith("ok")
            # a repl frame advertising a far-ahead head raises the lag
            # past the bound without any applicable records
            rec = primary.repl_backlog(-1)[0]
            line = "repl " + encode_frame(rec.start_step, rec.n_steps, rec.payload) + " head=99"
            request_lines(fsrv.host, fsrv.port, [line])
            resp = request_lines(fsrv.host, fsrv.port, ["pull 1 b64"])[0]
            assert resp.startswith("err lagging lag=98")
            assert follower.reads_rejected >= 1
            # the binary framing answers the typed status with the lag TLV
            from flink_parameter_server_tpu_torch.cluster.client import ShardConnection
            from flink_parameter_server_tpu_torch.utils import frames as binf

            conn = ShardConnection(fsrv.host, fsrv.port, negotiate=True)
            try:
                r = conn.request_many([binf.encode_request(
                    binf.VERB_IDS["pull"], ids=np.array([1], np.int64), enc=binf.ENC_F32)])[0]
                assert r.flag == binf.STATUS_LAGGING and r.tlv_int(binf.T_LAG) == 98
                st = conn.request_many([binf.encode_request(binf.VERB_IDS["replstate"])])[0]
                assert st.flag == binf.STATUS_OK
            finally:
                conn.close()
        finally:
            ship.stop(); psrv.stop(); fsrv.stop()
            primary.close(); follower.close()

    def test_drop_fault_heals_via_resync(self, tmp_path):
        """A chaos-severed repl stream loses NOTHING: the shipper
        reconnects and resyncs the tail from the primary's log."""
        plan = FaultPlan().drop_repl_at(2)
        _, primary, psrv, follower, fsrv, ship = _chain_fixture(
            tmp_path, fault_hook=plan.shipper_hook()
        )
        rng = np.random.default_rng(1)
        pushes = [(rng.choice(64, 3, replace=False), rng.normal(size=(3, 4)).astype(np.float32))
                  for _ in range(8)]
        try:
            for ids, deltas in pushes:
                primary.push(ids, deltas)
            _wait_for(
                lambda: follower.repl_state()["applied"] == primary.head_seq(),
                msg="resync heals the severed stream",
            )
            assert np.array_equal(primary.values(), follower.values())
            assert ship.ship_errors >= 1  # the injected sever
            # fired-once: the same plan's hook never drops again
            assert plan.shipper_hook()(99) is None
        finally:
            ship.stop(); psrv.stop(); fsrv.stop()
            primary.close(); follower.close()
        assert np.array_equal(follower.values(), _ref_follower_values(tmp_path, pushes))

    def test_dedupe_ledger_survives_promotion(self, tmp_path):
        """Exactly-once across the flip: a pid-tagged push replayed
        against the PROMOTED follower is acked without re-applying."""
        _, primary, psrv, follower, fsrv, ship = _chain_fixture(tmp_path)
        try:
            ids = np.array([4, 5])
            primary.push(ids, np.ones((2, 4), np.float32), pid="tok")
            _wait_for(lambda: follower.repl_state()["applied"] == 1, msg="apply")
            ship.stop()
            follower.catch_up()
            follower.promote_to_primary(1)
            before = follower.values().copy()
            seq = follower.push(ids, np.ones((2, 4), np.float32), pid="tok")
            assert seq == 1  # acked as a full duplicate, not re-applied
            assert np.array_equal(follower.values(), before)
            assert follower.stats()["dedupe_pairs"] == 2
            # the reference's row: init 4 and 5 plus one applied push
            want = np.arange(64, dtype=np.float32)[[4, 5], None] * np.ones((1, 4), np.float32) + 1
            np.testing.assert_array_equal(follower.values()[follower.partitioner.to_local(0, ids)], want)
        finally:
            psrv.stop(); fsrv.stop()
            primary.close(); follower.close()

    def test_chain_built_on_a_live_primary_misses_no_push(self, tmp_path):
        """A chain (re)built while pushes land -- a resize re-seeds every
        chain mid-run -- loses none of them: a push logged right after
        the shipper's bootstrap read of the WAL still reaches the
        follower, whose table is then bitwise the primary's.  The
        primary's sink is attached before any shipper starts; attached
        after, that push fell between the backlog and the queue, and a
        later promotion lost it (``sketch_full_stack`` lost one 512-row
        chunk that way)."""
        batches, init, nu, ni, dim = _mf_fixture()
        driver = ReplicatedClusterDriver(
            _logic(nu, dim), capacity=ni, value_shape=(dim,), init_fn=init,
            config=ReplicatedClusterConfig(
                num_shards=1, num_workers=1, wal_dir=str(tmp_path / "wal"),
                replication_factor=1,
            ),
            registry=False, device=CPU,
        )
        driver.start()
        try:
            primary = driver.shards[0]
            primary.push(np.array([1, 2]), np.ones((2, dim), np.float32))
            driver.chains.detach_chain(0)
            read_backlog, attach = primary.repl_backlog, primary.attach_repl_sink
            pushed = threading.Event()

            def backlog_then_push(after_seq):
                recs = read_backlog(after_seq)
                if not pushed.is_set():  # a worker's push, right after the read
                    primary.push(np.array([3, 4]), np.full((2, dim), 2.0, np.float32))
                    pushed.set()
                return recs

            def attach_late(sink):
                pushed.wait(0.5)  # a shipper already running reads first
                attach(sink)

            primary.repl_backlog, primary.attach_repl_sink = backlog_then_push, attach_late
            chain = driver.chains.build_chain(0)
            assert pushed.wait(10)
            primary.push(np.array([5]), np.full((1, dim), 3.0, np.float32))
            follower = chain.followers[0]
            _wait_for(lambda: follower.repl_state()["applied"] == primary.head_seq() == 3,
                      msg="follower at the primary's head")
            assert np.array_equal(follower.values(), primary.values())
        finally:
            driver.stop()


# ---------------------------------------------------------------------------
# client read routing across the chain
# ---------------------------------------------------------------------------


class TestReadRouting:
    def test_reads_load_balance_and_fall_back(self, tmp_path):
        """Pulls rotate across [primary] + followers; a follower held
        past its bound sheds the read to the primary — correct values
        either way, fallbacks counted."""
        part, primary, psrv, follower, fsrv, ship = _chain_fixture(tmp_path, bound=0)
        reg = MetricsRegistry()
        mem = MembershipService(
            part, [(psrv.host, psrv.port)],
            replicas=[[(fsrv.host, fsrv.port)]], registry=False,
        )
        client = ClusterClient(value_shape=(4,), membership=mem, registry=reg, chunk=64)
        try:
            primary.push(np.array([1, 2]), np.ones((2, 4), np.float32))
            _wait_for(lambda: follower.repl_state()["applied"] == 1, msg="apply")
            want = primary.pull(np.array([1, 2]))
            for _ in range(6):  # rotation hits both targets
                got = client.pull_batch(np.array([1, 2]))
                np.testing.assert_array_equal(got, want)
            counts = {i.name: i.value for i in reg.instruments()
                      if i.labels.get("component") == "replication"}
            assert counts["replication_replica_reads_total"] >= 2
            assert follower.reads_served >= 2
            # now hold the follower past its bound: reads still succeed
            # (fallback), and the fallback counter moves
            rec = primary.repl_backlog(-1)[0]
            request_lines(fsrv.host, fsrv.port, [
                "repl " + encode_frame(rec.start_step, rec.n_steps, rec.payload) + " head=50",
            ])
            for _ in range(4):
                got = client.pull_batch(np.array([1, 2]))
                np.testing.assert_array_equal(got, want)
            counts = {i.name: i.value for i in reg.instruments()
                      if i.labels.get("component") == "replication"}
            assert counts["replication_follower_fallbacks_total"] >= 1
            # the rows are the reference's init plus one push
            np.testing.assert_array_equal(want, np.asarray(_ref_init()(np.array([1, 2]))) + 1)
        finally:
            client.close(); ship.stop(); psrv.stop(); fsrv.stop()
            primary.close(); follower.close()

    def test_dead_follower_socket_falls_back(self, tmp_path):
        part, primary, psrv, follower, fsrv, ship = _chain_fixture(tmp_path)
        mem = MembershipService(
            part, [(psrv.host, psrv.port)],
            replicas=[[(fsrv.host, fsrv.port)]], registry=False,
        )
        client = ClusterClient(value_shape=(4,), membership=mem, registry=False, chunk=64,
                               connect_timeout=1.0)
        try:
            primary.push(np.array([7]), np.ones((1, 4), np.float32))
            ship.stop()
            fsrv.stop()  # the follower endpoint dies
            want = primary.pull(np.array([7]))
            for _ in range(4):  # every rotation slot must still answer
                got = client.pull_batch(np.array([7]))
                np.testing.assert_array_equal(got, want)
        finally:
            client.close(); psrv.stop()
            primary.close(); follower.close()

    def test_membership_replicas_validated(self):
        from flink_parameter_server_tpu.elastic import PartitionEpoch as RefPartitionEpoch

        part = ConsistentHashPartitioner(16, 2)
        for cls in (PartitionEpoch, RefPartitionEpoch):
            with pytest.raises(ValueError, match="replica"):
                cls(0, part, (("h", 1), ("h", 2)), ((("h", 3),),))
        # one tuple per shard (empty for a chainless shard) is accepted,
        # deep-tupled, and published forward
        mem = MembershipService(part, [("h", 1), ("h", 2)], replicas=[[["h", 3]], []], registry=False)
        assert mem.current().replicas == ((("h", 3),), ())
        mem.publish(part, [("h", 1), ("h", 2)], replicas=None)
        assert mem.current().epoch == 1 and mem.current().replicas == ()

    def test_connect_timeout_plumbed(self, monkeypatch):
        """Dial and read deadlines are separate end-to-end
        (ShardConnection, request_lines, ClusterClient default)."""
        seen = {}
        real = socket_mod.create_connection

        def spy(addr, timeout=None):
            seen["dial"] = timeout
            return real(addr, timeout=timeout)

        monkeypatch.setattr(client_mod.socket, "create_connection", spy)
        part = ConsistentHashPartitioner(8, 1)
        shard = ParamShard(0, part, (2,), registry=False, device=CPU)
        srv = ShardServer(shard, supervised=False).start()
        try:
            c = ClusterClient([(srv.host, srv.port)], part, (2,), timeout=9.0,
                              connect_timeout=1.25, registry=False)
            c.pull_batch(np.array([1]))
            assert seen["dial"] == 1.25
            assert c._conns[(srv.host, srv.port)]._sock.gettimeout() == 9.0
            c.close()
        finally:
            srv.stop()
        shard2 = ParamShard(0, part, (2,), registry=False, device=CPU)
        srv2 = ShardServer(shard2, supervised=False).start()
        try:
            out = request_lines(srv2.host, srv2.port, ["stats"], timeout=9.0, connect_timeout=0.75)
            assert out[0].startswith("ok")
        finally:
            srv2.stop()


# ---------------------------------------------------------------------------
# the failover storyline
# ---------------------------------------------------------------------------


def _mf_fixture(num_users=48, num_items=64, dim=4, batch=96, rounds=10):
    cols = synthetic_ratings(num_users, num_items, rounds * batch, seed=3)
    batches = list(microbatches(cols, batch))
    init = ranged_random_factor(7, (dim,))
    return batches, init, num_users, num_items, dim


def _logic(nu, dim):
    return OnlineMatrixFactorization(nu, dim, updater=SGDUpdater(0.05), seed=1, device=CPU)


def _static_table(batches, init, nu, ni, dim, *, num_shards, workers=1):
    driver = ClusterDriver(
        _logic(nu, dim), capacity=ni, value_shape=(dim,), init_fn=init,
        config=ClusterConfig(num_shards=num_shards, num_workers=workers, partition="hash"),
        registry=False, device=CPU,
    )
    with driver:
        return driver.run(batches).values


def _ref_static_table(nu, ni, dim, batch, rounds, *, num_shards):
    """The reference's static hash cluster on the same seeded stream."""
    cols = ref_ratings(nu, ni, rounds * batch, seed=3)
    logic = ref_mf.OnlineMatrixFactorization(nu, dim, updater=ref_mf.SGDUpdater(0.05), seed=1)
    driver = RefClusterDriver(
        logic, capacity=ni, value_shape=(dim,), init_fn=ref_init(7, (dim,)),
        config=RefClusterConfig(num_shards=num_shards, num_workers=1, partition="hash"),
        registry=False,
    )
    with driver:
        return np.asarray(driver.run(list(ref_microbatches(cols, batch))).values)


class TestFailover:
    def test_kill_primary_mid_train_while_serve_e2e(self, tmp_path):
        """The primary dies mid-train-while-serve; the controller
        promotes the follower via an epoch flip with the old primary
        fenced.  Reads keep flowing from the follower (ZERO serving
        errors), the final table is BITWISE-identical to an uninterrupted
        run on the same stream and at the cluster bar of the reference's,
        the promoted shard is bitwise its own replayed log, and the
        (pid, id) dedupe ledger survives the flip."""
        batches, init, nu, ni, dim = _mf_fixture()
        base = _static_table(batches, init, nu, ni, dim, num_shards=2, workers=1)
        ref = _ref_static_table(nu, ni, dim, 96, 10, num_shards=2)
        assert np.allclose(base, ref, **BAR)
        reg = MetricsRegistry()
        driver = ReplicatedClusterDriver(
            _logic(nu, dim), capacity=ni, value_shape=(dim,), init_fn=init,
            config=ReplicatedClusterConfig(
                num_shards=2, num_workers=1,
                wal_dir=str(tmp_path / "wal"),
                replication_factor=1,
                follower_staleness_bound=None,
                verify_promotion=True,
            ),
            registry=reg, device=CPU,
        )
        driver.start()
        # the consistency carve-out: BSP worker clients read the
        # primary only; serving lookups below still chain-route
        assert driver._clients[0]._read_replicas is False
        assert all(f.store.table.device.type == "cpu"
                   for c in driver.chains.chains.values() for f in c.followers)
        controller = ElasticController(
            driver,
            policy=ScalePolicy(max_shards=2, min_shards=2, min_window_frames=10_000),
            registry=reg,
        )
        serve = FollowerLookupService(driver.membership, (dim,), registry=reg, retry_timeout=30.0,
                                      device=CPU)
        errors, served = [], [0]
        stop_reader = threading.Event()

        def reader():
            ids = np.arange(0, 24)
            while not stop_reader.is_set():
                try:
                    res = serve.lookup(ids)
                    assert res.values.shape == (24, dim) and res.values.device.type == "cpu"
                    served[0] += 1
                except Exception as e:  # noqa: BLE001 — asserted empty
                    errors.append(f"{type(e).__name__}: {e}")
                time.sleep(0.002)

        rounds_c = reg.counter("cluster_worker_rounds_total", component="cluster")
        actions = []

        def control():
            _wait_for(lambda: rounds_c.value >= 3, timeout=60, msg="training underway")
            driver.kill_shard(0)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                act = controller.step()
                if act is not None:
                    actions.append(act)
                    if act["action"] == "promote":
                        return
                time.sleep(0.01)

        reader_t = threading.Thread(target=reader, daemon=True)
        control_t = threading.Thread(target=control, daemon=True)
        reader_t.start()
        control_t.start()
        try:
            result = driver.run(batches, timeout=180)
            control_t.join(timeout=60)
            stop_reader.set()
            reader_t.join(timeout=10)
            promotes = [a for a in actions if a["action"] == "promote"]
            assert promotes and promotes[0]["ok"], actions
            assert errors == [], errors[:5]
            assert served[0] > 0
            assert driver.shards[0].role == "primary"
            assert driver.membership.current().epoch >= 1
            assert np.array_equal(result.values, base)
            assert np.allclose(result.values, ref, **BAR)
            assert verify_against_log(driver.shards[0])
            assert driver.shards[0].stats()["dedupe_pairs"] > 0
            counts = {i.name: i.value for i in reg.instruments()
                      if i.labels.get("component") == "replication"}
            assert counts["replication_failovers_total"] == 1
            assert counts["replication_failover_seconds"]["count"] == 1
        finally:
            stop_reader.set()
            serve.close()
            driver.stop()

    def test_partition_fault_sheds_reads_then_failover(self, tmp_path):
        """Chaos partition: the repl stream pauses, lag grows past the
        bound, follower reads shed to the primary (no errors); then the
        primary is killed and the follower still promotes — salvage
        covers the unshipped tail, and the promoted table equals the
        uninterrupted 1-shard run bitwise."""
        batches, init, nu, ni, dim = _mf_fixture(rounds=8)
        plan = FaultPlan().partition_repl_at(2, 300.0)
        reg = MetricsRegistry()
        driver = ReplicatedClusterDriver(
            _logic(nu, dim), capacity=ni, value_shape=(dim,), init_fn=init,
            config=ReplicatedClusterConfig(
                num_shards=1, num_workers=1,
                wal_dir=str(tmp_path / "wal"),
                replication_factor=1,
                follower_staleness_bound=1,
                repl_fault_hook=plan.shipper_hook(),
            ),
            registry=reg, device=CPU,
        )
        driver.start()
        try:
            result = driver.run(batches, timeout=120)
            assert result.rounds == len(batches)

            def shipped() -> float:
                return sum(i.value for i in reg.instruments()
                           if i.name == "replication_records_shipped_total")

            _wait_for(lambda: shipped() >= 1, timeout=15, msg="a shipped record")
            driver.kill_shard(0)
            report = driver.promote_shard(0)
            assert report.failover_seconds < 5.0
            assert verify_against_log(driver.shards[0])
            base = _static_table(batches, init, nu, ni, dim, num_shards=1)
            assert np.array_equal(driver.shards[0].values(), base)
        finally:
            driver.stop()

    def test_promotion_salvages_from_the_newest_snapshot_barrier(self, tmp_path):
        """A resize re-seeds every chain; a follower whose leg has shipped
        nothing since (a chaos hook drops every frame: a lagging leg) is
        then promoted from the dead primary's salvaged log.  The salvage
        starts no earlier than the primary's newest snapshot barrier, as the
        shipper's resync does (``repl_backlog``): the records before it hold
        ids of the pre-resize map, which the promoted shard does not own.
        Salvaged from the log's start, the promotion raised ``KeyError: ...
        not owned by shard 1 (mis-routed request)`` and the run lost its
        table (the corpus's ``pa_full_stack`` under load).  The promoted
        table is bitwise the dead primary's."""
        _, init, nu, ni, dim = _mf_fixture()
        held = threading.Event()
        driver = ReplicatedClusterDriver(
            _logic(nu, dim), capacity=ni, value_shape=(dim,), init_fn=init,
            config=ReplicatedClusterConfig(
                num_shards=2, num_workers=1, wal_dir=str(tmp_path / "wal"),
                replication_factor=1, verify_promotion=True,
                repl_fault_hook=lambda idx: "drop" if held.is_set() else None,
            ),
            registry=False, device=CPU,
        )
        driver.start()
        try:
            ids = np.arange(ni)

            def push_owned(round_):
                owner = driver.partitioner.shard_of(ids)
                for s, shard in enumerate(driver.shards):
                    mine = ids[owner == s]
                    shard.push(mine, np.full((mine.size, dim), 0.5 + round_, np.float32))

            push_owned(0)
            held.set()  # from here no leg ships a frame
            driver.scale_out(1)
            push_owned(1)
            follower = driver.chains.chain(1).followers[0]
            assert follower.repl_state()["logged"] == -1  # the re-seeded follower holds nothing
            before = driver.shards[1].values().copy()
            old_owned = np.flatnonzero(np.arange(ni) % 2 == 1)  # a 2-shard hash map's shard 1
            assert (driver.partitioner.shard_of(old_owned) != 1).any()  # the resize moved some away
            driver.kill_shard(1)
            report = driver.promote_shard(1)
            assert report.records_salvaged >= 2 and report.verified
            assert driver.shards[1].role == "primary"
            np.testing.assert_array_equal(driver.shards[1].values(), before)
        finally:
            driver.stop()

    def test_missed_heartbeats_trigger_promote(self, tmp_path):
        """A WEDGED primary (listening but not answering inside the
        heartbeat budget) is promoted over: shard_alive turns False on
        heartbeat age alone, and the controller's dead-shard branch
        picks promote."""
        batches, init, nu, ni, dim = _mf_fixture(rounds=4)
        reg = MetricsRegistry()
        driver = ReplicatedClusterDriver(
            _logic(nu, dim), capacity=ni, value_shape=(dim,), init_fn=init,
            config=ReplicatedClusterConfig(
                num_shards=1, num_workers=1,
                wal_dir=str(tmp_path / "wal"),
                replication_factor=1,
                heartbeat_interval_s=0.02,
                heartbeat_timeout_s=0.25,
            ),
            registry=reg, device=CPU,
        )
        driver.start()
        controller = ElasticController(driver, policy=ScalePolicy(min_window_frames=10_000),
                                       registry=reg)
        try:
            result = driver.run(batches, timeout=120)
            _wait_for(lambda: driver.chains.monitor.age("shard-0") is not None, msg="first heartbeat")
            assert driver.shard_alive(0)
            orig_stats = driver.shards[0].stats

            def wedged_stats():
                time.sleep(0.6)
                return orig_stats()

            driver.shards[0].stats = wedged_stats
            _wait_for(lambda: not driver.shard_alive(0), timeout=15,
                      msg="missed heartbeats flip liveness")
            decision = controller.evaluate()
            assert decision == {"action": "promote", "shard": 0}
            act = controller.step()
            assert act["ok"], act
            assert driver.shards[0].role == "primary"
            client = driver._make_client()
            got = client.pull_batch(np.arange(ni))
            assert got.shape == (ni, dim)
            # the promoted follower serves the trained table
            np.testing.assert_array_equal(got, result.values)
            client.close()
        finally:
            driver.stop()


def test_entry_points_default_to_the_card(tmp_path):
    """ReplicaShard, ReplicatedClusterDriver (and with it ChainManager)
    and FollowerLookupService run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    part = ConsistentHashPartitioner(8, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        ReplicaShard(0, part, (2,), wal_dir=str(tmp_path / "f"), registry=False)
    with pytest.raises(RuntimeError, match="cuda"):
        ReplicatedClusterDriver(_logic(8, 2), capacity=8, value_shape=(2,), registry=False,
                                config=ReplicatedClusterConfig(wal_dir=str(tmp_path / "w")))
    mem = MembershipService(part, [("127.0.0.1", 1)], registry=False)
    with pytest.raises(RuntimeError, match="cuda"):
        FollowerLookupService(mem, (2,), registry=False)
    with pytest.raises(ValueError, match="wal_dir"):
        ReplicatedClusterDriver(_logic(8, 2), capacity=8, value_shape=(2,), registry=False,
                                config=ReplicatedClusterConfig(), device=CPU)
