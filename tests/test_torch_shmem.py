"""The port's shared-memory transport (shmem/) against the JAX package's.

Mirrors tests/test_shmem.py on the CPU, every shard built with
``device="cpu"`` (its ``TestTooling`` waits for the tooling mirrors,
ROADMAP Queue 1 #7h): the ring's edge cases (``TestRing``), the process-local bell
(``TestBell``), negotiation and every refusal path, the ChaosProxy splice
point included (``TestNegotiation``), the borrow-reclaim lease
(``TestBorrowReclaim``), the oversize detour, the batch spill and the
oversize-response error (``TestSizing``), BSP MF and PA over shm bitwise
their binary-TCP runs (``TestParity``) and the leak check
(``TestHygiene``, ``slow`` as in the reference).

Held against the reference, on the same inputs (``TestCrossPackage``):
  * the ring layout: the same records produced by either package's
    ``ShmRing`` leave byte-identical segments, and records written by one
    package's ring (a wrapped one among them) read back byte for byte
    through the other's ``ShmRing`` attached to the same segment;
  * the slice as a whole: the port's BSP MF and PA runs over shm (2 shards
    x 1 worker, ``WorkloadParams(rounds=4, batch=48, num_users=24,
    num_items=32, dim=4, seed=3)``) meet the cluster bar (rtol 1e-4, atol
    1e-6) against the reference's runs over shm.
And the port's own hazard: a zero-copy pull frame is a WRITABLE view of
shared memory, so two consecutive pull batches, the second lapping the
response ring, must leave the first batch's rows (and the hot cache's
leased rows) unchanged.

The file skips where the port's own ``shmem.available()`` is False.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from flink_parameter_server_tpu.cluster.driver import ClusterConfig as RefConfig
from flink_parameter_server_tpu.shmem import ring as ref_ring
from flink_parameter_server_tpu.workloads import (
    WorkloadParams as RefParams,
    build_cluster_driver as ref_build_cluster_driver,
    create_workload as ref_create_workload,
)
from flink_parameter_server_tpu_torch import telemetry as tm
from flink_parameter_server_tpu_torch.cluster.client import (
    ClusterClient,
    ShardConnection,
)
from flink_parameter_server_tpu_torch.cluster.driver import ClusterConfig
from flink_parameter_server_tpu_torch.cluster.partition import RangePartitioner
from flink_parameter_server_tpu_torch.cluster.shard import ParamShard, ShardServer
from flink_parameter_server_tpu_torch.hotcache import HotRowCache, StaticHotSet
from flink_parameter_server_tpu_torch.shmem import available
from flink_parameter_server_tpu_torch.shmem.channel import (
    ShmShardConnection,
    shm_usable,
)
from flink_parameter_server_tpu_torch.shmem.doorbell import Doorbell
from flink_parameter_server_tpu_torch.shmem.ring import (
    HDR_SIZE,
    K_FRAME,
    K_LINE,
    K_WRAP,
    REC_SIZE,
    RingClosed,
    RingCorruption,
    RingTimeout,
    ShmRing,
    _OFF_HEAD,
    _OFF_TAIL,
    _U64,
)
from flink_parameter_server_tpu_torch.utils import frames as binf
from flink_parameter_server_tpu_torch.workloads import (
    WorkloadParams,
    build_cluster_driver,
    create_workload,
)

pytestmark = [
    pytest.mark.shmem,
    pytest.mark.skipif(not available(), reason="no writable /dev/shm on this host"),
]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
CLUSTER_BAR = dict(rtol=1e-4, atol=1e-6)  # the reference's cluster parity bar
PARITY = dict(rounds=4, batch=48, num_users=24, num_items=32, dim=4, seed=3)


@pytest.fixture()
def fresh_registry():
    reg = tm.MetricsRegistry(run_id="test-shmem")
    tm.set_registry(reg)
    yield reg
    tm.set_registry(None)


def _mini_cluster(n_shards=2, *, dim=4, capacity=64, **server_kw):
    part = RangePartitioner(capacity, n_shards)
    shards = [
        ParamShard(i, part, (dim,), registry=False, device=CPU)
        for i in range(n_shards)
    ]
    servers = [ShardServer(s, **server_kw).start() for s in shards]
    addrs = [(srv.host, srv.port) for srv in servers]
    return part, shards, servers, addrs


# ---------------------------------------------------------------------------
# ring edge cases
# ---------------------------------------------------------------------------


class TestRing:
    def test_round_trip_both_kinds_and_depth(self):
        r = ShmRing.create(4096)
        try:
            assert r.depth() == 0
            r.produce(K_LINE, b"stats")
            r.produce(K_FRAME, b"\x01\x02\x03")
            assert r.depth() > 0
            kind, view = r.consume(timeout=1.0)
            assert (kind, bytes(view)) == (K_LINE, b"stats")
            assert r.borrowed() > 0
            kind, view = r.consume(timeout=1.0)
            assert (kind, bytes(view)) == (K_FRAME, b"\x01\x02\x03")
            view = None
            r.release()
            assert r.borrowed() == 0
            assert r.depth() == 0
        finally:
            r.close()
            r.unlink()

    def test_wraparound_straddle_preserves_every_byte(self):
        """300 seeded variable-size records through a 256-byte ring: the
        write position laps it dozens of times, through both the K_WRAP
        marker and the implicit skip, every payload back in order."""
        rng = np.random.default_rng(0)
        r = ShmRing.create(256)
        try:
            for i, size in enumerate(rng.integers(1, 121, 300)):
                payload = bytes([i % 251]) * int(size)
                kind = K_FRAME if i % 2 else K_LINE
                r.produce(kind, payload, timeout=1.0)
                got_kind, view = r.consume(timeout=1.0)
                assert got_kind == kind
                assert bytes(view) == payload, f"record {i}"
                view = None
                r.release()
            assert r._wpos > 10 * 256
        finally:
            r.close()
            r.unlink()

    def test_full_ring_backpressure_and_borrow_pin(self):
        r = ShmRing.create(128)
        try:
            p1, p2 = b"a" * 56, b"b" * 56  # 64-byte records: 2 fill it
            r.produce(K_FRAME, p1)
            r.produce(K_FRAME, p2)
            with pytest.raises(RingTimeout):
                r.produce(K_FRAME, b"c" * 56, timeout=0.05)
            _, view = r.consume(timeout=1.0)
            assert bytes(view) == p1
            # consumed but NOT released: the producer stays off
            assert r.borrowed() == 64
            with pytest.raises(RingTimeout):
                r.produce(K_FRAME, b"c" * 56, timeout=0.05)
            view = None
            r.release()
            r.produce(K_FRAME, b"c" * 56, timeout=1.0)
            _, v2 = r.consume(timeout=1.0)
            _, v3 = r.consume(timeout=1.0)
            assert bytes(v2) == p2 and bytes(v3) == b"c" * 56
            v2 = v3 = None
            r.release()
        finally:
            r.close()
            r.unlink()

    def test_torn_commit_recovery_seeded(self):
        """A reader never adopts a torn index: with the head's sequence
        byte odd over a garbage value, it waits for the even publish."""
        r = ShmRing.create(1024)
        try:
            r._write_idx(_OFF_HEAD, 42)
            buf = r.buf
            s = buf[_OFF_HEAD]
            buf[_OFF_HEAD] = (s + 1) & 0xFF       # odd: mid-publish
            _U64.pack_into(buf, _OFF_HEAD + 8, 0xDEAD)  # the torn value
            got = []
            t = threading.Thread(
                target=lambda: got.append(r._read_idx(_OFF_HEAD)),
                daemon=True,
            )
            t.start()
            time.sleep(0.05)
            assert not got, "reader adopted a mid-publish value"
            _U64.pack_into(buf, _OFF_HEAD + 8, 43)
            buf[_OFF_HEAD] = (s + 2) & 0xFF       # even: committed
            t.join(timeout=2.0)
            assert got == [43]
        finally:
            r.close()
            r.unlink()

    def test_scribbled_record_header_raises_corruption(self):
        r = ShmRing.create(1024)
        try:
            r.produce(K_FRAME, b"payload")
            r.buf[HDR_SIZE + 4] = 9  # kind byte: not LINE/FRAME/WRAP
            with pytest.raises(RingCorruption):
                r.consume(timeout=0.5)
        finally:
            r.close()
            r.unlink()

    def test_closed_ring_raises_and_oversize_rejected(self):
        r = ShmRing.create(256)
        try:
            with pytest.raises(ValueError):
                r.produce(K_FRAME, b"x" * 512)  # can never fit
            r.mark_closed()
            with pytest.raises(RingClosed):
                r.consume(timeout=0.5)
            with pytest.raises(RingClosed):
                r.produce(K_FRAME, b"x")
        finally:
            r.close()
            r.unlink()

    def test_half_ring_record_rejected_not_deadlocked(self):
        """A record over capacity // 2 raises up front instead of
        waiting on an empty ring (892 bytes at offset 200 of 1024 would
        need 824 bytes of skip plus 900 of record)."""
        r = ShmRing.create(1024)
        try:
            r.produce(K_FRAME, b"a" * 192, timeout=1.0)
            _, view = r.consume(timeout=1.0)
            view = None
            r.release()
            assert r._wpos % r.capacity == 200
            t0 = time.monotonic()
            with pytest.raises(ValueError):
                r.produce(K_FRAME, b"x" * 892, timeout=5.0)
            assert time.monotonic() - t0 < 1.0, (
                "oversize record waited instead of raising"
            )
            assert r.max_record == 1024 // 2 - 8
            r.produce(K_FRAME, b"y" * r.max_record, timeout=1.0)
            _, view = r.consume(timeout=1.0)
            assert bytes(view) == b"y" * r.max_record
            view = None
            r.release()
        finally:
            r.close()
            r.unlink()

    def test_max_record_fits_at_every_alignment(self):
        r = ShmRing.create(256)
        try:
            big = r.max_record  # 120
            for i in range(60):
                for payload in (bytes([i % 251]), b"z" * big):
                    r.produce(K_FRAME, payload, timeout=1.0)
                    _, view = r.consume(timeout=1.0)
                    assert bytes(view) == payload, f"round {i}"
                    view = None
                    r.release()
            assert r._wpos > 4 * 256
        finally:
            r.close()
            r.unlink()


# ---------------------------------------------------------------------------
# the bell
# ---------------------------------------------------------------------------


class TestBell:
    def test_shared_flag_flips_on_second_in_process_attach(self):
        r = ShmRing.create(1024)
        try:
            assert r.bell.shared is False
            r2 = ShmRing.attach(r.name)
            try:
                assert r2.bell is r.bell
                assert r.bell.shared is True
            finally:
                r2.close()
        finally:
            r.close()
            r.unlink()

    def test_publish_rings_only_a_parked_peer(self):
        r = ShmRing.create(1024)
        try:
            bell = r.bell
            bell.clear()
            r.produce(K_LINE, b"quiet")
            assert bell.wait(0) is False  # nobody parked: elided
            r.set_parked(True)
            r.produce(K_LINE, b"rung")
            assert bell.wait(0) is True
            r.set_parked(False)
        finally:
            r.close()
            r.unlink()

    def test_parked_consumer_woken_by_produce(self):
        r = ShmRing.create(4096)
        r2 = ShmRing.attach(r.name)
        try:
            db = Doorbell("test", ring=r2, registry=False)
            got = []

            def waiter():
                kind, view = r2.consume(timeout=5.0, waiter=db.wait)
                got.append(bytes(view))
                view = None
                r2.release()

            t = threading.Thread(target=waiter, daemon=True)
            t.start()
            time.sleep(0.05)  # let it park
            r.produce(K_FRAME, b"wake")
            t.join(timeout=2.0)
            assert got == [b"wake"]
            assert db.parks >= 1 and db.wakes >= 1
            # both ends in one process: the doorbell never spun
            assert db.spins == 0
        finally:
            r2.close()
            r.close()
            r.unlink()

    def test_doorbell_timeout_and_counters(self):
        db = Doorbell("test", spin=10, registry=False)
        assert db.wait(lambda: False, timeout=0.05) is False
        assert db.parks == 1 and db.wakes == 0
        assert db.wait(lambda: True) is True


# ---------------------------------------------------------------------------
# negotiation, fallback, e2e data plane
# ---------------------------------------------------------------------------


class TestNegotiation:
    def test_shm_hello_lands_end_to_end(self):
        part, shards, servers, addrs = _mini_cluster()
        try:
            c = ClusterClient(
                addrs, part, (4,), registry=False, wire_proto="shm"
            )
            ids = np.arange(64, dtype=np.int64)
            base = c.pull_batch(ids)
            c.push_batch(ids, np.ones((64, 4), np.float32))
            after = c.pull_batch(ids)
            assert np.array_equal(after, base + 1)
            assert all(
                cc.proto == "shm" and cc.wire == "shm"
                for cc in c._conns.values()
            )
            resp = c._conns[addrs[0]].request("conns")
            doc = json.loads(resp[3:])
            assert doc[0]["proto"] == "shm" and doc[0]["wire"] == "shm"
            table = servers[0].conn_table()
            assert table and table[0]["wire"] == "shm"
            # the pump and the client's rings share a bell in-process
            assert c._conns[addrs[0]]._s2c.bell.shared
            c.close()
        finally:
            for s in servers:
                s.stop()

    def test_server_opt_out_falls_back_to_binary(self, fresh_registry):
        part, shards, servers, addrs = _mini_cluster(
            n_shards=1, enable_shm=False
        )
        try:
            conn = ShmShardConnection(
                addrs[0][0], addrs[0][1], registry=fresh_registry
            )
            assert conn.proto == "bin" and conn.wire == "tcp"
            req = binf.encode_request(
                binf.VERB_IDS["pull"],
                ids=np.arange(8, dtype=np.int64),
            )
            frame = conn.request_many([req])[0]
            assert frame.verb_name == "pull"
            assert fresh_registry.counter(
                "shmem_fallbacks_total", component="shmem",
                reason="hello-refused",
            ).value >= 1
            conn.close()
        finally:
            for s in servers:
                s.stop()

    def test_non_loopback_peer_never_attempts_shm(self):
        assert shm_usable("10.1.2.3") is False
        assert shm_usable("127.0.0.1") in (True, False)  # host-dependent

    def test_chaos_proxy_splice_point_downgrades(self):
        """Through the port's ChaosProxy the shm hello is refused at the
        splice point: the client lands on binary over the proxied link,
        traffic flows, and the proxy counts the refusal."""
        from flink_parameter_server_tpu_torch.nemesis.proxy import ChaosProxy

        part, shards, servers, addrs = _mini_cluster(n_shards=1)
        proxy = ChaosProxy(
            addrs[0][0], addrs[0][1], registry=False
        ).start()
        try:
            c = ClusterClient(
                [(proxy.host, proxy.port)], part, (4,),
                registry=False, wire_proto="shm",
            )
            ids = np.arange(16, dtype=np.int64)
            c.push_batch(ids, np.full((16, 4), 2.0, np.float32))
            assert np.array_equal(
                c.pull_batch(ids), np.full((16, 4), 2.0, np.float32)
            )
            assert all(cc.proto == "bin" for cc in c._conns.values())
            assert proxy.shm_downgrades == 1
            c.close()
        finally:
            proxy.stop()
            for s in servers:
                s.stop()


class TestBorrowReclaim:
    def test_reader_crash_while_borrowing_reclaimed(self, fresh_registry):
        """A client whose heartbeat went stale while the pump is
        write-blocked on a full response ring is reclaimed: counted,
        rings closed, TCP anchor dropped."""
        part, shards, servers, addrs = _mini_cluster(n_shards=1)
        servers[0].SHM_RECLAIM_S = 0.3
        conn = None
        try:
            conn = ShmShardConnection(
                addrs[0][0], addrs[0][1],
                capacity=64 * 1024, registry=False,
            )
            assert conn.proto == "shm"
            conn._hb_stop.set()
            conn._hb_thread.join(timeout=2.0)
            req = binf.encode_request(
                binf.VERB_IDS["pull"],
                ids=np.arange(64, dtype=np.int64),
            )
            for _ in range(120):  # ~1 KiB per response: s2c fills
                try:
                    conn._c2s.produce(K_FRAME, req, timeout=1.0)
                except (RingTimeout, RingClosed):
                    break
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not conn._s2c.closed:
                time.sleep(0.05)
            assert conn._s2c.closed, "pump never reclaimed the channel"
            assert fresh_registry.counter(
                "shmem_borrow_reclaims_total", component="shmem",
                role="server",
            ).value >= 1
        finally:
            if conn is not None:
                conn.close()
            for s in servers:
                s.stop()


class TestSizing:
    def _pull(self, n, start=0):
        return binf.encode_request(
            binf.VERB_IDS["pull"],
            ids=np.arange(start, start + n, dtype=np.int64),
        )

    def _rows(self, frame, dim=4):
        return binf.rows_from_payload(frame.payload, (dim,), frame.enc)

    def test_oversize_request_detours_over_tcp(self, fresh_registry):
        part, shards, servers, addrs = _mini_cluster(
            n_shards=1, capacity=512
        )
        conn = None
        try:
            conn = ShmShardConnection(
                addrs[0][0], addrs[0][1],
                capacity=4096, registry=fresh_registry,
            )
            assert conn.proto == "shm"
            big = self._pull(300)  # 2424-byte frame > max_record 2040
            assert len(big) > conn._max_payload
            small_before, oversize, small_after = conn.request_many(
                [self._pull(8), big, self._pull(8, start=292)]
            )
            assert oversize.n == 300
            rows = self._rows(oversize)
            assert np.array_equal(rows[:8], self._rows(small_before))
            assert np.array_equal(rows[292:], self._rows(small_after))
            assert conn.proto == "shm" and conn.wire == "shm"
            assert fresh_registry.counter(
                "shmem_fallbacks_total", component="shmem",
                reason="oversize",
            ).value == 1
            conn.close()
            conn = None
        finally:
            if conn is not None:
                conn.close()
            for s in servers:
                s.stop()

    def test_batch_spill_when_responses_outgrow_ring(self):
        part, shards, servers, addrs = _mini_cluster(
            n_shards=1, capacity=512
        )
        conn = ref = None
        try:
            conn = ShmShardConnection(
                addrs[0][0], addrs[0][1],
                capacity=4096, registry=False,
            )
            assert conn.proto == "shm"
            reqs = [self._pull(64, start=64 * i) for i in range(8)]
            t0 = time.monotonic()
            frames = conn.request_many(reqs)
            assert time.monotonic() - t0 < 10.0, "batch wedged"
            assert conn.spills >= 1, "batch this size must have spilled"
            ref = ShardConnection(
                addrs[0][0], addrs[0][1], negotiate=True
            )
            for i, frame in enumerate(frames):
                want = self._rows(ref.request_many(
                    [self._pull(64, start=64 * i)]
                )[0])
                assert np.array_equal(self._rows(frame), want), f"chunk {i}"
            again = conn.request_many([self._pull(8)])[0]
            assert again.n == 8
            conn.close()
            conn = None
        finally:
            if conn is not None:
                conn.close()
            if ref is not None:
                ref.close()
            for s in servers:
                s.stop()

    def test_oversize_response_is_protocol_error_not_teardown(self):
        part, shards, servers, addrs = _mini_cluster(
            n_shards=1, capacity=512
        )
        conn = None
        try:
            conn = ShmShardConnection(
                addrs[0][0], addrs[0][1],
                capacity=4096, registry=False,
            )
            assert conn.proto == "shm"
            # request fits (1624 B) but its response (3224 B) does not
            resp = conn.request_many([self._pull(200)])[0]
            assert isinstance(resp, str)
            assert resp.startswith("err bad-request")
            assert "exceeds shm ring record limit" in resp
            frame = conn.request_many([self._pull(8)])[0]
            assert frame.n == 8
            conn.close()
            conn = None
        finally:
            if conn is not None:
                conn.close()
            for s in servers:
                s.stop()

    def test_pump_error_teardown_is_counted(self, fresh_registry):
        part, shards, servers, addrs = _mini_cluster(n_shards=1)
        conn = None
        try:
            conn = ShmShardConnection(
                addrs[0][0], addrs[0][1], registry=False,
            )
            assert conn.proto == "shm"

            def boom(data):
                raise RuntimeError("poisoned record")

            servers[0].respond_frame = boom
            conn._c2s.produce(K_FRAME, self._pull(8), timeout=1.0)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not conn._s2c.closed:
                time.sleep(0.02)
            assert conn._s2c.closed, "pump never folded the channel"
            assert fresh_registry.counter(
                "shmem_pump_teardowns_total", component="shmem",
                reason="error",
            ).value >= 1
        finally:
            if conn is not None:
                conn.close()
            for s in servers:
                s.stop()


# ---------------------------------------------------------------------------
# BSP parity through the shm wire
# ---------------------------------------------------------------------------


def _port_run(workload, proto):
    w = create_workload(workload, WorkloadParams(**PARITY), device=CPU)
    driver = build_cluster_driver(
        w,
        config=ClusterConfig(
            num_shards=2, num_workers=1, staleness_bound=0,
            wire_proto=proto,
        ),
        registry=False,
    )
    with driver:
        result = driver.run(w.batches())
        conns = [cc for c in driver._clients for cc in c._conns.values()]
    return np.asarray(result.values), conns


class TestParity:
    @pytest.mark.parametrize("workload", ["mf", "pa"])
    def test_bsp_bitwise_parity_shm_vs_tcp(self, workload):
        """The same BSP run through ``wire_proto="shm"`` equals the
        binary-TCP run BIT FOR BIT: the rings carry the same frames."""
        tables = {}
        for proto in ("auto", "shm"):
            tables[proto], conns = _port_run(workload, proto)
            want = "shm" if proto == "shm" else "tcp"
            assert conns and all(
                getattr(cc, "wire", "tcp") == want for cc in conns
            ), f"{proto} arm rode {[getattr(cc, 'wire', 'tcp') for cc in conns]}"
        assert tables["auto"].tobytes() == tables["shm"].tobytes(), (
            f"{workload}: shm table diverges from the TCP table"
        )


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _records(rng, n, hi):
    return [
        (K_FRAME if i % 3 else K_LINE, rng.bytes(int(size)))
        for i, size in enumerate(rng.integers(1, hi, n))
    ]


class TestCrossPackage:
    def test_same_records_leave_byte_identical_segments(self):
        """The layout pin: one seeded record sequence through each
        package's ring (256 bytes, lapped, wrap markers and implicit
        skips crossed) leaves the two segments equal byte for byte,
        header, indices, record headers and payloads alike."""
        recs = _records(np.random.default_rng(5), 40, 100)
        port, ref = ShmRing.create(256), ref_ring.ShmRing.create(256)
        try:
            for kind, payload in recs:
                for r in (port, ref):
                    r.produce(kind, payload, timeout=1.0)
                    _, view = r.consume(timeout=1.0)
                    assert bytes(view) == payload
                    view = None
                    r.release()
                assert bytes(port.buf) == bytes(ref.buf)
            assert port._wpos == ref._wpos > 4 * 256
        finally:
            for r in (port, ref):
                r.close()
                r.unlink()

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_records_cross_between_the_packages(self, writer):
        """Records one package's ring writes read back byte for byte
        through the other's ``ShmRing`` attached to the same segment,
        a K_WRAP-preceded record among them."""
        mods = {"port": ShmRing, "reference": ref_ring.ShmRing}
        reader = "reference" if writer == "port" else "port"
        w = mods[writer].create(256)
        r = mods[reader].attach(w.name)
        try:
            wrapped = False
            rng = np.random.default_rng(11)
            for i in range(24):
                kind, payload = (K_FRAME, rng.bytes(int(rng.integers(40, 110))))
                off = w._wpos % w.capacity
                need = REC_SIZE + len(payload)
                if w.capacity - off >= REC_SIZE and need > w.capacity - off:
                    wrapped = True  # this record follows a K_WRAP marker
                w.produce(kind, payload, timeout=1.0)
                got_kind, view = r.consume(timeout=1.0)
                assert (got_kind, bytes(view)) == (kind, payload), f"record {i}"
                view = None
                r.release()
                assert w._read_idx(_OFF_TAIL) == r._rpos  # the tail the reader published
            assert wrapped and K_WRAP == ref_ring.K_WRAP
        finally:
            r.close()
            w.close()
            w.unlink()

    @pytest.mark.parametrize("workload", ["mf", "pa"])
    def test_bsp_over_shm_meets_the_cluster_bar_against_the_reference(self, workload):
        got, conns = _port_run(workload, "shm")
        assert all(cc.wire == "shm" for cc in conns)
        w = ref_create_workload(workload, RefParams(**PARITY))
        driver = ref_build_cluster_driver(
            w,
            config=RefConfig(
                num_shards=2, num_workers=1, staleness_bound=0,
                wire_proto="shm",
            ),
            registry=False,
        )
        with driver:
            want = np.asarray(driver.run(w.batches()).values)
            assert all(
                cc.wire == "shm" for c in driver._clients
                for cc in c._conns.values()
            )
        np.testing.assert_allclose(got, want, **CLUSTER_BAR)


class TestWritableViews:
    @pytest.mark.parametrize("cached", [False, True])
    def test_a_later_batch_lapping_the_ring_leaves_earlier_rows(self, cached):
        """Zero-copy frames are writable views of shared memory that the
        pump overwrites after the next batch's release.  A first pull
        batch's rows (and the hot cache's leased rows) must survive a
        second batch whose responses lap the whole response ring."""
        part, shards, servers, addrs = _mini_cluster(n_shards=1, capacity=1024)
        c = None
        try:
            c = ClusterClient(addrs, part, (4,), registry=False, wire_proto="shm",
                              chunk=32)
            conn = ShmShardConnection(addrs[0][0], addrs[0][1], capacity=8192,
                                      registry=False)
            assert conn.proto == "shm"
            c._conns[addrs[0]] = conn
            ids = np.arange(64, dtype=np.int64)
            rng = np.random.default_rng(2)
            c.push_batch(ids, rng.normal(0, 1, (64, 4)).astype(np.float32))
            if cached:
                c.attach_hotcache(HotRowCache(64, registry=False), StaticHotSet(ids))
            first = c.pull_batch(ids)
            kept = first.copy()
            leased = (
                {g: v.copy() for g, v in c.hotcache.lookup(ids).items()}
                if cached else {}
            )
            assert len(leased) == (64 if cached else 0)
            start = conn._s2c._rpos
            # the second batch: other rows, new values, the ring lapped
            others = np.arange(64, 1024, dtype=np.int64)
            c.push_batch(others, rng.normal(0, 1, (others.size, 4)).astype(np.float32))
            second = c.pull_batch(others)
            assert conn._s2c._rpos - start > conn._s2c.capacity
            assert second.shape == (others.size, 4)
            assert first.tobytes() == kept.tobytes()
            if cached:
                assert c.hotcache.fills >= 64
                for g, row in c.hotcache.lookup(ids).items():
                    assert np.asarray(row).tobytes() == leased[g].tobytes()
            assert all(cc.wire == "shm" for cc in c._conns.values())
        finally:
            if c is not None:
                c.close()
            for s in servers:
                s.stop()


# ---------------------------------------------------------------------------
# hygiene: leaks
# ---------------------------------------------------------------------------


_LEAK_SCRIPT = """
import numpy as np
from flink_parameter_server_tpu_torch.cluster.partition import RangePartitioner
from flink_parameter_server_tpu_torch.cluster.shard import ParamShard, ShardServer
from flink_parameter_server_tpu_torch.shmem.channel import ShmShardConnection
from flink_parameter_server_tpu_torch.utils import frames as binf

part = RangePartitioner(32, 1)
shard = ParamShard(0, part, (4,), registry=False, device="cpu")
srv = ShardServer(shard).start()
conn = ShmShardConnection(srv.host, srv.port, registry=False)
assert conn.proto == "shm", conn.proto
req = binf.encode_request(
    binf.VERB_IDS["pull"], ids=np.arange(8, dtype=np.int64)
)
frame = conn.request_many([req])[0]
assert frame.verb_name == "pull"
conn.close()
srv.stop()
print("LEAKCHECK-OK")
"""


@pytest.mark.slow
class TestHygiene:
    def test_no_segment_leak_and_quiet_tracker(self):
        before = set(os.listdir("/dev/shm"))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = REPO
        proc = subprocess.run(
            [sys.executable, "-c", _LEAK_SCRIPT],
            capture_output=True, text=True, timeout=120,
            cwd=REPO, env=env,
        )
        assert proc.returncode == 0, proc.stderr
        assert "LEAKCHECK-OK" in proc.stdout
        assert "resource_tracker" not in proc.stderr, proc.stderr
        leaked = {
            n for n in set(os.listdir("/dev/shm")) - before
            if n.startswith("fps-ring-")
        }
        assert not leaked, leaked
