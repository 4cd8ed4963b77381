"""The port's binary framed transport against the JAX package's.

Mirrors the rest of tests/test_transport.py on the CPU, every shard built
with ``device="cpu"``: the frame codec (``TestFrameCodec``), negotiation
and cross-version compat with an old, pre-binary server
(``TestNegotiationCompat``), what rides the frames: leases and their
``inv=`` piggybacks, trace tokens, NetMeter bytes, priority shedding on the
header, error statuses, raw WAL records (``TestBinaryDataPlane``), the
selectors event loop (``TestEventLoop``) and the elastic driver's refusal
of shard processes.  The shard-process and binary mid-frame tests are in
tests/test_torch_cluster.py; the tooling and committed-artifact tests wait
for the port's tooling and a benchmark cell.

Held against the reference: every codec case feeds both packages'
``utils/frames`` the same seeded arrays and compares the encoded bytes
(and each package decodes the other's frames); the line-vs-binary parity
case compares the port's tables with the reference's bitwise; the served
frames (pull, stats, error answers) are the reference server's byte for
byte where neither carries a wall-clock value.
"""
from __future__ import annotations

import json
import socket
import time

import numpy as np
import pytest

from flink_parameter_server_tpu.cluster.client import ClusterClient as RefClient
from flink_parameter_server_tpu.cluster.partition import RangePartitioner as RefRange
from flink_parameter_server_tpu.cluster.shard import (
    ParamShard as RefShard,
    ShardServer as RefServer,
)
from flink_parameter_server_tpu.resilience import wal as ref_wal
from flink_parameter_server_tpu.utils import frames as ref_binf
from flink_parameter_server_tpu_torch.cluster.client import (
    ClusterClient,
    ShardConnection,
)
from flink_parameter_server_tpu_torch.cluster.partition import RangePartitioner
from flink_parameter_server_tpu_torch.cluster.shard import ParamShard, ShardServer
from flink_parameter_server_tpu_torch.utils import frames as binf

pytestmark = pytest.mark.cluster

CPU = "cpu"
BOTH = (binf, ref_binf)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


class TestFrameCodec:
    def test_request_round_trip_all_fields(self):
        rng = np.random.default_rng(0)
        ids = rng.integers(0, 1 << 40, 7).astype(np.int64)
        rows = rng.normal(0, 1, (7, 4)).astype(np.float32)
        bufs = [
            b.encode_request(
                b.VERB_IDS["push"],
                ids=ids,
                payload=b.rows_to_payload(rows, b.ENC_F32),
                enc=b.ENC_F32,
                epoch=5,
                priority=2,
                tlvs=[(b.T_PID, b"p.1"), (b.T_SESS, b"s.9")],
            )
            for b in BOTH
        ]
        assert bufs[0] == bufs[1]
        for b, buf in zip(BOTH, bufs[::-1]):  # each decodes the other's
            f = b.decode(buf, kind="request")
            assert f.verb_name == "push"
            assert f.aux == 5 and f.flag == 2
            assert np.array_equal(np.asarray(f.ids), ids)
            assert f.tlv_str(b.T_PID) == "p.1"
            assert f.tlv_str(b.T_SESS) == "s.9"
            assert np.array_equal(b.rows_from_payload(f.payload, (4,), f.enc), rows)

    def test_zero_copy_views(self):
        ids = np.arange(64, dtype=np.int64)
        rows = np.ones((64, 2), np.float32)
        buf = binf.encode_request(
            binf.VERB_IDS["push"], ids=ids,
            payload=binf.rows_to_payload(rows, binf.ENC_F32),
        )
        assert buf == ref_binf.encode_request(
            ref_binf.VERB_IDS["push"], ids=ids,
            payload=ref_binf.rows_to_payload(rows, ref_binf.ENC_F32),
        )
        f = binf.decode(buf, kind="request")
        assert f.ids.base is not None  # a view, not a copy
        vals = binf.rows_from_payload(f.payload, (2,), f.enc)
        assert vals.base is not None
        assert not vals.flags.writeable  # read-only over bytes

    def test_response_round_trip_and_error(self):
        payload = np.random.default_rng(1).bytes(12)
        bufs = [
            b.encode_response(
                b.VERB_IDS["pull"], aux=9, n=3, payload=payload, enc=b.ENC_F32,
                tlvs=[(b.T_INV, b"1,2")],
            )
            for b in BOTH
        ]
        assert bufs[0] == bufs[1]
        f = binf.decode(bufs[1], kind="response")
        assert f.flag == binf.STATUS_OK and f.aux == 9 and f.n == 3
        assert f.tlv_str(binf.T_INV) == "1,2" and bytes(f.payload) == payload
        errs = [
            b.error_response(
                b.VERB_IDS["push"], b.STATUS_STALE_EPOCH, "old",
                tlvs=[(b.T_EPOCH, b"4")],
            )
            for b in BOTH
        ]
        assert errs[0] == errs[1]
        err = binf.decode(errs[1], kind="response")
        assert err.status_name == "stale-epoch"
        assert err.tlv_str(binf.T_ERR) == "old"
        assert err.tlv_int(binf.T_EPOCH) == 4

    def test_decode_split_equivalent(self):
        buf = ref_binf.encode_response(
            ref_binf.VERB_IDS["pull"], n=1, payload=b"abcd", enc=ref_binf.ENC_RAW,
        )
        a = binf.decode(buf, kind="response")
        b = binf.decode_split(
            buf[: binf.HEADER_SIZE], buf[binf.HEADER_SIZE:], kind="response",
        )
        assert bytes(a.payload) == bytes(b.payload) == b"abcd"
        assert a.n == b.n and a.flag == b.flag

    def test_bf16_round_trip_truncation(self):
        rows = np.linspace(-3, 3, 64, dtype=np.float32).reshape(16, 4)
        enc = binf.rows_to_payload(rows, binf.ENC_BF16)
        assert enc == ref_binf.rows_to_payload(rows, ref_binf.ENC_BF16)
        got = binf.rows_from_payload(enc, (4,), binf.ENC_BF16)
        assert got.tobytes() == ref_binf.rows_from_payload(enc, (4,), ref_binf.ENC_BF16).tobytes()
        nz = rows != 0
        rel = np.abs(got[nz] - rows[nz]) / np.abs(rows[nz])
        assert float(rel.max()) < 2 ** -7
        assert len(enc) == len(binf.rows_to_payload(rows, binf.ENC_F32)) // 2

    def test_malformed_frames_rejected(self):
        good = binf.encode_request(binf.VERB_IDS["pull"], ids=np.arange(4))
        bad_ver = bytearray(good)
        bad_ver[2] = 9
        hdr = bytearray(good)
        hdr[16:20] = (1 << 20).to_bytes(4, "little")  # n field
        cases = [b"\x00" + good[1:], good[:10], bytes(bad_ver), bytes(hdr), good + b"x"]
        for case in cases:
            for b in BOTH:  # both packages refuse each one
                with pytest.raises(b.FrameError):
                    b.decode(case, kind="request")

    def test_link_helpers(self):
        buf = binf.encode_request(binf.VERB_IDS["lease"], ids=np.arange(2))
        for b in BOTH:
            assert b.peek_is_binary(buf)
            assert not b.peek_is_binary(b"pull 1,2 b64\n")
            assert b.frame_length(buf[:10]) is None
            assert b.frame_length(buf) == len(buf)
            assert b.peek_verb_name(buf) == "lease"
            verb, enc, flag, total = b.peek_header(buf)
            assert verb == b.VERB_IDS["lease"] and total == len(buf)


# ---------------------------------------------------------------------------
# negotiation + cross-version compat
# ---------------------------------------------------------------------------


class _OldShardServer(ShardServer):
    """A PRE-BINARY server: no hello handler, no binary dispatch."""

    def _execute(self, line: str) -> str:
        if line.split()[0].lower() == "hello":
            raise ValueError("unknown command 'hello'")
        return super()._execute(line)

    def respond_frame(self, data):  # pragma: no cover — must not run
        raise AssertionError("old server must never see binary frames")


def _mini_cluster(n_shards=2, *, server_cls=ShardServer, dim=4, capacity=64):
    part = RangePartitioner(capacity, n_shards)
    shards = [
        ParamShard(i, part, (dim,), registry=False, device=CPU)
        for i in range(n_shards)
    ]
    servers = [server_cls(s).start() for s in shards]
    addrs = [(srv.host, srv.port) for srv in servers]
    return part, shards, servers, addrs


class TestNegotiationCompat:
    def test_new_client_new_server_negotiates_binary(self):
        part, shards, servers, addrs = _mini_cluster()
        try:
            c = ClusterClient(addrs, part, (4,), registry=False)
            ids = np.arange(64, dtype=np.int64)
            base = c.pull_batch(ids)
            c.push_batch(ids, np.ones((64, 4), np.float32))
            after = c.pull_batch(ids)
            assert np.array_equal(after, base + 1)
            assert all(cc.proto == "bin" for cc in c._conns.values())
            table = servers[0].conn_table()
            assert table and table[0]["proto"] == "bin"
            assert table[0]["enc"] == "f32"
            resp = c._conns[addrs[0]].request("conns")
            doc = json.loads(resp[3:])
            assert doc[0]["proto"] == "bin"
            c.close()
        finally:
            for s in servers:
                s.stop()

    def test_new_client_old_server_downgrades_to_line(self):
        part, shards, servers, addrs = _mini_cluster(server_cls=_OldShardServer)
        try:
            c = ClusterClient(addrs, part, (4,), registry=False)
            ids = np.arange(64, dtype=np.int64)
            c.push_batch(ids, np.full((64, 4), 2.0, np.float32))
            got = c.pull_batch(ids)
            assert np.array_equal(got, np.full((64, 4), 2.0, np.float32))
            assert all(cc.proto == "line" for cc in c._conns.values())
            c.close()
        finally:
            for s in servers:
                s.stop()

    def test_old_client_new_server_unchanged(self):
        part, shards, servers, addrs = _mini_cluster()
        try:
            c = ClusterClient(addrs, part, (4,), registry=False, wire_proto="line")
            ids = np.arange(64, dtype=np.int64)
            c.push_batch(ids, np.full((64, 4), 3.0, np.float32))
            assert np.array_equal(
                c.pull_batch(ids), np.full((64, 4), 3.0, np.float32)
            )
            table = servers[0].conn_table()
            assert all(t["proto"] == "line" for t in table)
            c.close()
        finally:
            for s in servers:
                s.stop()

    def test_bitwise_parity_line_vs_binary(self):
        """The same pushed deltas land bitwise alike over both framings,
        in the port and in the reference."""
        rng = np.random.default_rng(3)
        deltas = rng.normal(0, 1, (64, 4)).astype(np.float32)
        ids = np.arange(64, dtype=np.int64)
        tables = {}
        for proto in ("line", "auto"):
            part, shards, servers, addrs = _mini_cluster()
            rpart = RefRange(64, 2)
            rservers = [RefServer(RefShard(i, rpart, (4,), registry=False)).start()
                        for i in range(2)]
            try:
                c = ClusterClient(addrs, part, (4,), registry=False, wire_proto=proto)
                rc = RefClient([(s.host, s.port) for s in rservers], rpart, (4,),
                               registry=False, wire_proto=proto)
                for _ in range(3):
                    c.push_batch(ids, deltas)
                    rc.push_batch(ids, deltas)
                tables[proto] = c.pull_batch(ids)
                tables["ref " + proto] = rc.pull_batch(ids)
                c.close()
                rc.close()
            finally:
                for s in servers + rservers:
                    s.stop()
        blobs = {k: v.tobytes() for k, v in tables.items()}
        assert len(set(blobs.values())) == 1, sorted(blobs)


# ---------------------------------------------------------------------------
# everything riding the frames
# ---------------------------------------------------------------------------


class TestBinaryDataPlane:
    def test_lease_and_inv_piggyback_over_binary(self):
        from flink_parameter_server_tpu_torch.hotcache import HotRowCache, StaticHotSet

        part, shards, servers, addrs = _mini_cluster(n_shards=1)
        try:
            reader = ClusterClient(addrs, part, (4,), registry=False)
            reader.attach_hotcache(HotRowCache(8, registry=False), StaticHotSet([1, 2, 3]))
            writer = ClusterClient(addrs, part, (4,), registry=False)
            ids = np.asarray([1, 2, 3], np.int64)
            reader.pull_batch(ids)  # leases granted, cache filled
            assert reader.leases_acquired == 3
            assert shards[0].leases.active_leases() == 3
            writer.push_batch(ids, np.ones((3, 4), np.float32))
            reader.pull_batch(np.asarray([40], np.int64))
            assert reader.hotcache.lookup(ids) == {}  # invalidated
            reader.close()
            writer.close()
        finally:
            for s in servers:
                s.stop()

    def test_trace_tokens_ride_binary_frames(self):
        from flink_parameter_server_tpu_torch.telemetry.spans import SpanTracer

        part, shards, servers, addrs = _mini_cluster(n_shards=1)
        srv_tracer = SpanTracer(process="shard-0")
        servers[0].tracer = srv_tracer
        try:
            client_tracer = SpanTracer(process="client")
            c = ClusterClient(addrs, part, (4,), registry=False, tracer=client_tracer)
            c.pull_batch(np.arange(8, dtype=np.int64))
            assert all(cc.proto == "bin" for cc in c._conns.values())
            client_ids = {
                s["trace_id"] for s in client_tracer.spans()
                if s["name"] == "pull_batch"
            }
            server_spans = [
                s for s in srv_tracer.spans() if s["name"] == "shard.pull"
            ]
            assert server_spans
            assert {s["trace_id"] for s in server_spans} <= client_ids
            c.close()
        finally:
            for s in servers:
                s.stop()

    def test_netmeter_counts_binary_frames(self):
        """The server's byte ledger counts the same bytes for the same
        pull as the reference server's."""
        from flink_parameter_server_tpu.telemetry.registry import MetricsRegistry as RefRegistry
        from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry

        got = {}
        for name, mk in (("port", None), ("ref", RefRegistry)):
            reg = (mk or MetricsRegistry)()
            if name == "port":
                part = RangePartitioner(32, 1)
                srv = ShardServer(ParamShard(0, part, (2,), registry=False, device=CPU))
            else:
                part = RefRange(32, 1)
                srv = RefServer(RefShard(0, part, (2,), registry=False))
            srv.meter._registry = reg  # server-role ledger into this reg
            srv.start()
            try:
                c = (ClusterClient if name == "port" else RefClient)(
                    [(srv.host, srv.port)], part, (2,), registry=False
                )
                c.pull_batch(np.arange(32, dtype=np.int64))
                got[name] = {
                    (i.labels.get("direction"), i.labels.get("verb")): i.value
                    for i in reg.instruments()
                    if i.name == "net_bytes_total"
                }
                c.close()
            finally:
                srv.stop()
        assert got["port"].get(("in", "pull"), 0) > 0
        assert got["port"].get(("out", "pull"), 0) > 0
        assert got["port"] == got["ref"]

    def test_priority_shed_on_header_alone(self):
        from flink_parameter_server_tpu_torch.loadgen.overload import OverloadGuard

        part = RangePartitioner(32, 1)
        shard = ParamShard(0, part, (2,), registry=False, device=CPU)
        srv = ShardServer(
            shard, overload=OverloadGuard(sheddable_depth=1, read_depth=2, registry=False),
        )
        ids = np.arange(4, dtype=np.int64)
        pull2 = binf.encode_request(binf.VERB_IDS["pull"], ids=ids, priority=2)
        push0 = binf.encode_request(
            binf.VERB_IDS["push"], ids=ids,
            payload=binf.rows_to_payload(np.ones((4, 2), np.float32)),
            priority=0,
        )
        with shard._depth_lock:
            shard._active_requests = 5
        try:
            shed = binf.decode(srv.respond_frame(pull2), kind="response")
            assert shed.flag == binf.STATUS_OVERLOADED
            ok = binf.decode(srv.respond_frame(push0), kind="response")
            assert ok.flag == binf.STATUS_OK  # writes never shed
        finally:
            with shard._depth_lock:
                shard._active_requests = 0

    def test_binary_error_mapping(self):
        """Stale-epoch and bad-request answers, byte for byte the
        reference server's."""
        push = binf.encode_request(
            binf.VERB_IDS["push"], ids=np.arange(2),
            payload=binf.rows_to_payload(np.ones((2, 2), np.float32)),
            epoch=0,
        )
        garbage = b"\xb1\xf5garbage-header-bytes...."
        answers = []
        for mine in (True, False):
            if mine:
                shard = ParamShard(0, RangePartitioner(32, 1), (2,), registry=False, device=CPU)
                srv = ShardServer(shard)
            else:
                shard = RefShard(0, RefRange(32, 1), (2,), registry=False)
                srv = RefServer(shard)
            shard.retire(7)  # epoch bumped; everything frozen
            answers.append((srv.respond_frame(push), srv.respond_frame(garbage)))
        assert answers[0] == answers[1]
        resp = binf.decode(answers[0][0], kind="response")
        assert resp.status_name == "stale-epoch"
        assert resp.tlv_int(binf.T_EPOCH) == 7
        bad = binf.decode(answers[0][1], kind="response")
        assert bad.status_name == "bad-request"

    def test_repl_frame_rides_raw_bytes(self):
        from flink_parameter_server_tpu_torch.resilience.wal import (
            decode_frame_bytes,
            encode_frame_bytes,
        )

        payload = {"ids": np.arange(3), "deltas": np.ones((3, 2))}
        raw = encode_frame_bytes(4, 1, payload)
        # the reference reads the port's record, and the port the
        # reference's (pickle bytes may differ between the packages)
        for dec, buf in ((ref_wal.decode_frame_bytes, raw),
                         (decode_frame_bytes, ref_wal.encode_frame_bytes(4, 1, payload))):
            rec = dec(buf)
            assert rec.start_step == 4 and rec.n_steps == 1
            assert np.array_equal(rec.payload["ids"], np.arange(3))
        with pytest.raises(ValueError):
            decode_frame_bytes(raw[:-2])  # CRC must catch truncation


# ---------------------------------------------------------------------------
# the selectors event loop
# ---------------------------------------------------------------------------


class TestEventLoop:
    def test_mixed_framing_pipelined_in_order(self):
        part, shards, servers, addrs = _mini_cluster(n_shards=1)
        try:
            conn = ShardConnection(*addrs[0], negotiate=True)
            assert conn.proto == "bin"
            ids = np.arange(4, dtype=np.int64)
            reqs = [
                binf.encode_request(binf.VERB_IDS["pull"], ids=ids),
                "stats",
                binf.encode_request(binf.VERB_IDS["pull"], ids=ids),
                "flush",
            ]
            resps = conn.request_many(reqs)
            assert isinstance(resps[0], binf.Frame) and resps[0].n == 4
            assert isinstance(resps[1], str) and resps[1].startswith("ok {")
            assert isinstance(resps[2], binf.Frame)
            assert resps[3].startswith("ok pushes=")
            conn.close()
        finally:
            for s in servers:
                s.stop()

    def test_line_overflow_still_answered_and_closed(self):
        part, shards, servers, addrs = _mini_cluster(n_shards=1)
        servers[0].max_line_bytes = 1 << 10
        try:
            with socket.create_connection(addrs[0], timeout=5) as s:
                s.sendall(b"pull " + b"1," * 2000)  # no newline, 4KB+
                s.settimeout(5)
                data = s.recv(1 << 16)
                assert b"err bad-request: line too long" in data
                assert s.recv(1 << 16) == b""  # closed after
        finally:
            for s in servers:
                s.stop()

    def test_binary_overflow_rejected(self):
        part, shards, servers, addrs = _mini_cluster(n_shards=1)
        servers[0].max_line_bytes = 1 << 10
        try:
            huge = binf.encode_request(
                binf.VERB_IDS["push"], ids=np.arange(4), payload=b"\x00" * (1 << 11),
            )
            with socket.create_connection(addrs[0], timeout=5) as s:
                s.sendall(huge)
                s.settimeout(5)
                buf = b""
                while len(buf) < binf.HEADER_SIZE:
                    d = s.recv(1 << 16)
                    if not d:
                        break
                    buf += d
                f = binf.decode(buf[: binf.frame_length(buf)], kind="response")
                assert f.status_name == "bad-request"
        finally:
            for s in servers:
                s.stop()

    def test_stop_joins_dispatchers_and_clears_conns(self):
        part, shards, servers, addrs = _mini_cluster(n_shards=1)
        conns = [ShardConnection(*addrs[0], negotiate=True) for _ in range(4)]
        for c in conns:
            c.request_many([binf.encode_request(binf.VERB_IDS["pull"], ids=np.arange(2))])
        srv = servers[0]
        assert srv.live_connections() == 4
        srv.stop()
        assert srv.live_connections() == 0
        deadline = time.time() + 5
        while time.time() < deadline and any(t.is_alive() for t in srv._handlers):
            time.sleep(0.01)
        assert not any(t.is_alive() for t in srv._handlers)
        for c in conns:
            c.close()

    def test_idle_connection_parks_then_resumes(self):
        part, shards, servers, addrs = _mini_cluster(n_shards=1)
        servers[0].LINGER_S = 0.05
        try:
            conn = ShardConnection(*addrs[0], negotiate=True)
            req = binf.encode_request(binf.VERB_IDS["pull"], ids=np.arange(2))
            first = conn.request_many([req])[0]
            assert first.flag == binf.STATUS_OK
            time.sleep(0.3)  # well past the linger: parked in the selector
            again = conn.request_many([req])[0]
            assert again.flag == binf.STATUS_OK
            assert bytes(again.payload) == bytes(first.payload)
            conn.close()
        finally:
            for s in servers:
                s.stop()


def test_elastic_rejects_shard_procs():
    """Shard processes under the elastic driver raise at start, naming
    the knob, as the reference's do."""
    from flink_parameter_server_tpu.elastic.controller import (
        ElasticClusterConfig as RefElasticConfig,
        ElasticClusterDriver as RefElasticDriver,
    )
    from flink_parameter_server_tpu.models.matrix_factorization import (
        OnlineMatrixFactorization as RefMF,
        SGDUpdater as RefSGD,
    )
    from flink_parameter_server_tpu_torch.elastic.controller import (
        ElasticClusterConfig,
        ElasticClusterDriver,
    )
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization,
        SGDUpdater,
    )

    errors = []
    for mine in (True, False):
        if mine:
            driver = ElasticClusterDriver(
                OnlineMatrixFactorization(8, 2, updater=SGDUpdater(0.05), device=CPU),
                capacity=16, value_shape=(2,),
                config=ElasticClusterConfig(num_shards=1, num_workers=1, shard_procs=True),
                registry=False, device=CPU,
            )
        else:
            driver = RefElasticDriver(
                RefMF(8, 2, updater=RefSGD(0.05)), capacity=16, value_shape=(2,),
                config=RefElasticConfig(num_shards=1, num_workers=1, shard_procs=True),
                registry=False,
            )
        with pytest.raises(NotImplementedError, match="shard_procs") as e:
            driver.start()
        driver.stop()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
