"""The port's quantized delta path (``compression/``) against the JAX
package's: the codecs, error feedback, the combiner's merge, the quantized
wire and its negotiation matrix, quantized replication legs and the
driver's aggregation tree and BSP carve-out.

The codecs are host numpy in both packages, so the port's outputs are held
BITWISE against the reference's on the same seeded inputs.  Tables that go
through the wire are host float32 arithmetic on CPU shards (the port with
``device="cpu"``): the quantized runs are held bitwise against the
reference's shard fed the same pushes, and the drivers' MF tables within
rtol 1e-4 / atol 1e-6 (the reference's cluster bar) of the reference's
cluster on the same stream.

Mirrors tests/test_compression.py's TestQ8Codec (6), TestErrorFeedback (5),
TestAggregateBatches (2), TestQuantizedWire (4), TestQuantizedReplication
(2), TestDriverIntegration (3) and TestTornQuantizedFrames (the corpus's
mid-frame RST schedules over q8, on the port's nemesis runner with
``device="cpu"``).  TestTooling waits for psctl, the lint and the
benchmark artifacts (ROADMAP Queue 1 #7h).
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.cluster import ClusterConfig as RefClusterConfig
from flink_parameter_server_tpu.cluster import ClusterDriver as RefClusterDriver
from flink_parameter_server_tpu.cluster import ParamShard as RefParamShard
from flink_parameter_server_tpu.cluster import RangePartitioner as RefRange
from flink_parameter_server_tpu.cluster import ShardServer as RefShardServer
from flink_parameter_server_tpu.cluster.client import ClusterClient as RefClusterClient
from flink_parameter_server_tpu.compression import quantizers as ref_q
from flink_parameter_server_tpu.data.movielens import synthetic_ratings as ref_ratings
from flink_parameter_server_tpu.data.streams import microbatches as ref_microbatches
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.ops import dedup as ref_dedup
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch import telemetry as tm
from flink_parameter_server_tpu_torch.cluster.client import ClusterClient, ShardConnection
from flink_parameter_server_tpu_torch.cluster.driver import ClusterConfig, ClusterDriver
from flink_parameter_server_tpu_torch.cluster.partition import RangePartitioner
from flink_parameter_server_tpu_torch.cluster.shard import ParamShard, ShardServer
from flink_parameter_server_tpu_torch.compression.quantizers import (
    MAX_Q8_ROWS,
    DeltaCompressor,
    ResidualStore,
    bf16_roundtrip,
    dequantize_q8,
    q8_from_payload,
    q8_payload,
    quantize_q8,
)
from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
from flink_parameter_server_tpu_torch.data.streams import microbatches
from flink_parameter_server_tpu_torch.models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
)
from flink_parameter_server_tpu_torch.ops.dedup import (
    aggregate_delta_batches,
    aggregate_deltas,
)
from flink_parameter_server_tpu_torch.replication.failover import verify_against_log
from flink_parameter_server_tpu_torch.replication.follower import ReplicaShard
from flink_parameter_server_tpu_torch.replication.shipper import (
    ReplHub,
    WALShipper,
    _FollowerQueue,
)
from flink_parameter_server_tpu_torch.utils import frames as binf
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

torch.set_num_threads(2)

pytestmark = pytest.mark.compression

CPU = "cpu"
BAR = dict(rtol=1e-4, atol=1e-6)  # the reference's cluster parity bar


@pytest.fixture()
def fresh_registry():
    reg = tm.MetricsRegistry(run_id="test-torch-compression")
    tm.set_registry(reg)
    yield reg
    tm.set_registry(None)


def _mini_cluster(n_shards=2, *, server_cls=ShardServer, dim=4, capacity=64, wal_dir=None):
    part = RangePartitioner(capacity, n_shards)
    shards = [
        ParamShard(i, part, (dim,), registry=False, device=CPU,
                   wal_dir=None if wal_dir is None else f"{wal_dir}/s{i}")
        for i in range(n_shards)
    ]
    servers = [server_cls(s).start() for s in shards]
    return part, shards, servers, [(srv.host, srv.port) for srv in servers]


def _ref_mini_cluster(n_shards=2, *, dim=4, capacity=64):
    part = RefRange(capacity, n_shards)
    shards = [RefParamShard(i, part, (dim,), registry=False) for i in range(n_shards)]
    servers = [RefShardServer(s).start() for s in shards]
    return part, shards, servers, [(srv.host, srv.port) for srv in servers]


# ---------------------------------------------------------------------------
# codec units
# ---------------------------------------------------------------------------


class TestQ8Codec:
    def test_round_trip_error_bound(self):
        rng = np.random.default_rng(0)
        rows = rng.normal(0, 0.01, (128, 16)).astype(np.float32)
        q, scales = quantize_q8(rows)
        dq = dequantize_q8(q, scales, (16,))
        # bitwise the reference's codec on the same rows
        rq, rs = ref_q.quantize_q8(rows)
        assert np.array_equal(q, rq) and np.array_equal(scales, rs)
        assert np.array_equal(dq, ref_q.dequantize_q8(rq, rs, (16,)))
        # per-row error bounded by half a granule (scale/2)
        assert np.all(np.abs(dq - rows) <= scales[:, None] / 2 + 1e-9)
        p, sb = q8_payload(rows)
        assert (p, sb) == ref_q.q8_payload(rows)
        assert np.array_equal(q8_from_payload(p, sb, (16,)), dq)
        assert len(p) == rows.size
        assert len(sb) == 4 * len(rows)

    def test_zero_rows_and_shapes(self):
        rows = np.zeros((4, 8), np.float32)
        q, scales = quantize_q8(rows)
        assert np.all(scales == 0)
        assert np.array_equal(dequantize_q8(q, scales, (8,)), rows)
        flat = np.asarray([0.5, -0.25, 0.0], np.float32)
        q, s = quantize_q8(flat)
        assert dequantize_q8(q, s, ()).shape == (3,)
        rq, rs = ref_q.quantize_q8(flat)
        assert np.array_equal(q, rq) and np.array_equal(s, rs)

    def test_non_finite_rejected(self):
        bad = np.asarray([[1.0, np.nan]], np.float32)
        for quant in (quantize_q8, ref_q.quantize_q8):
            with pytest.raises(ValueError, match="non-finite"):
                quant(bad)

    def test_oversized_frame_rejected(self):
        assert MAX_Q8_ROWS == ref_q.MAX_Q8_ROWS
        with pytest.raises(ValueError, match="chunk"):
            q8_payload(np.zeros((MAX_Q8_ROWS + 1, 1), np.float32))

    def test_bad_payloads_rejected(self):
        with pytest.raises(ValueError, match="T_SCALE"):
            q8_from_payload(b"\x01\x02", None, (2,))
        with pytest.raises(ValueError, match="tile"):
            q8_from_payload(b"\x01\x02\x03", b"\x00" * 4, (2,))

    def test_bf16_roundtrip_matches_wire_codec(self):
        rng = np.random.default_rng(1)
        rows = rng.normal(0, 1, (32, 4)).astype(np.float32)
        host = bf16_roundtrip(rows)
        wire = binf.rows_from_payload(binf.rows_to_payload(rows, binf.ENC_BF16), (4,), binf.ENC_BF16)
        assert np.array_equal(host, wire)
        assert np.array_equal(host, ref_q.bf16_roundtrip(rows))
        assert np.array_equal(bf16_roundtrip(host), host)


# ---------------------------------------------------------------------------
# error-feedback residual properties (the convergence contract)
# ---------------------------------------------------------------------------


class TestErrorFeedback:
    def _stream(self, rounds, n, dim, seed):
        rng = np.random.default_rng(seed)
        return [rng.normal(0, 0.01, (n, dim)).astype(np.float32) for _ in range(rounds)]

    @pytest.mark.parametrize("enc", ["q8", "bf16"])
    def test_feedback_converges_to_fp32_oracle(self, enc):
        """After any number of rounds the delivered sum trails the true
        fp32 sum by at most ONE granule per id, and every delivered
        delta is bitwise the reference compressor's."""
        n, dim = 40, 8
        ids = np.arange(n)
        comp, ref = DeltaCompressor(enc), ref_q.DeltaCompressor(enc)
        oracle = np.zeros((n, dim), np.float32)
        table = np.zeros((n, dim), np.float32)
        granule = 0.0
        for d in self._stream(300, n, dim, seed=7):
            oracle += d
            delivered, q, scales = comp.compress(ids, d)
            assert np.array_equal(delivered, ref.compress(ids, d)[0])
            table += delivered
            if scales is not None:
                granule = max(granule, float(scales.max()))
        err = float(np.abs(table - oracle).max())
        if enc == "q8":
            assert err <= granule + 1e-6
        rel = err / float(np.sqrt(np.mean(oracle ** 2)))
        assert rel < 0.02

    def test_feedback_beats_no_feedback(self):
        n, dim = 32, 4
        ids = np.arange(n)
        comp = DeltaCompressor("q8")
        oracle = np.zeros((n, dim), np.float32)
        with_fb = np.zeros((n, dim), np.float32)
        without = np.zeros((n, dim), np.float32)
        rng = np.random.default_rng(11)
        for _ in range(300):
            d = np.abs(rng.normal(0, 0.004, (n, dim))).astype(np.float32)
            d[0] = 1.0
            oracle += d
            delivered, _, _ = comp.compress(ids, d)
            with_fb += delivered
            q, s = quantize_q8(d)
            without += dequantize_q8(q, s, (dim,))
        assert np.abs(with_fb - oracle).max() < np.abs(without - oracle).max()

    def test_combine_orders_both_converge(self):
        """Combine-then-quantize and quantize-then-combine-with-residuals
        both land within the documented bound of the fp32 oracle."""
        n, dim, workers = 24, 4, 3
        ids = np.arange(n)
        rng = np.random.default_rng(13)
        oracle = np.zeros((n, dim), np.float32)
        combined_then_q = np.zeros((n, dim), np.float32)
        q_then_combined = np.zeros((n, dim), np.float32)
        uplink = DeltaCompressor("q8")
        per_worker = [DeltaCompressor("q8") for _ in range(workers)]
        granule = 0.0
        for _ in range(200):
            ds = [rng.normal(0, 0.01, (n, dim)).astype(np.float32) for _ in range(workers)]
            oracle += np.sum(ds, axis=0, dtype=np.float32)
            uq, summed = aggregate_delta_batches([(ids, d) for d in ds])
            assert np.array_equal(uq, ids)
            delivered, _, s = uplink.compress(uq, summed.astype(np.float32))
            combined_then_q += delivered
            if s is not None:
                granule = max(granule, float(s.max()))
            for w, d in enumerate(ds):
                dlv, _, s = per_worker[w].compress(ids, d)
                q_then_combined += dlv
                if s is not None:
                    granule = max(granule, float(s.max()))
        assert np.abs(combined_then_q - oracle).max() <= granule + 1e-6
        assert np.abs(q_then_combined - oracle).max() <= workers * granule + 1e-6

    def test_residual_store_take_put_norm(self):
        for rs in (ResidualStore(), ref_q.ResidualStore()):
            ids = np.asarray([3, 5])
            rs.put(ids, np.asarray([[1.0, 0.0], [0.5, 0.5]], np.float32))
            assert len(rs) == 2 and rs.norm() > 0
            taken = rs.take(np.asarray([5, 9]), 2)
            assert np.array_equal(taken, np.asarray([[0.5, 0.5], [0.0, 0.0]], np.float32))
            assert len(rs) == 1
            rs.clear()
            assert len(rs) == 0 and rs.norm() == 0.0


# ---------------------------------------------------------------------------
# ops/dedup.aggregate_delta_batches (the combiner's merge step)
# ---------------------------------------------------------------------------


class TestAggregateBatches:
    def test_equals_concatenated_aggregate(self):
        rng = np.random.default_rng(3)
        batches = []
        all_ids, all_d = [], []
        for _ in range(4):
            ids = rng.integers(0, 32, 50).astype(np.int64)
            d = rng.normal(0, 1, (50, 3)).astype(np.float32)
            batches.append((ids, d))
            all_ids.append(ids)
            all_d.append(d)
        uq, summed = aggregate_delta_batches(batches)
        uq2, summed2 = aggregate_deltas(np.concatenate(all_ids), np.concatenate(all_d))
        assert np.array_equal(uq, uq2) and np.array_equal(summed, summed2)
        ruq, rsummed = ref_dedup.aggregate_delta_batches(batches)
        assert np.array_equal(uq, ruq) and np.array_equal(summed, rsummed)

    def test_masks_and_empties(self):
        ids = np.asarray([1, 2, 3])
        d = np.ones((3, 2), np.float32)
        mask = np.asarray([True, False, True])
        uq, summed = aggregate_delta_batches([
            (ids, d, mask),
            None,
            (np.empty(0, np.int64), np.empty((0, 2), np.float32)),
            (ids, d, np.zeros(3, bool)),
        ])
        assert uq.tolist() == [1, 3]
        assert np.array_equal(summed, np.ones((2, 2), np.float32))
        uq, summed = aggregate_delta_batches([])
        assert uq.size == 0


# ---------------------------------------------------------------------------
# the wire: q8 e2e + the negotiation matrix
# ---------------------------------------------------------------------------


class _OldBinServer(ShardServer):
    """A binary server from before the quantized encodings: answers the
    hello WITHOUT the enc token."""

    def _execute(self, line: str) -> str:
        toks = line.split()
        if toks and toks[0].lower() == "hello":
            return binf.HELLO_OK
        return super()._execute(line)


class _OldLineServer(ShardServer):
    """A pre-binary server: no hello at all."""

    def _execute(self, line: str) -> str:
        if line.split()[0].lower() == "hello":
            raise ValueError("unknown command 'hello'")
        return super()._execute(line)

    def respond_frame(self, data):  # pragma: no cover — must not run
        raise AssertionError("old server must never see binary frames")


def _push_stream(client, capacity, dim, rounds=20, seed=2):
    ids = np.arange(capacity, dtype=np.int64)
    rng = np.random.default_rng(seed)
    oracle = np.zeros((capacity, dim), np.float32)
    for _ in range(rounds):
        d = rng.normal(0, 0.01, (capacity, dim)).astype(np.float32)
        oracle += d
        client.push_batch(ids, d)
    return oracle


def _ref_pushed_table(dim, rounds, seed, wire_format):
    """The reference's client and shards fed the same push stream."""
    part, shards, servers, addrs = _ref_mini_cluster(dim=dim)
    try:
        c = RefClusterClient(addrs, part, (dim,), registry=False, wire_format=wire_format)
        _push_stream(c, 64, dim, rounds=rounds, seed=seed)
        got = c.pull_batch(np.arange(64, dtype=np.int64))
        c.close()
        return got
    finally:
        for s in servers:
            s.stop()


class TestQuantizedWire:
    def test_q8_e2e_bytes_saved_and_rmse(self, fresh_registry):
        part, shards, servers, addrs = _mini_cluster(dim=8)
        try:
            c = ClusterClient(addrs, part, (8,), registry=fresh_registry, wire_format="q8", worker="w0")
            oracle = _push_stream(c, 64, 8)
            got = c.pull_batch(np.arange(64, dtype=np.int64))
            assert np.abs(got - oracle).max() < 5e-4
            # bitwise the reference's client and shards on the same stream
            assert np.array_equal(got, _ref_pushed_table(8, 20, 2, "q8"))
            conn = next(iter(c._conns.values()))
            assert conn.proto == "bin" and "q8" in conn.encs
            c.push_batch(np.arange(64, dtype=np.int64), np.full((64, 8), 1e-3, np.float32))
            table = servers[0].conn_table()
            assert table and table[0]["enc"] == "q8"
            snap = fresh_registry.snapshot()
            saved = sum(int(i["value"] or 0) for i in snap.get("compression_bytes_saved_total", []))
            assert saved > 0
            norms = snap.get("compression_residual_norm", [])
            assert norms and norms[0]["value"] is not None
            c.close()
        finally:
            for s in servers:
                s.stop()

    def test_negotiation_matrix_identical_tables(self):
        """Every downgrade cell delivers the SAME table: the client
        applies dequantized rows whatever the framing."""
        tables = {}
        for label, cls, wire_proto in (
            ("new", ShardServer, "auto"),
            ("old-bin", _OldBinServer, "auto"),
            ("old-line", _OldLineServer, "auto"),
            ("line-pinned", ShardServer, "line"),
        ):
            part, shards, servers, addrs = _mini_cluster(dim=4, server_cls=cls)
            try:
                c = ClusterClient(addrs, part, (4,), registry=False, wire_format="q8", wire_proto=wire_proto)
                _push_stream(c, 64, 4, rounds=8)
                tables[label] = c.pull_batch(np.arange(64, dtype=np.int64))
                conn = next(iter(c._conns.values()))
                if label == "new":
                    assert "q8" in conn.encs
                elif label == "old-bin":
                    assert conn.proto == "bin"
                    assert conn.encs == binf.LEGACY_BIN_ENCS
                else:
                    assert conn.proto == "line"
                c.close()
            finally:
                for s in servers:
                    s.stop()
        base = tables.pop("new")
        for label, t in tables.items():
            assert np.array_equal(t, base), label
        assert np.array_equal(base, _ref_pushed_table(4, 8, 2, "q8"))

    def test_q8_frame_missing_scales_is_bad_request(self):
        part, shards, servers, addrs = _mini_cluster(dim=4)
        try:
            conn = ShardConnection(*addrs[0], negotiate=True)
            req = binf.encode_request(
                binf.VERB_IDS["push"], ids=np.arange(4, dtype=np.int64),
                payload=b"\x00" * 16, enc=binf.ENC_Q8,
            )
            resp = conn.request_many([req])[0]
            assert resp.flag == binf.STATUS_BAD_REQUEST
            assert "T_SCALE" in (resp.tlv_str(binf.T_ERR) or "")
            conn.close()
        finally:
            for s in servers:
                s.stop()

    def test_bf16_push_round_trip_and_repl_ship(self, tmp_path):
        """A bf16 push round-trips end to end AND the resulting WAL
        records (exact post-truncation f32) ship to a follower bitwise."""
        part, shards, servers, addrs = _mini_cluster(n_shards=1, dim=4, wal_dir=str(tmp_path / "wal"))
        try:
            c = ClusterClient(addrs, part, (4,), registry=False, wire_format="bf16")
            oracle = _push_stream(c, 64, 4, rounds=12, seed=9)
            got = c.pull_batch(np.arange(64, dtype=np.int64))
            assert np.abs(got - oracle).max() < 1e-3
            conn = next(iter(c._conns.values()))
            assert conn.proto == "bin" and "bf16" in conn.encs
            follower = ReplicaShard(0, part, (4,), wal_dir=str(tmp_path / "fwal"), registry=False,
                                    device=CPU)
            fsrv = ShardServer(follower).start()
            hub = ReplHub()
            ship = WALShipper(shards[0], (fsrv.host, fsrv.port), hub.subscribe(), registry=False).start()
            head = shards[0].head_seq()
            deadline = time.time() + 30
            while ship.acked_seq < head and time.time() < deadline:
                time.sleep(0.01)
            while follower.apply_lag() > 0 and time.time() < deadline:
                time.sleep(0.01)
            assert np.array_equal(follower.values(), shards[0].values())
            ship.stop()
            fsrv.stop()
            follower.close()
            c.close()
        finally:
            for s in servers:
                s.stop()


# ---------------------------------------------------------------------------
# quantized replication legs
# ---------------------------------------------------------------------------


class TestQuantizedReplication:
    def test_q8_leg_tracks_within_granule_and_replays_bitwise(self, tmp_path):
        part = RangePartitioner(64, 1)
        primary = ParamShard(0, part, (8,), wal_dir=str(tmp_path / "p"), registry=False, device=CPU)
        rng = np.random.default_rng(3)
        ids = np.arange(64, dtype=np.int64)
        for _ in range(30):
            primary.push(ids, rng.normal(0, 0.01, (64, 8)).astype(np.float32))
        follower = ReplicaShard(0, part, (8,), wal_dir=str(tmp_path / "f"), registry=False, device=CPU)
        srv = ShardServer(follower).start()
        hub = ReplHub()
        ship = WALShipper(primary, (srv.host, srv.port), hub.subscribe(), registry=False, enc="q8").start()
        try:
            head = primary.head_seq()
            deadline = time.time() + 30
            while ship.acked_seq < head and time.time() < deadline:
                time.sleep(0.01)
            while follower.apply_lag() > 0 and time.time() < deadline:
                time.sleep(0.01)
            err = float(np.abs(follower.values() - primary.values()).max())
            assert 0 < err < 5e-3  # tracks, NOT bitwise (documented)
            assert ship.repl_bytes_saved > 0
            # the leg's records are the reference's quantization of the
            # same log: its dequantized deltas, summed in order, give the
            # follower's table bitwise
            comp = ref_q.DeltaCompressor("q8")
            table = np.zeros((64, 8), np.float32)
            for rec in primary.repl_backlog(-1):
                out, _, _ = ref_q.compress_record_payload(rec.payload, comp)
                table[rec.payload["ids"]] += ref_q.record_deltas(out)
            assert np.array_equal(follower.values(), table)
            # promotion path: catch up, promote, then a restart REPLAYS
            # the quantized log bitwise (record_deltas is deterministic)
            follower.catch_up()
            follower.promote_to_primary(1)
            before = follower.values().copy()
            follower.restart()
            assert np.array_equal(follower.values(), before)
            assert verify_against_log(follower)
        finally:
            ship.stop()
            srv.stop()
            follower.close()
            primary.close()

    def test_invalid_enc_rejected(self):
        with pytest.raises(ValueError, match="enc"):
            WALShipper(None, ("127.0.0.1", 1), _FollowerQueue(), registry=False, enc="zstd")


# ---------------------------------------------------------------------------
# driver integration: aggregation tree + BSP carve-out
# ---------------------------------------------------------------------------


def _mf_driver(wire_format, push_aggregate, num_workers, registry=False):
    cols = synthetic_ratings(48, 64, 6 * 64, seed=3)
    batches = list(microbatches(cols, 64))
    logic = OnlineMatrixFactorization(48, 4, updater=SGDUpdater(0.05), seed=1, device=CPU)
    driver = ClusterDriver(
        logic, capacity=64, value_shape=(4,), init_fn=ranged_random_factor(7, (4,)),
        config=ClusterConfig(num_shards=2, num_workers=num_workers, staleness_bound=0,
                             wire_format=wire_format, push_aggregate=push_aggregate),
        registry=registry, device=CPU,
    )
    return driver, batches


def _ref_mf_table(wire_format, push_aggregate, num_workers):
    cols = ref_ratings(48, 64, 6 * 64, seed=3)
    logic = ref_mf.OnlineMatrixFactorization(48, 4, updater=ref_mf.SGDUpdater(0.05), seed=1)
    driver = RefClusterDriver(
        logic, capacity=64, value_shape=(4,), init_fn=ref_init(7, (4,)),
        config=RefClusterConfig(num_shards=2, num_workers=num_workers, staleness_bound=0,
                                wire_format=wire_format, push_aggregate=push_aggregate),
        registry=False,
    )
    with driver:
        return np.asarray(driver.run(list(ref_microbatches(cols, 64))).values)


class TestDriverIntegration:
    def test_aggregation_tree_one_push_per_shard_per_round(self, fresh_registry):
        """The tree: push frames ÷ num_workers, parity with the flat run
        and with the reference's tree, and the exactly-once ledger
        balances on the uplink."""
        results = {}
        for label, agg in (("flat", False), ("tree", True)):
            reg = tm.MetricsRegistry(run_id=f"agg-{label}")
            tm.set_registry(reg)
            driver, batches = _mf_driver("b64", agg, 4, registry=reg)
            with driver:
                values = driver.run(batches).values
                acked = sum(c.rows_pushed for c in driver._clients)
                pa = driver.last_push_aggregator
                if pa is not None:
                    acked += pa.client.rows_pushed
                applied = sum(sh.rows_applied for sh in driver.shards)
            frames = 0
            for inst in reg.snapshot().get("net_frames_total", []):
                lb = inst["labels"]
                if lb.get("verb") == "push" and lb.get("direction") == "out" and lb.get("role") == "client":
                    frames += int(inst["value"] or 0)
            results[label] = {"values": values, "frames": frames, "acked": acked, "applied": applied,
                              "fanin": None if pa is None else pa.last_fanin}
        flat, tree = results["flat"], results["tree"]
        assert tree["frames"] * 4 == flat["frames"]
        assert tree["acked"] == tree["applied"] > 0
        assert flat["acked"] == flat["applied"]
        assert np.allclose(flat["values"], tree["values"], atol=1e-4, rtol=1e-4)
        assert results["tree"]["fanin"] >= 1
        tm.set_registry(None)
        assert np.allclose(tree["values"], _ref_mf_table("b64", True, 4), **BAR)

    def test_bsp_carveout_bitwise(self):
        """The bound-0 arm configured "q8" lands BITWISE identical to
        "b64" — worker clients are downgraded to exact fp32 — and at the
        cluster bar of the reference's run."""
        tables = {}
        for wf in ("q8", "b64"):
            driver, batches = _mf_driver(wf, False, 1)
            with driver:
                tables[wf] = driver.run(batches).values
                assert driver._clients[0]._compressor is None
        assert np.array_equal(tables["q8"], tables["b64"])
        assert np.allclose(tables["q8"], _ref_mf_table("q8", False, 1), **BAR)

    def test_non_bsp_driver_keeps_quantization(self):
        driver = ClusterDriver(
            OnlineMatrixFactorization(8, 4, updater=SGDUpdater(0.05), device=CPU),
            capacity=64, value_shape=(4,),
            config=ClusterConfig(num_shards=1, num_workers=1, staleness_bound=2, wire_format="q8"),
            registry=False, device=CPU,
        )
        with driver:
            assert driver._clients[0]._compressor is not None


# ---------------------------------------------------------------------------
# the mid-frame-RST corpus schedules over a quantized-enc connection
# ---------------------------------------------------------------------------


class TestTornQuantizedFrames:
    @pytest.mark.parametrize(
        "name", ["mid_frame_rst_pull", "mid_frame_rst_push"]
    )
    def test_corpus_schedule_replays_green_over_q8(
        self, name, tmp_path
    ):
        """The committed mid-frame-RST schedules replayed with a QUANTIZED
        enc negotiated — a torn quantized frame (cut inside the header or
        the int8 payload) must dedupe exactly like f32: exactly-once
        ledger balanced, zero run errors.  Parity is off because the
        quantized arm needs a non-zero bound (the BSP carve-out would
        downgrade it to fp32)."""
        from flink_parameter_server_tpu_torch.nemesis import (
            load_corpus,
            run_scenario,
        )

        corpus = {s.name: s for s in load_corpus()}
        s = dataclasses.replace(
            corpus[name],
            name=f"{name}-q8",
            wire_format="q8",
            staleness_bound=2,
            parity=False,
        )
        report = run_scenario(s, wal_root=str(tmp_path), device=CPU)
        bad = [v for v in report.verdicts if not v.ok]
        assert report.ok, bad
        names = {v.name for v in report.verdicts}
        assert "exactly_once_ledger" in names
