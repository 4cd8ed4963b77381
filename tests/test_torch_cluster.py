"""The port's parameter-server cluster against the JAX package's.

Parity (the same seeded numpy inputs through both packages, the port on
``device="cpu"``):
  * the partitioners: ``shard_of``, ``owned_ids``, ``to_local`` and
    ``block_aligned`` equal as integers over capacities {1, 8, 97, 1000,
    131072} x shards 1-8, range and hash;
  * the host dedup, ``format_rows`` / ``parse_rows`` (text and b64) and
    the q8 / bf16 quantizers: byte-equal output;
  * a ``ParamShard`` of each package fed the same pushes of unique ids:
    bitwise-equal tables, and so after crash -> restart WAL replay;
  * ``ClusterDriver`` BSP, 4 shards x 2 workers, range and hash: within
    rtol 1e-4 / atol 1e-6 of the reference's cluster and of the port's
    single-process table (the reference's own bar: host aggregation
    ``row + (d1 + d2)`` and the single-process scatter ``(row + d1) + d2``
    reassociate); at 1 worker within the port's MF parity tolerance (rtol
    1e-5 / atol 1e-6, tests/test_torch_driver.py) of the reference.

Mirrors: every test of tests/test_cluster.py (32, 33 cases; the SSP test reads the
staleness gauge off the registry, since the telemetry endpoint is not
ported), the five properties of tests/test_cluster_properties.py (the
epoch-transition one computes the ownership diff itself: the elastic
planner is not ported), and tests/test_transport.py's shard-process tests
(proc-vs-thread parity, kill and respawn over the WAL, the spawn grace
window) and its binary mid-frame RST tests (through the port's
``nemesis.ChaosProxy``), and tests/test_loadgen.py's shard-edge overload
tests with its breaker test.  Knobs whose modules wait for ROADMAP Queue 1 #7 raise
``NotImplementedError``; each is held here (``xfer`` / ``load``, epoch
fencing and the ``pid=`` window came back with elastic/ and are held in
tests/test_torch_elastic.py; ``lease`` / ``revoke`` and ``hot_cache`` came
back with hotcache/ and are held in tests/test_torch_hotcache.py).
"""
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from flink_parameter_server_tpu.cluster import (
    ClusterConfig as RefConfig,
    ClusterDriver as RefDriver,
    ConsistentHashPartitioner as RefHash,
    ParamShard as RefShard,
    RangePartitioner as RefRange,
)
from flink_parameter_server_tpu.cluster import shard as ref_shard
from flink_parameter_server_tpu.compression import quantizers as ref_q
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.ops import dedup as ref_dedup
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch.cluster import (
    ClusterClient,
    ClusterConfig,
    ClusterDriver,
    ConsistentHashPartitioner,
    ParamShard,
    RangePartitioner,
    ShardServer,
    StalenessClock,
)
from flink_parameter_server_tpu_torch.cluster.procs import (
    ShardProcess,
    ShardProcSpec,
    as_torch_init,
    resolve_init,
)
from flink_parameter_server_tpu_torch.cluster.shard import format_rows, parse_rows
from flink_parameter_server_tpu_torch.compression import quantizers as q
from flink_parameter_server_tpu_torch.core.store import ShardedParamStore, push as store_push
from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
from flink_parameter_server_tpu_torch.data.streams import microbatches
from flink_parameter_server_tpu_torch.loadgen.overload import BreakerBoard, OverloadedError, OverloadGuard
from flink_parameter_server_tpu_torch.models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
)
from flink_parameter_server_tpu_torch.ops import dedup
from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
from flink_parameter_server_tpu_torch.training.driver import DriverConfig, StreamingDriver
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor
from flink_parameter_server_tpu_torch.utils.net import request_lines

torch.set_num_threads(2)

pytestmark = pytest.mark.cluster

BAR = dict(rtol=1e-4, atol=1e-6)  # the reference's cluster parity bar
MF_TOL = dict(rtol=1e-5, atol=1e-6)  # the port's MF parity tolerance
CPU = "cpu"


def _init_rows(init, ids):
    return init(torch.as_tensor(np.asarray(ids), dtype=torch.int32)).numpy()


# ---------------------------------------------------------------------------
# partitioners: equal to the reference's as integers
# ---------------------------------------------------------------------------


def _same_map(p, r, capacity, n):
    ids = np.arange(capacity)
    assert np.array_equal(p.shard_of(ids), r.shard_of(ids))
    for s in range(n):
        owned = p.owned_ids(s)
        assert np.array_equal(owned, r.owned_ids(s))
        if len(owned):
            assert np.array_equal(p.to_local(s, owned), r.to_local(s, owned))


@pytest.mark.parametrize("capacity", [1, 8, 97, 1000, 131072])
@pytest.mark.parametrize("kind", ["range", "hash"])
def test_partitioners_match_the_reference(capacity, kind):
    for n in range(1, 9):
        if kind == "range":
            if n > capacity:
                for cls in (RangePartitioner, RefRange):
                    with pytest.raises(ValueError):
                        cls(capacity, n)
                continue
            p, r = RangePartitioner(capacity, n), RefRange(capacity, n)
            _same_map(p, r, capacity, n)
            for devices in (1, 2, 8):
                pa, ra = p.block_aligned(devices), r.block_aligned(devices)
                assert pa.rows_per_shard == ra.rows_per_shard
                assert pa.aligned_block == ra.aligned_block
                _same_map(pa, ra, capacity, n)
        else:
            for seed in (0, 7):
                p = ConsistentHashPartitioner(capacity, n, seed=seed)
                _same_map(p, RefHash(capacity, n, seed=seed), capacity, n)


# ---------------------------------------------------------------------------
# the host half: dedup, wire rows, quantizers — byte-equal
# ---------------------------------------------------------------------------


def test_host_dedup_matches_the_reference():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 40, (6, 16))
    mask = rng.random((6, 16)) < 0.7
    deltas = rng.normal(size=(6, 16, 3)).astype(np.float32)
    for m in (None, mask):
        for a, b in zip(dedup.coalesce_ids(ids, m), ref_dedup.coalesce_ids(ids, m)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for a, b in zip(dedup.aggregate_deltas(ids, deltas, m),
                        ref_dedup.aggregate_deltas(ids, deltas, m)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    entries = [(ids[0], deltas[0]), None, (ids[1], deltas[1], mask[1]), (ids[2][:0], deltas[2][:0])]
    for a, b in zip(dedup.aggregate_delta_batches(entries), ref_dedup.aggregate_delta_batches(entries)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_wire_rows_match_the_reference():
    rng = np.random.default_rng(1)
    for shape in ((17, 5), (9,), (4, 2, 3)):
        rows = rng.normal(size=shape).astype(np.float32)
        rows[0] = -0.0
        for enc in ("text", "b64"):
            body = format_rows(rows, enc)
            assert body == ref_shard.format_rows(rows, enc)
            vs = shape[1:] if len(shape) > 1 else ()
            got = parse_rows(body, vs)
            assert got.tobytes() == ref_shard.parse_rows(body, vs).tobytes()


def test_quantizers_match_the_reference():
    rng = np.random.default_rng(2)
    rows = (rng.normal(size=(32, 8)) * 10).astype(np.float32)
    rows[3] = 0.0
    for a, b in zip(q.quantize_q8(rows), ref_q.quantize_q8(rows)):
        assert a.tobytes() == b.tobytes()
    assert q.bf16_roundtrip(rows).tobytes() == ref_q.bf16_roundtrip(rows).tobytes()
    pay, scales = q.q8_payload(rows)
    assert (pay, scales) == ref_q.q8_payload(rows)
    assert q.q8_from_payload(pay, scales, (8,)).tobytes() == \
        ref_q.q8_from_payload(pay, scales, (8,)).tobytes()
    ids = np.arange(32)
    for enc in ("q8", "bf16"):
        c, rc = q.DeltaCompressor(enc), ref_q.DeltaCompressor(enc)
        for _ in range(3):  # the residuals carry over between pushes
            d = (rng.normal(size=(32, 8)) * 10).astype(np.float32)
            for a, b in zip(c.compress(ids, d), rc.compress(ids, d)):
                assert (a is None and b is None) or a.tobytes() == b.tobytes()
        assert c.residuals.norm() == rc.residuals.norm()
    payload = {"ids": ids, "deltas": rows}
    out, f32b, shipped = q.compress_record_payload(payload, q.DeltaCompressor("q8"))
    rout, rf32b, rshipped = ref_q.compress_record_payload(payload, ref_q.DeltaCompressor("q8"))
    assert (f32b, shipped) == (rf32b, rshipped)
    assert q.record_deltas(out).tobytes() == ref_q.record_deltas(rout).tobytes()


# ---------------------------------------------------------------------------
# ParamShard: bitwise against the reference's, and across crash -> replay
# ---------------------------------------------------------------------------


def _unique_pushes(rng, capacity, dim, n_push=6, lanes=24):
    return [
        (rng.choice(capacity, lanes, replace=False).astype(np.int64),
         rng.normal(size=(lanes, dim)).astype(np.float32))
        for _ in range(n_push)
    ]


@pytest.mark.parametrize("kind", ["range", "hash"])
def test_param_shard_matches_the_reference_and_replays_bitwise(kind, tmp_path):
    capacity, dim, n = 97, 4, 3
    part = RangePartitioner(capacity, n) if kind == "range" else ConsistentHashPartitioner(capacity, n)
    rpart = RefRange(capacity, n) if kind == "range" else RefHash(capacity, n)
    rng = np.random.default_rng(3)
    pushes = _unique_pushes(rng, capacity, dim)
    for s in range(n):
        shard = ParamShard(s, part, (dim,), init_fn=ranged_random_factor(5, (dim,)),
                           wal_dir=str(tmp_path / f"p{s}"), registry=False, device=CPU)
        ref = RefShard(s, rpart, (dim,), init_fn=ref_init(5, (dim,)), registry=False)
        for ids, d in pushes:
            mine = part.shard_of(ids) == s
            if mine.any():
                shard.push(ids[mine], d[mine])
                ref.push(ids[mine], d[mine])
        got = shard.values()
        assert got.tobytes() == np.asarray(ref.values()).tobytes()
        probe = part.owned_ids(s)[::2]
        assert shard.pull(probe).tobytes() == np.asarray(ref.pull(probe)).tobytes()
        shard.crash()
        shard.restart()
        assert shard.values().tobytes() == got.tobytes()
        shard.close()
        ref.close()


def test_pow2_padding_is_bitwise_inert():
    """The reference pads each shard push to a power of two with id -1
    lanes (for XLA's compile cache); the port does not.  Padded lanes
    reach the store's out-of-range sentinel and change nothing."""
    rng = np.random.default_rng(4)
    a = ShardedParamStore.from_values(torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32)), device=CPU)
    b = ShardedParamStore(a.spec, a.table.clone())
    for ids, d in _unique_pushes(rng, 40, 3, n_push=5, lanes=13):
        store_push(a.spec, a.table, torch.from_numpy(ids), torch.from_numpy(d))
        pad = 16 - len(ids)
        store_push(b.spec, b.table, torch.from_numpy(np.concatenate([ids, np.full(pad, -1)])),
                   torch.from_numpy(np.concatenate([d, np.zeros((pad, 3), np.float32)])))
    assert a.table.numpy().tobytes() == b.table.numpy().tobytes()


def test_shard_backends_and_knobs_that_raise():
    part = RangePartitioner(16, 1)
    with pytest.raises(ValueError, match="torch"):
        ParamShard(0, part, (2,), store_backend="jax", registry=False)
    # the tiered store is served: its hot tier a tensor on the device it
    # was given, float32 only, and it never builds the dense host mirror
    tier = ParamShard(0, part, (2,), store_backend="tiered", registry=False, device=CPU,
                      tier_hot_rows=4)
    try:
        assert tier.store._hot.device.type == "cpu" and tier.store._hot.shape == (4, 2)
        tier.push(np.arange(8), np.ones((8, 2), np.float32))
        assert tier.pull(np.arange(8)).tolist() == [[1.0, 1.0]] * 8
        assert tier._host_mirror is None and tier.stats()["tier"]["resident_rows"] <= 4
    finally:
        tier.close()
    with pytest.raises(ValueError, match="fp32"):
        ParamShard(0, part, (2,), store_backend="tiered", dtype=torch.bfloat16, registry=False,
                   device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):  # the hot tier's default is the card
            ParamShard(0, part, (2,), store_backend="tiered", registry=False)
    # the torch slice lives on the device it was given; numpy on the host
    t = ParamShard(0, part, (2,), registry=False, device=CPU)
    assert isinstance(t.store.table, torch.Tensor) and t.store.table.device.type == "cpu"
    n = ParamShard(0, part, (2,), registry=False, store_backend="numpy")
    assert isinstance(n.store.values(), np.ndarray)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ParamShard(0, part, (2,), registry=False)  # the default is the card
    with pytest.raises(NotImplementedError, match="shmem"):
        ClusterClient([("127.0.0.1", 1)], part, (2,), wire_proto="shm", registry=False)


# ---------------------------------------------------------------------------
# ClusterDriver against the reference's and the single-process table
# ---------------------------------------------------------------------------


def _mf_fixture(num_users=64, num_items=96, dim=8, batch=48, rounds=6):
    cols = synthetic_ratings(num_users, num_items, rounds * batch, seed=3)
    batches = list(microbatches(cols, batch))
    return batches, ranged_random_factor(7, (dim,)), num_users, num_items, dim


def _logic(nu, dim):
    return OnlineMatrixFactorization(nu, dim, updater=SGDUpdater(0.05), seed=1, device=CPU)


def _single_process_table(batches, init, nu, ni, dim):
    store = ShardedParamStore.create(ni, (dim,), init_fn=init, device=CPU)
    driver = StreamingDriver(_logic(nu, dim), store, config=DriverConfig(dump_model=False))
    return driver.run(iter(batches), collect_outputs=False).store.values().numpy()


def _ref_cluster_table(batches, nu, ni, dim, **cfg):
    logic = ref_mf.OnlineMatrixFactorization(nu, dim, updater=ref_mf.SGDUpdater(0.05), seed=1)
    driver = RefDriver(logic, capacity=ni, value_shape=(dim,), init_fn=ref_init(7, (dim,)),
                       config=RefConfig(**cfg), registry=False)
    with driver:
        return driver.run(batches).values


def _cluster(nu, ni, dim, init, registry=False, **cfg):
    return ClusterDriver(_logic(nu, dim), capacity=ni, value_shape=(dim,), init_fn=init,
                         config=ClusterConfig(**cfg), registry=registry, device=CPU)


@pytest.mark.parametrize("partition", ["range", "hash"])
def test_bsp_4x2_matches_the_reference_cluster_and_single_process(partition):
    batches, init, nu, ni, dim = _mf_fixture()
    cfg = dict(num_shards=4, num_workers=2, staleness_bound=0, partition=partition)
    with _cluster(nu, ni, dim, init, **cfg) as driver:
        result = driver.run(batches)
        assert all(s.store.table.device.type == "cpu" for s in driver.shards)
    np.testing.assert_allclose(result.values, _single_process_table(batches, init, nu, ni, dim), **BAR)
    np.testing.assert_allclose(result.values, _ref_cluster_table(batches, nu, ni, dim, **cfg), **BAR)
    assert result.clock["clocks"] == [len(batches)] * 2


@pytest.mark.parametrize("backend", ["socket", "mesh"])
def test_one_worker_matches_the_reference_at_the_mf_tolerance(backend):
    batches, init, nu, ni, dim = _mf_fixture()
    cfg = dict(num_shards=2, num_workers=1, store_backend=backend)
    with _cluster(nu, ni, dim, init, **cfg) as driver:
        got = driver.run(batches).values
    np.testing.assert_allclose(got, _ref_cluster_table(batches, nu, ni, dim, **cfg), **MF_TOL)
    # the port's 1-worker run is repeatable bit for bit
    with _cluster(nu, ni, dim, init, **cfg) as driver:
        assert driver.run(batches).values.tobytes() == got.tobytes()


def test_driver_defaults_to_the_card_and_knobs_that_raise():
    batches, init, nu, ni, dim = _mf_fixture(rounds=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ClusterDriver(_logic(nu, dim), capacity=ni, value_shape=(dim,), registry=False)
    # the shared-memory transport still raises naming its item
    with pytest.raises(NotImplementedError, match="shmem") as e:
        _cluster(nu, ni, dim, init, wire_proto="shm")
    assert "Queue 1 #7" in str(e.value)
    # adaptive=True builds the adaptive clock (default ceiling 2*bound+1);
    # store_backend="tiered" puts every shard's hot tier on the driver's device
    with _cluster(nu, ni, dim, init, adaptive=True, staleness_bound=2, num_workers=2) as d:
        assert type(d.clock).__name__ == "AdaptiveClock"
        assert d.clock.bound_ceiling == 5 and d.work_router is None
    with _cluster(nu, ni, dim, init, num_shards=2, store_backend="tiered", tier_hot_rows=8) as d:
        assert all(type(s.store).__name__ == "TieredStore" for s in d.shards)
        assert all(s.store._hot.device.type == "cpu" and s.store.hot_rows == 8 for s in d.shards)
        d.run(batches)
    with pytest.raises(ValueError, match="shard_procs"):
        _cluster(nu, ni, dim, init, store_backend="tiered", shard_procs=True)
    with pytest.raises(ValueError, match="store_backend"):
        _cluster(nu, ni, dim, init, store_backend="rdma")


def test_collect_outputs_and_worker_states_come_back_on_the_host():
    batches, init, nu, ni, dim = _mf_fixture(rounds=2)
    with _cluster(nu, ni, dim, init, num_shards=2, num_workers=2) as driver:
        r = driver.run(batches, collect_outputs=True)
    assert len(r.worker_outputs) == 2 * len(batches)
    assert all(isinstance(o["prediction"], np.ndarray) for o in r.worker_outputs)
    assert all(isinstance(s, torch.Tensor) for s in r.worker_states)


def test_push_aggregate_and_quantized_wire_run():
    """The aggregation tree (one combined push per shard per round) and
    the q8 wire under SSP (BSP downgrades quantized wires to exact)."""
    batches, init, nu, ni, dim = _mf_fixture(rounds=4)
    base = _single_process_table(batches, init, nu, ni, dim)
    with _cluster(nu, ni, dim, init, num_shards=2, num_workers=2, push_aggregate=True) as d:
        r = d.run(batches)
        assert d.last_push_aggregator is not None
    np.testing.assert_allclose(r.values, base, **BAR)
    with _cluster(nu, ni, dim, init, num_shards=2, num_workers=1, staleness_bound=1,
                  wire_format="q8") as d:
        rq = d.run(batches)
    assert np.isfinite(rq.values).all()
    np.testing.assert_allclose(rq.values, base, atol=0.05)


# ---------------------------------------------------------------------------
# shard processes: the numpy slice in a spawned child
# ---------------------------------------------------------------------------


def test_as_torch_init_renders_the_child_rows():
    spec = {"kind": "hashed_uniform", "scale": 0.1, "seed": 7, "width": 4}
    ids = np.arange(20)
    rows = as_torch_init({"kind": "hashed_uniform", "scale": 0.1, "seed": 7}, (4,), CPU)(
        torch.arange(20, dtype=torch.int32))
    assert rows.dtype == torch.float32 and rows.device.type == "cpu"
    assert rows.numpy().tobytes() == resolve_init(spec)(ids).tobytes()
    assert as_torch_init(None, (4,), CPU) is None


def test_proc_vs_thread_bitwise_parity():
    rng = np.random.default_rng(0)
    batches = [{
        "user": rng.integers(0, 16, 32).astype(np.int32),
        "item": rng.integers(0, 32, 32).astype(np.int32),
        "rating": rng.normal(0, 1, 32).astype(np.float32),
    } for _ in range(3)]
    init = {"kind": "hashed_uniform", "scale": 0.1, "seed": 7}
    tables = {}
    for procs in (True, False):
        logic = OnlineMatrixFactorization(16, 4, updater=SGDUpdater(0.05), seed=1, device=CPU)
        driver = ClusterDriver(
            logic, capacity=32, value_shape=(4,),
            config=ClusterConfig(num_shards=2, num_workers=1, shard_procs=procs,
                                 proc_init=init, profile=False),
            registry=False, device=CPU,
        )
        with driver:
            r = driver.run(batches)
        tables[procs] = r.values
        if procs:
            assert r.shard_stats[0]["pushes"] == 3  # crossed the wire
            assert r.shard_stats[0]["backend"] == "numpy"
        else:
            assert r.shard_stats[0]["backend"] == "torch"
    assert np.array_equal(tables[True], tables[False])


def test_kill_and_respawn_rebuilds_from_wal(tmp_path):
    spec = ShardProcSpec(shard_id=0, partition="range", capacity=16, num_shards=1,
                         value_shape=(2,), wal_dir=str(tmp_path / "wal"))
    proc = ShardProcess(spec).wait_ready()
    part = RangePartitioner(16, 1)
    c = ClusterClient([(proc.host, proc.port)], part, (2,), registry=False)
    ids = np.arange(16, dtype=np.int64)
    c.push_batch(ids, np.full((16, 2), 5.0, np.float32))
    before = c.pull_batch(ids)
    c.flush()
    c.close()
    proc.kill()
    assert not proc.running
    proc2 = ShardProcess(spec).wait_ready()
    try:
        c2 = ClusterClient([(proc2.host, proc2.port)], part, (2,), registry=False,
                           spawn_grace_s=5.0)
        assert np.array_equal(c2.pull_batch(ids), before)
        c2.close()
    finally:
        proc2.stop()


def test_spawn_grace_dial_retries_refused_and_no_grace_fails_fast():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    host, port = probe.getsockname()
    probe.close()
    part = RangePartitioner(8, 1)
    c = ClusterClient([(host, port)], part, (2,), registry=False)
    with pytest.raises(OSError):
        c.pull_batch(np.arange(8, dtype=np.int64))
    c.close()
    state = {}

    def late_start():
        time.sleep(0.4)
        shard = ParamShard(0, part, (2,), registry=False, device=CPU)
        state["srv"] = ShardServer(shard, host, port).start()

    t = threading.Thread(target=late_start, daemon=True)
    t.start()
    c = ClusterClient([(host, port)], part, (2,), registry=False, spawn_grace_s=5.0)
    try:
        assert c.pull_batch(np.arange(8, dtype=np.int64)).shape == (8, 2)
    finally:
        c.close()
        t.join()
        state["srv"].stop()


# ---------------------------------------------------------------------------
# mirrors of tests/test_cluster.py
# ---------------------------------------------------------------------------


class TestPartitioners:
    def test_range_total_and_balanced(self):
        p = RangePartitioner(1000, 4)
        shards = p.shard_of(np.arange(1000))
        assert shards.min() >= 0 and shards.max() < 4
        sizes = [p.shard_capacity(s) for s in range(4)]
        assert sum(sizes) == 1000
        assert max(sizes) - min(sizes) <= p.rows_per_shard

    def test_range_local_roundtrip_and_misroute(self):
        p = RangePartitioner(100, 3)
        owned = p.owned_ids(1)
        assert np.array_equal(p.to_global(1, p.to_local(1, owned)), owned)
        with pytest.raises(KeyError):
            p.to_local(1, np.array([0]))

    def test_range_matches_store_row_blocks(self):
        from flink_parameter_server_tpu_torch.core.store import StoreSpec

        spec = StoreSpec(capacity=96, value_shape=(4,))
        p = RangePartitioner(spec.capacity, 4)
        assert p.rows_per_shard == 24
        assert np.array_equal(p.owned_ids(2), np.arange(48, 72))

    def test_hash_total_and_roughly_balanced(self):
        p = ConsistentHashPartitioner(4096, 4, seed=1)
        shards = p.shard_of(np.arange(4096))
        sizes = np.bincount(shards, minlength=4)
        assert sizes.sum() == 4096
        assert sizes.max() <= 2 * 4096 // 4
        assert sizes.min() >= 4096 // 4 // 2

    def test_hash_stable_under_growth(self):
        p4 = ConsistentHashPartitioner(4096, 4, seed=7)
        ids = np.arange(4096)
        before, after = p4.shard_of(ids), p4.grown(5).shard_of(ids)
        moved = before != after
        assert (after[moved] == 4).all() and moved.any()

    def test_hash_local_roundtrip(self):
        p = ConsistentHashPartitioner(512, 3, seed=2)
        for s in range(3):
            owned = p.owned_ids(s)
            assert np.array_equal(p.to_global(s, p.to_local(s, owned)), owned)
        some = int(p.owned_ids(0)[0])
        wrong = (int(p.shard_of(np.array([some]))[0]) + 1) % 3
        with pytest.raises(KeyError):
            p.to_local(wrong, [some])

    def test_invalid_args(self):
        with pytest.raises(ValueError):
            RangePartitioner(10, 11)
        with pytest.raises(ValueError):
            RangePartitioner(0, 1)
        with pytest.raises(ValueError):
            ConsistentHashPartitioner(10, 0)
        with pytest.raises(ValueError):
            RangePartitioner(10, 2).shard_of(np.array([10]))
        with pytest.raises(ValueError):
            ConsistentHashPartitioner(64, 4).grown(2)


class TestStalenessClock:
    def test_bsp_blocks_until_all_tick(self):
        c = StalenessClock(2, bound=0)
        assert c.wait_for_turn(0)
        c.tick(0)
        assert not c.wait_for_turn(0, timeout=0.02)
        assert c.block_counts[0] == 1
        c.tick(1)
        assert c.wait_for_turn(0, timeout=1.0)
        assert c.staleness() == 0

    def test_ssp_bound_k(self):
        c = StalenessClock(2, bound=2)
        for _ in range(3):
            assert c.wait_for_turn(0, timeout=0.02)
            c.tick(0)
        assert not c.wait_for_turn(0, timeout=0.02)
        assert c.staleness() == 3
        c.tick(1)
        assert c.wait_for_turn(0, timeout=1.0)

    def test_async_never_blocks(self):
        c = StalenessClock(2, bound=None)
        for _ in range(100):
            assert c.wait_for_turn(0)
            c.tick(0)
        assert c.block_counts == [0, 0]

    def test_deactivate_unblocks_survivors(self):
        c = StalenessClock(2, bound=0)
        c.tick(0)
        assert not c.wait_for_turn(0, timeout=0.02)
        released = []
        t = threading.Thread(target=lambda: released.append(c.wait_for_turn(0, timeout=5)))
        t.start()
        c.deactivate(1)
        t.join(timeout=5)
        assert released == [True]

    def test_validation(self):
        with pytest.raises(ValueError):
            StalenessClock(0)
        with pytest.raises(ValueError):
            StalenessClock(1, bound=-1)


class TestWire:
    def test_row_encodings_roundtrip_exactly(self):
        rows = np.random.default_rng(0).normal(size=(17, 5)).astype(np.float32)
        for enc in ("text", "b64"):
            assert np.array_equal(parse_rows(format_rows(rows, enc), (5,)), rows), enc
        with pytest.raises(ValueError):
            format_rows(rows, "hex")
        with pytest.raises(ValueError):
            parse_rows(format_rows(rows, "b64"), (7,))

    @pytest.fixture()
    def served_shard(self):
        part = RangePartitioner(64, 2)
        shard = ParamShard(0, part, (4,), init_fn=ranged_random_factor(3, (4,)),
                           registry=False, device=CPU)
        server = ShardServer(shard, supervised=False).start()
        yield shard, server, part
        server.stop()

    def test_pull_push_flush_stats(self, served_shard):
        shard, server, part = served_shard
        expect = _init_rows(ranged_random_factor(3, (4,)), [0, 5])
        resps = request_lines(server.host, server.port, [
            "pull 0,5", "pull 0,5 b64",
            "push 5 " + format_rows(np.ones((1, 4), np.float32)),
            "pull 5 b64", "flush", "stats",
        ])
        assert all(r.startswith("ok") for r in resps), resps
        assert np.array_equal(parse_rows(resps[0].split(" ", 2)[2], (4,)), expect)
        assert np.array_equal(parse_rows(resps[1].split(" ", 2)[2], (4,)), expect)
        after = parse_rows(resps[3].split(" ", 2)[2], (4,))
        assert np.allclose(after[0], expect[1] + 1.0)
        assert "applied=1" in resps[2]
        stats = json.loads(resps[5][3:])
        assert stats["pulls"] == 3 and stats["pushes"] == 1
        # the pull after the push rebuilt the host mirror off the slice
        assert stats["mirror_rebuilds"] == 2

    def test_protocol_errors(self, served_shard):
        _shard, server, _part = served_shard
        resps = request_lines(server.host, server.port,
                              ["nope", "pull", "pull 63", "pull 0 hex", "push 1 1,2",
                               "xfer", "load 0", "load 0 1,2,3",
                               # a lease or revoke without its session; a
                               # repl frame that is no WAL record (and, to
                               # a primary, any repl frame)
                               "lease 0 b64", "revoke all",
                               "repl AAAA", "conns"])
        assert all(r.startswith("err bad-request") for r in resps), resps
        # lease / revoke came back with hotcache/ (tests/test_torch_hotcache.py)
        lease, revoke = request_lines(server.host, server.port,
                                      ["lease 0 b64 sess=s1", "revoke all sess=s1"])
        assert lease.startswith("ok n=1 seq=0 ttl=16 b64:") and revoke == "ok revoked=1", (lease, revoke)
        # replstate came back with replication/ (tests/test_torch_replication.py)
        (state,) = request_lines(server.host, server.port, ["replstate"])
        assert state.startswith("ok ") and json.loads(state[3:])["role"] == "primary", state
        # xfer / load came back with elastic/ (tests/test_torch_elastic.py)
        xfer, load = request_lines(server.host, server.port, ["xfer 0", "load 0 1,2,3,4"])
        assert xfer.startswith("ok n=1 seq=0 b64:") and load == "ok loaded=1 seq=1", (xfer, load)

    def test_unserved_options_are_ignored(self, served_shard):
        _shard, server, _part = served_shard
        resps = request_lines(server.host, server.port, [
            "pull 0 b64 e=3 sess=s1 pr=1",
            "push 0 " + format_rows(np.ones((1, 4), np.float32)) + " pid=p.1 e=3",
        ])
        assert resps[0].startswith("ok n=1 b64:") and " inv=" not in resps[0], resps
        assert resps[1] == "ok applied=1 seq=1", resps

    def test_unsupervised_crash_is_visible(self, served_shard):
        shard, server, _part = served_shard
        shard.crash()
        (resp,) = request_lines(server.host, server.port, ["pull 0"])
        assert resp.startswith("err crashed")


class TestShardEdge:
    """The overload plane at the shard edge and in the client
    (tests/test_loadgen.py TestShardEdge, and its breaker test)."""

    @staticmethod
    def _server(guard):
        shard = ParamShard(0, RangePartitioner(16, 1), (2,), registry=False, device=CPU)
        return ShardServer(shard, supervised=False, overload=guard)

    def test_sheds_reads_before_writes(self):
        guard = OverloadGuard(sheddable_depth=2, read_depth=4, registry=False)
        srv = self._server(guard)
        with srv.shard._depth_lock:
            srv.shard._active_requests = 10
        try:
            assert srv.respond("pull 0,1 b64 pr=2") == "err overloaded"
            assert srv.respond("pull 0,1 b64") == "err overloaded"
            # training pushes go through at any depth
            resp = srv.respond("push 0,1 " + format_rows(np.ones((2, 2), np.float32), "b64"))
            assert resp.startswith("ok applied=2")
        finally:
            with srv.shard._depth_lock:
                srv.shard._active_requests = 0
        assert srv.respond("pull 0 b64 pr=2").startswith("ok n=1")
        assert guard.sheds == 2

    def test_client_raises_typed_overloaded(self):
        srv = self._server(OverloadGuard(sheddable_depth=1, registry=False)).start()
        try:
            client = ClusterClient([(srv.host, srv.port)], srv.shard.partitioner, (2,),
                                   registry=False, priority=2)
            assert client._frame_suffix() == " pr=2"
            client.pull_batch(np.arange(2))
            with srv.shard._depth_lock:
                srv.shard._active_requests = 10
            try:
                with pytest.raises(OverloadedError):
                    client.pull_batch(np.arange(2))
            finally:
                with srv.shard._depth_lock:
                    srv.shard._active_requests = 0
            client.close()
        finally:
            srv.stop()

    def test_server_without_a_guard_ignores_pr(self):
        srv = self._server(None).start()
        try:
            client = ClusterClient([(srv.host, srv.port)], srv.shard.partitioner, (2,),
                                   registry=False, priority=2)
            assert client.pull_batch(np.arange(4)).shape == (4, 2)
            client.close()
        finally:
            srv.stop()

    def test_breaker_open_fails_fast_before_the_wire(self):
        board = BreakerBoard(min_failures=1, failure_rate=0.1, cooldown_s=60.0, registry=False)
        client = ClusterClient([("127.0.0.1", 1)], RangePartitioner(16, 1), (2,), registry=False,
                               breakers=board)
        board.fail(0)
        assert board.state(0) == "open"
        with pytest.raises(RuntimeError, match="circuit open"):
            client.pull_batch(np.arange(2))
        assert client._conns == {}  # nothing was dialled
        client.close()


class TestClusterClient:
    @pytest.fixture()
    def topology(self):
        part = RangePartitioner(96, 3)
        init = ranged_random_factor(5, (4,))
        shards = [ParamShard(s, part, (4,), init_fn=init, registry=False, device=CPU)
                  for s in range(3)]
        servers = [ShardServer(sh, supervised=False).start() for sh in shards]
        yield part, shards, servers
        for srv in servers:
            srv.stop()

    def _client(self, part, servers, **kw):
        return ClusterClient([(s.host, s.port) for s in servers], part, (4,), registry=False, **kw)

    def test_pull_coalesces_duplicates(self, topology):
        part, shards, servers = topology
        client = self._client(part, servers, chunk=4)
        ids = np.array([1, 1, 1, 40, 40, 90, 1])
        vals = client.pull_batch(ids)
        client.close()
        assert np.array_equal(vals, _init_rows(ranged_random_factor(5, (4,)), ids))
        assert client.pulls_coalesced == 4
        assert sum(sh.pulls_served for sh in shards) == 3

    def test_push_aggregates_duplicates(self, topology):
        part, shards, servers = topology
        client = self._client(part, servers)
        before = client.pull_batch(np.array([7]))[0]
        deltas = np.tile(np.array([[1.0, 2.0, 3.0, 4.0]], np.float32), (4, 1))
        pushed = client.push_batch(np.array([7, 7, 7, 7]), deltas)
        after = client.pull_batch(np.array([7]))[0]
        client.close()
        assert pushed == 1 and client.pushes_coalesced == 3
        assert np.allclose(after - before, 4.0 * deltas[0])
        assert sum(sh.pushes_applied for sh in shards) == 1

    def test_masked_lanes_do_not_push(self, topology):
        part, shards, servers = topology
        client = self._client(part, servers)
        before = client.pull_batch(np.arange(96))
        client.push_batch(np.array([3, 4]), np.ones((2, 4), np.float32), mask=np.array([True, False]))
        diff = client.pull_batch(np.arange(96)) - before
        client.close()
        assert np.allclose(diff[3], 1.0) and np.allclose(diff[4], 0.0)

    def test_pipelined_window_many_chunks(self, topology):
        part, shards, servers = topology
        client = self._client(part, servers, chunk=1, window=2)
        ids = np.arange(0, 96, 5)
        assert np.array_equal(client.pull_batch(ids), _init_rows(ranged_random_factor(5, (4,)), ids))
        assert client.inflight() == 0
        client.close()

    def test_event_api_surface(self, topology):
        part, shards, servers = topology
        client = self._client(part, servers)
        answers = []
        client.pull(10)
        client.pull(10)
        client.pull(50)
        client.push(20, np.ones(4, np.float32))
        client.push(20, np.ones(4, np.float32))
        n = client.drain(lambda pid, val, ps: answers.append((pid, val.copy())))
        assert n == 3 and [a[0] for a in answers] == [10, 10, 50]
        assert np.array_equal(answers[0][1], answers[1][1])
        after = client.pull_batch(np.array([20]))[0]
        client.output("done")
        assert client.outputs == ["done"]
        client.close()
        assert np.allclose(after - _init_rows(ranged_random_factor(5, (4,)), [20])[0], 2.0)

    def test_inflight_gauge_registered(self, topology):
        part, _shards, servers = topology
        reg = MetricsRegistry()
        client = ClusterClient([(s.host, s.port) for s in servers], part, (4,),
                               registry=reg, worker="7")
        names = {(i.name, i.labels.get("worker")) for i in reg.instruments()}
        assert ("inflight_pulls", "7") in names
        assert ("cluster_pull_rtt_seconds", "7") in names
        client.pull_batch(np.arange(10))
        h = [i for i in reg.instruments() if i.name == "cluster_pull_rtt_seconds"][0]
        assert h.count >= 1
        client.close()


def test_pull_limiter_inflight_gauge():
    from flink_parameter_server_tpu_torch.core.api import (
        ParameterServerClient,
        WorkerLogic,
        add_pull_limiter,
    )

    class Recorder(ParameterServerClient):
        def __init__(self):
            self.pulled = []

        def pull(self, pid):
            self.pulled.append(pid)

        def push(self, pid, delta):
            pass

        def output(self, w_out):
            pass

    class Puller(WorkerLogic):
        def on_recv(self, data, ps):
            for pid in data:
                ps.pull(pid)

        def on_pull_recv(self, pid, value, ps):
            pass

    reg = MetricsRegistry()
    worker = add_pull_limiter(Puller(), 2, registry=reg, worker="0")
    rec = Recorder()
    worker.on_recv([1, 2, 3, 4, 5], rec)
    snap = {(i.name, i.labels.get("worker")): i.value for i in reg.instruments()}
    assert snap[("inflight_pulls", "0")] == 2
    assert snap[("queued_pulls", "0")] == 3
    assert rec.pulled == [1, 2]
    worker.on_pull_recv(1, 0.0, rec)
    assert worker.limiter.inflight() == 2
    assert worker.limiter.queued() == 2


class TestShardRecovery:
    def test_crash_restart_replays_to_bitwise_state(self, tmp_path):
        part = RangePartitioner(32, 1)
        shard = ParamShard(0, part, (4,), init_fn=ranged_random_factor(11, (4,)),
                           wal_dir=str(tmp_path / "wal"), registry=False, device=CPU)
        rng = np.random.default_rng(0)
        for _ in range(5):
            shard.push(rng.integers(0, 32, 8), rng.normal(size=(8, 4)).astype(np.float32))
        before = shard.values()
        shard.crash()
        with pytest.raises(Exception):
            shard.pull(np.array([0]))
        assert shard.restart() == 5
        assert np.array_equal(shard.values(), before)
        shard.close()

    def test_fresh_process_over_existing_wal(self, tmp_path):
        part = RangePartitioner(32, 1)
        init = ranged_random_factor(11, (4,))
        wal = str(tmp_path / "wal")
        shard = ParamShard(0, part, (4,), init_fn=init, wal_dir=wal, registry=False, device=CPU)
        shard.push(np.array([1, 2]), np.ones((2, 4), np.float32))
        shard.push(np.array([2, 3]), np.ones((2, 4), np.float32))
        before = shard.values()
        shard.close()
        reborn = ParamShard(0, part, (4,), init_fn=init, wal_dir=wal, registry=False, device=CPU)
        assert np.array_equal(reborn.values(), before)
        reborn.push(np.array([0]), np.ones((1, 4), np.float32))
        assert reborn._push_seq == 3
        reborn.close()

    def test_supervised_server_hides_the_crash(self, tmp_path):
        reg = MetricsRegistry()
        part = RangePartitioner(32, 1)
        shard = ParamShard(0, part, (4,), init_fn=ranged_random_factor(11, (4,)),
                           wal_dir=str(tmp_path / "wal"), registry=reg, device=CPU)
        server = ShardServer(shard, supervised=True).start()
        try:
            (r1,) = request_lines(server.host, server.port,
                                  ["push 4 " + format_rows(np.ones((1, 4), np.float32))])
            assert r1.startswith("ok")
            expected = shard.values().copy()
            shard.crash()
            (r2,) = request_lines(server.host, server.port, ["pull 4 b64"])
            assert r2.startswith("ok"), r2
            assert np.array_equal(parse_rows(r2.split(" ", 2)[2], (4,))[0], expected[4])
            counters = {i.name: i.value for i in reg.instruments() if i.labels.get("shard") == "0"}
            assert counters["cluster_shard_restarts_total"] == 1
        finally:
            server.stop()
            shard.close()


class TestClusterDriver:
    @pytest.mark.parametrize("partition", ["range", "hash"])
    def test_bsp_parity_4_shards_2_workers(self, partition):
        batches, init, nu, ni, dim = _mf_fixture(rounds=12, batch=128)
        base = _single_process_table(batches, init, nu, ni, dim)
        with _cluster(nu, ni, dim, init, num_shards=4, num_workers=2, staleness_bound=0,
                      partition=partition) as driver:
            result = driver.run(batches)
        np.testing.assert_allclose(result.values, base, **BAR)
        assert result.rounds == len(batches)
        assert result.clock["staleness"] == 0
        assert result.clock["clocks"] == [len(batches)] * 2
        assert all(s["pushes"] > 0 for s in result.shard_stats)

    def test_worker_masks_partition_the_batch(self):
        batches, init, nu, ni, dim = _mf_fixture(rounds=1, batch=128)
        driver = _cluster(nu, ni, dim, init, num_shards=2, num_workers=3)
        masks = [driver._worker_mask(batches[0], w) for w in range(3)]
        stacked = np.stack(masks)
        assert np.array_equal(stacked.sum(0).astype(bool), batches[0]["mask"])
        assert (stacked.sum(0) <= 1).all()
        for w in range(3):
            users_w = set(batches[0]["user"][masks[w]].tolist())
            for w2 in range(w + 1, 3):
                assert not (users_w & set(batches[0]["user"][masks[w2]].tolist()))

    def test_ssp_bound_enforced_and_staleness_scrapeable(self):
        bound = 2
        batches, init, nu, ni, dim = _mf_fixture(rounds=10)
        reg = MetricsRegistry()
        driver = _cluster(nu, ni, dim, init, registry=reg, num_shards=2, num_workers=2,
                          staleness_bound=bound)
        release = threading.Event()

        def hold_worker_0(worker, rnd):
            if worker == 0 and rnd == 1:
                assert release.wait(60), "test hung: release never set"

        result, errors = {}, []

        def run():
            try:
                with driver:
                    result["r"] = driver.run(batches, round_hook=hold_worker_0)
            except BaseException as e:  # pragma: no cover - surfaced below
                errors.append(e)
                release.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            clocks = driver.clock.clocks() if driver.clock else [0, 0]
            if clocks[1] >= 1 + bound + 1 and driver.clock.block_counts[1]:
                break
            time.sleep(0.005)
        assert not errors, errors
        assert driver.clock.clocks()[0] == 1
        assert driver.clock.clocks()[1] == 1 + bound + 1
        assert driver.clock.staleness() == bound + 1
        gauge = [i for i in reg.instruments() if i.name == "cluster_staleness_steps"]
        assert gauge and gauge[0].value == bound + 1  # live, mid-run
        time.sleep(0.05)
        assert driver.clock.clocks()[1] == 1 + bound + 1
        release.set()
        t.join(timeout=120)
        assert not errors, errors
        assert result["r"].clock["clocks"] == [len(batches)] * 2
        assert result["r"].clock["block_counts"][1] >= 1

    def test_async_mode_never_blocks(self):
        batches, init, nu, ni, dim = _mf_fixture(rounds=6)
        with _cluster(nu, ni, dim, init, num_shards=2, num_workers=2,
                      staleness_bound=None) as driver:
            r = driver.run(batches)
        assert r.clock["block_counts"] == [0, 0]
        assert r.clock["clocks"] == [len(batches)] * 2
        assert np.isfinite(r.values).all()

    def test_cluster_metrics_reach_registry_and_lint(self):
        import tools.check_metric_lines as lint

        batches, init, nu, ni, dim = _mf_fixture(rounds=3)
        reg = MetricsRegistry()
        with _cluster(nu, ni, dim, init, registry=reg, num_shards=2, num_workers=1) as driver:
            driver.run(batches)
        by_name = {}
        for inst in reg.instruments():
            if inst.labels.get("component") == "cluster":
                by_name.setdefault(inst.name, []).append(inst)
        for name in ("cluster_pulls_total", "cluster_pushes_total", "cluster_pull_rtt_seconds",
                     "cluster_staleness_steps", "cluster_shard_queue_depth",
                     "cluster_worker_rounds_total"):
            assert name in by_name, name
        assert {i.labels["shard"] for i in by_name["cluster_pulls_total"]} == {"0", "1"}
        assert by_name["cluster_worker_rounds_total"][0].value == 3
        line = reg.emit()
        assert lint.check_lines([line]) == []
        bad = line.replace('"component": "cluster"', '"component": "clstr"')
        problems = lint.check_lines([bad])
        assert problems and "clstr" in problems[0][1]

    def test_result_values_match_shard_dumps(self):
        batches, init, nu, ni, dim = _mf_fixture(rounds=3)
        with _cluster(nu, ni, dim, init, num_shards=3, num_workers=1, partition="hash") as driver:
            r = driver.run(batches)
            assembled = np.empty_like(r.values)
            for shard in driver.shards:
                assembled[shard.owned] = shard.values()
        assert np.array_equal(assembled, r.values)


# ---------------------------------------------------------------------------
# mirrors of tests/test_cluster_properties.py
# ---------------------------------------------------------------------------

caps = st.integers(min_value=1, max_value=2048)
seeds = st.integers(min_value=0, max_value=2**31 - 1)


@settings(max_examples=60, deadline=None)
@given(capacity=caps, num_shards=st.integers(1, 16), data=st.data())
def test_range_total_balanced_bijective(capacity, num_shards, data):
    num_shards = min(num_shards, capacity)
    p = RangePartitioner(capacity, num_shards)
    shards = p.shard_of(np.arange(capacity))
    assert ((shards >= 0) & (shards < num_shards)).all()
    sizes = np.bincount(shards, minlength=num_shards)
    assert sizes.sum() == capacity and sizes.max() <= p.rows_per_shard
    s = data.draw(st.integers(0, num_shards - 1))
    owned = p.owned_ids(s)
    assert len(owned) == sizes[s]
    if len(owned):
        assert np.array_equal(p.to_global(s, p.to_local(s, owned)), owned)


@settings(max_examples=60, deadline=None)
@given(capacity=st.integers(64, 2048), num_shards=st.integers(1, 8), seed=seeds)
def test_hash_total_and_balanced(capacity, num_shards, seed):
    p = ConsistentHashPartitioner(capacity, num_shards, seed=seed)
    shards = p.shard_of(np.arange(capacity))
    assert ((shards >= 0) & (shards < num_shards)).all()
    sizes = np.bincount(shards, minlength=num_shards)
    assert sizes.sum() == capacity
    mean = capacity / num_shards
    sigma = np.sqrt(capacity * (1 / num_shards) * (1 - 1 / num_shards))
    assert sizes.max() <= mean + 5 * sigma + 1
    assert sizes.min() >= max(0.0, mean - 5 * sigma - 1)


@settings(max_examples=60, deadline=None)
@given(capacity=st.integers(16, 2048), num_shards=st.integers(1, 8),
       added=st.integers(1, 4), seed=seeds)
def test_hash_growth_moves_keys_only_to_new_shards(capacity, num_shards, added, seed):
    p_small = ConsistentHashPartitioner(capacity, num_shards, seed=seed)
    ids = np.arange(capacity)
    before = p_small.shard_of(ids)
    after = p_small.grown(num_shards + added).shard_of(ids)
    assert (after[before != after] >= num_shards).all()
    for s in range(num_shards):
        assert set(ids[after == s]) <= set(ids[before == s])


@settings(max_examples=60, deadline=None)
@given(capacity=st.integers(16, 2048), n_old=st.integers(1, 8),
       n_new=st.integers(1, 8), seed=seeds)
def test_epoch_transition_partitions_every_key_exactly_once(capacity, n_old, n_new, seed):
    old = ConsistentHashPartitioner(capacity, n_old, seed=seed)
    new = ConsistentHashPartitioner(capacity, n_new, seed=seed)
    ids = np.arange(capacity)
    before, after = old.shard_of(ids), new.shard_of(ids)
    # the moves: for each (src, dst) pair, the keys the flip re-homes
    moved = [ids[(before == a) & (after == b)]
             for a in range(n_old) for b in range(n_new) if a != b]
    moved = np.concatenate(moved) if moved else np.empty(0, np.int64)
    assert len(np.unique(moved)) == len(moved)
    assert np.array_equal(np.sort(moved), ids[before != after])
    owned = np.concatenate([new.owned_ids(s) for s in range(n_new)])
    assert len(owned) == capacity and np.array_equal(np.sort(owned), ids)


@settings(max_examples=40, deadline=None)
@given(capacity=st.integers(32, 1024), num_shards=st.integers(2, 6), seed=seeds, data=st.data())
def test_hash_local_ids_are_dense_bijections(capacity, num_shards, seed, data):
    p = ConsistentHashPartitioner(capacity, num_shards, seed=seed)
    s = data.draw(st.integers(0, num_shards - 1))
    owned = p.owned_ids(s)
    if not len(owned):
        return
    local = p.to_local(s, owned)
    assert np.array_equal(local, np.arange(len(owned)))
    assert np.array_equal(p.to_global(s, local), owned)


# ---------------------------------------------------------------------------
# mid-frame RST inside a binary header / payload, through the chaos proxy
# ---------------------------------------------------------------------------


class TestBinaryMidFrameRST:
    def _proxied(self, shard_dim=2, wal_dir=None):
        from flink_parameter_server_tpu_torch.nemesis.proxy import ChaosProxy

        part = RangePartitioner(32, 1)
        shard = ParamShard(
            0, part, (shard_dim,), registry=False, wal_dir=wal_dir, device=CPU
        )
        srv = ShardServer(shard).start()
        proxy = ChaosProxy(srv.host, srv.port, registry=False).start()
        return part, shard, srv, proxy

    @pytest.mark.parametrize("cut", ["header", "payload"])
    def test_response_torn_inside_binary_frame(self, cut):
        from flink_parameter_server_tpu_torch.cluster.client import ShardConnection
        from flink_parameter_server_tpu_torch.utils import frames as binf
        from flink_parameter_server_tpu_torch.utils.net import PeerHalfClosed

        part, shard, srv, proxy = self._proxied()
        try:
            conn = ShardConnection(proxy.host, proxy.port, negotiate=True, timeout=5)
            assert conn.proto == "bin"
            proxy.inject_once("truncate_rst", "s2c", cut=cut)
            with pytest.raises((PeerHalfClosed, OSError)):
                conn.request_many([binf.encode_request(binf.VERB_IDS["pull"], ids=np.arange(8))])
            assert proxy.faults.get("truncate_rst") == 1
            conn.close()
        finally:
            proxy.stop()
            srv.stop()

    @pytest.mark.parametrize("cut", ["header", "payload"])
    def test_push_torn_request_replays_exactly_once(self, cut, tmp_path):
        """A binary push torn mid-frame (header or payload) and replayed
        with the same pid applies EXACTLY once — the (pid, id) ledger
        absorbs the ambiguity either way."""
        from flink_parameter_server_tpu_torch.cluster.client import ShardConnection
        from flink_parameter_server_tpu_torch.utils import frames as binf
        from flink_parameter_server_tpu_torch.utils.net import PeerHalfClosed

        part, shard, srv, proxy = self._proxied(wal_dir=str(tmp_path / f"wal-{cut}"))
        try:
            ids = np.arange(8, dtype=np.int64)
            deltas = np.ones((8, 2), np.float32)
            frame = binf.encode_request(
                binf.VERB_IDS["push"], ids=ids, payload=binf.rows_to_payload(deltas),
                tlvs=[(binf.T_PID, b"pid.42")],
            )
            conn = ShardConnection(proxy.host, proxy.port, negotiate=True, timeout=5)
            proxy.inject_once("truncate_rst", "c2s", cut=cut)
            with pytest.raises((PeerHalfClosed, OSError)):
                conn.request_many([frame])
            conn.close()
            # the replay (fresh connection, same pid)
            conn2 = ShardConnection(proxy.host, proxy.port, negotiate=True, timeout=5)
            resp = conn2.request_many([frame])[0]
            assert resp.flag == binf.STATUS_OK
            # and a duplicate retry after the ack: acked, not re-applied
            resp2 = conn2.request_many([frame])[0]
            assert resp2.flag == binf.STATUS_OK
            vals = shard.pull(ids)
            assert np.array_equal(vals, deltas)  # exactly once
            conn2.close()
        finally:
            proxy.stop()
            srv.stop()

    def test_proxy_reassembles_binary_frames(self):
        """Binary frames (which may contain 0x0A bytes and end without a
        newline) relay through the byte-level proxy intact."""
        from flink_parameter_server_tpu_torch.cluster.client import ShardConnection
        from flink_parameter_server_tpu_torch.utils import frames as binf

        part, shard, srv, proxy = self._proxied()
        try:
            conn = ShardConnection(proxy.host, proxy.port, negotiate=True, timeout=5)
            # 10 == ord("\n"): the id section embeds newline bytes
            ids = np.asarray([10, 26, 10], np.int64)
            resp = conn.request_many([binf.encode_request(binf.VERB_IDS["pull"], ids=ids)])[0]
            assert resp.flag == binf.STATUS_OK and resp.n == 3
            conn.close()
        finally:
            proxy.stop()
            srv.stop()
