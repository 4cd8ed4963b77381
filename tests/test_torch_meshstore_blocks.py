"""The port's mesh store over several row blocks against the JAX package's
over its 8 virtual devices.

Mirrors the multi-device tests of tests/test_meshstore.py (those that
take ``mesh_devices``): the row block against ``StoreSpec`` (:81), pull
and push against the numpy oracle (:187), where the pulled rows and the
blocks live (:201), push without mask and clip (:217), WAL recovery and
``verify_against_log`` bitwise (:227, :244), the velocity split 1/n
(:264), momentum against the numpy oracle (:287), a misaligned
partitioner refused (:307), the client's batch surface and event API
(:323, :339), and PA, MF and sketch parity through the cluster's mesh
backend (:376-:447).

The port's layout here is ``8 × "cpu"`` (one row block an entry; the
reference's is 8 virtual CPU devices).  Bars, the reference's: the store
exact on integer-valued float32 deltas, bitwise against the reference's
store from the same init, and bitwise against the port's one-block
store; PA bitwise against its streaming oracle at one worker; MF within
rtol 1e-4 / atol 1e-6 at two workers; sketches integer-exact; against the
reference's cluster runs PA and MF at rtol 1e-5 / atol 1e-6 (the port's
float32 sums against the reference's), sketches exact.
"""
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.cluster.driver import ClusterConfig as RefConfig
from flink_parameter_server_tpu.core.store import StoreSpec as RefSpec
from flink_parameter_server_tpu.meshstore import MeshParamStore as RefMeshStore
from flink_parameter_server_tpu.meshstore.layout import SHARD_AXIS as REF_AXIS
from flink_parameter_server_tpu.meshstore.layout import make_store_mesh as ref_store_mesh
from flink_parameter_server_tpu.workloads import WorkloadParams as RefParams
from flink_parameter_server_tpu.workloads import build_cluster_driver as ref_build
from flink_parameter_server_tpu.workloads import create_workload as ref_create
from flink_parameter_server_tpu_torch.cluster.driver import ClusterConfig
from flink_parameter_server_tpu_torch.cluster.partition import RangePartitioner, mesh_row_block
from flink_parameter_server_tpu_torch.meshstore import (
    MeshClient, MeshParamStore, MisalignedTable, make_store_mesh, table_sharding,
)
from flink_parameter_server_tpu_torch.workloads import WorkloadParams, build_cluster_driver, create_workload

torch.set_num_threads(2)

pytestmark = pytest.mark.meshstore

N = 8
BLOCKS = ["cpu"] * N
SMALL = dict(rounds=6, batch=48, num_users=24, num_items=32, dim=4, seed=3)  # tests/test_meshstore.py's
CROSS = dict(rtol=1e-5, atol=1e-6)


def _store(capacity, value_shape=(), n=N, **kw):
    kw.setdefault("registry", False)
    return MeshParamStore(capacity, value_shape, mesh=make_store_mesh(["cpu"] * n), **kw)


def _int_deltas(rng, shape):
    return rng.integers(-8, 9, shape).astype(np.float32)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def test_mesh_row_block_matches_store_spec(mesh_devices):
    """:81 — the block the partitioner aligns to is the split the table
    uses: the port's blocks against the reference's StoreSpec on its 8
    devices."""
    mesh = ref_store_mesh()
    assert len(mesh_devices) == N
    for capacity in (8, 97, 256, 1000):
        ref = RefSpec(capacity, (), mesh=mesh, ps_axis=REF_AXIS)
        store = _store(capacity)
        assert mesh_row_block(capacity, N) == ref.rows_per_shard == store.block_rows
        assert [b.shape[0] for b in store.blocks] == [ref.rows_per_shard] * N
        assert store.stats()["padded_rows"] == ref.padded_capacity
        store.close()


def test_pull_push_matches_numpy_oracle(rng):
    """:187 — pull is table[ids], push np.add.at with duplicates in one
    scatter, across 8 blocks."""
    store = _store(100, (4,))
    want = np.zeros((100, 4), np.float32)
    for _ in range(5):
        ids = rng.integers(0, 100, 64)
        deltas = _int_deltas(rng, (64, 4))
        mask = rng.random(64) < 0.8
        store.push(ids, deltas, mask)
        np.add.at(want, ids[mask], deltas[mask])
    assert np.array_equal(store.values(), want)
    probe = rng.integers(0, 100, 32)
    assert np.array_equal(store.pull(probe).numpy(), want[probe])
    assert np.array_equal(store.pull(probe.reshape(4, 8)).numpy(), want[probe].reshape(4, 8, 4))
    store.close()


def test_store_matches_the_reference_and_one_block(mesh_devices, rng):
    """The same pushes into the port's 8 blocks, its one block and the
    reference's store on 8 devices: every value and pull bitwise (unique
    ids with float deltas, duplicates with integer-valued ones)."""
    ref = RefMeshStore(100, (4,), devices=mesh_devices[:N], registry=False)
    mine, one = _store(100, (4,)), _store(100, (4,), n=1)
    for i in range(6):
        if i % 2:
            ids = rng.choice(100, 40, replace=False)
            deltas = rng.normal(size=(40, 4)).astype(np.float32)
        else:
            ids = rng.integers(0, 100, 64)
            deltas = _int_deltas(rng, (64, 4))
        mask = rng.random(len(ids)) < 0.8
        assert mine.push(ids, deltas, mask) == ref.push(ids, deltas, mask) == one.push(ids, deltas, mask)
        probe = rng.integers(-3, 105, 32)
        assert mine.pull(probe).numpy().tobytes() == np.asarray(ref.pull(probe)).tobytes()
    assert mine.values().tobytes() == ref.values().tobytes() == one.values().tobytes()
    assert mine.stats()["rows_applied"] == ref.stats()["rows_applied"]
    for s in (mine, one, ref):
        s.close()


def test_pull_lands_on_the_first_device_and_blocks_on_theirs():
    """:201 — the no-host-copy contract: a pull's rows are a tensor on the
    layout's first device; block i is a tensor on devices[i]."""
    store = _store(128, (2,))
    out = store.pull(np.arange(16))
    assert isinstance(out, torch.Tensor) and out.device == store.device
    assert table_sharding(store.mesh) == tuple(b.device for b in store.blocks)
    assert len(store.blocks) == N and all(b.shape == (16, 2) for b in store.blocks)
    assert torch.equal(store.pull(torch.arange(16)), out)
    with pytest.raises(AttributeError, match="blocks"):
        store.table
    store.close()


def test_push_without_mask_and_clip():
    """:217"""
    store = _store(32, ())
    ids = np.array([0, 5, 5, 31])
    deltas = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    store.push(ids, deltas)
    want = np.zeros(32, np.float32)
    np.add.at(want, ids, deltas)
    assert np.array_equal(store.values(), want)
    store.close()


def test_wal_recovery_is_bitwise(rng, tmp_path):
    """:227 — a fresh 8-block store over the journal replays every push."""
    wal = str(tmp_path / "wal")
    store = _store(64, (3,), wal_dir=wal)
    for _ in range(4):
        ids = rng.integers(0, 64, 48)
        store.push(ids, rng.normal(0, 1, (48, 3)).astype(np.float32), rng.random(48) < 0.9)
    live = store.values()
    seq = store._push_seq
    store.close()
    again = _store(64, (3,), wal_dir=wal)
    assert again._push_seq == seq
    assert again.values().tobytes() == live.tobytes()
    again.close()


def test_verify_against_log(rng, tmp_path):
    """:244"""
    store = _store(64, (), wal_dir=str(tmp_path / "wal"))
    for _ in range(3):
        store.push(rng.integers(0, 64, 32), rng.normal(0, 1, 32).astype(np.float32))
    assert store.verify_against_log()
    store._apply(np.array([1]), np.array([5.0], np.float32), None)
    assert not store.verify_against_log()
    store.close()


def test_zero1_opt_state_is_sharded_not_replicated(rng):
    """:264 — each block keeps its own velocity: per-device bytes are
    (table + optimizer state) / n, never a replica."""
    store = _store(256, (4,), momentum=0.5)
    store.push(rng.integers(0, 256, 64), _int_deltas(rng, (64, 4)))
    s = store.stats()
    assert s["devices"] == N
    assert s["opt_state_bytes"] == s["table_bytes"]
    assert s["bytes_per_device"] * N == s["table_bytes"] + s["opt_state_bytes"]
    assert [v.shape for v in store.opt_state] == [b.shape for b in store.blocks]
    assert all(v.device == b.device for v, b in zip(store.opt_state, store.blocks))
    store.close()
    plain = _store(256, (4,))
    sp = plain.stats()
    assert sp["opt_state_bytes"] == 0 and sp["bytes_per_device"] * N == sp["table_bytes"]
    plain.close()


def test_momentum_update_matches_numpy_oracle(rng):
    """:287 — vel = mu·vel + dense; table += vel, exact on integer inputs
    with mu 0.5, every block stepping its velocity each push."""
    store = _store(40, (2,), momentum=0.5)
    table = np.zeros((40, 2), np.float32)
    vel = np.zeros((40, 2), np.float32)
    for _ in range(3):
        ids = rng.integers(0, 40, 24)
        deltas = _int_deltas(rng, (24, 2))
        store.push(ids, deltas)
        dense = np.zeros((40, 2), np.float32)
        np.add.at(dense, ids, deltas)
        vel = 0.5 * vel + dense
        table = table + vel
    assert np.array_equal(store.values(), table)
    store.close()


def test_misaligned_partitioner_rejected_at_construction():
    """:307 — 100 rows over 8 blocks are 16-row blocks: a 3-shard split
    straddles them."""
    with pytest.raises(MisalignedTable):
        _store(100, (), partitioner=RangePartitioner(100, 3))
    _store(100, (), partitioner=RangePartitioner(100, 3).block_aligned(N)).close()


def test_batch_surface_and_counters():
    """:323"""
    store = _store(64, ())
    client = MeshClient(store, worker="0")
    assert client.push_batch(np.array([1, 1, 2, 9]), np.array([1.0, 1.0, 2.0, 3.0], np.float32),
                             np.array([True, True, True, False])) == 3
    assert client.rows_pushed == 3
    got = client.pull_batch(np.array([1, 2, 9])).numpy()
    assert np.array_equal(got, np.array([2.0, 2.0, 0.0], np.float32))
    assert client.hotcache is None
    assert client.shard_stats()[0]["backend"] == "mesh" and client.shard_stats()[0]["devices"] == N
    store.close()


def test_event_api_drain():
    """:339"""
    store = _store(16, ())
    client = MeshClient(store)
    client.push(3, 2.0)
    client.push(3, torch.tensor(1.0))
    client.pull(3)
    got = {}
    n = client.drain(on_pull_recv=lambda pid, v, c: got.__setitem__(pid, float(v)))
    assert n == 1 and got == {3: 3.0}
    store.close()


def _run(name, params, n=N, **kw):
    kw.setdefault("num_shards", 2)
    kw.setdefault("num_workers", 1)
    kw.setdefault("staleness_bound", 0)
    wl = create_workload(name, WorkloadParams(**params), device="cpu")
    cfg = ClusterConfig(store_backend="mesh", mesh_devices=["cpu"] * n, **kw)
    with build_cluster_driver(wl, config=cfg, registry=False) as driver:
        result = driver.run(wl.batches(), timeout=120)
        assert driver.mesh_store.n_devices == n and driver.partitioner.rows_per_shard % driver.mesh_store.block_rows == 0
        if kw.get("wal_dir"):
            assert driver.mesh_store.verify_against_log()
    return wl, result


def _ref_run(name, params, **kw):
    kw.setdefault("num_shards", 2)
    kw.setdefault("num_workers", 1)
    kw.setdefault("staleness_bound", 0)
    wl = ref_create(name, RefParams(**params))
    with ref_build(wl, config=RefConfig(store_backend="mesh", **kw), registry=False) as driver:
        return driver.run(wl.batches()).values


def test_pa_bsp_bitwise_vs_streaming_oracle(mesh_devices):
    """:376 — PA at one worker, 8 blocks: bitwise its streaming oracle and
    the one-block run; within the cross-package bar of the reference's
    8-device run."""
    pa, result = _run("pa", SMALL)
    oracle = pa.oracle_values()
    assert np.array_equal(result.values, oracle)
    assert pa.parity_verdict(result.values, oracle).ok
    assert result.shard_stats[0]["backend"] == "mesh" and result.shard_stats[0]["pushes"] > 0
    assert result.values.tobytes() == _run("pa", SMALL, n=1)[1].values.tobytes()
    np.testing.assert_allclose(result.values, _ref_run("pa", SMALL), **CROSS)


def test_pa_bitwise_at_the_fusion_sensitive_shape(mesh_devices):
    """:394"""
    p = dict(rounds=10, batch=64, num_items=48, seed=0)
    pa, result = _run("pa", p)
    assert np.array_equal(result.values, pa.oracle_values())
    np.testing.assert_allclose(result.values, _ref_run("pa", p), **CROSS)


def test_mf_bsp_parity_two_workers(mesh_devices):
    """:405 — MF at two workers within rtol 1e-4 / atol 1e-6 of the
    single-process oracle (the reference's bar) and of the reference's
    8-device run."""
    mf, result = _run("mf", SMALL, num_workers=2)
    np.testing.assert_allclose(result.values, mf.oracle_values(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(result.values, _ref_run("mf", SMALL, num_workers=2), rtol=1e-4, atol=1e-6)
    assert result.clock["staleness"] == 0 and result.clock["clocks"] == [SMALL["rounds"]] * 2


def test_sketch_integer_exact_two_workers(mesh_devices):
    """:422 — counts through 8 blocks at two workers: the exact bincount,
    and the reference's 8-device table exactly."""
    sk, result = _run("sketch", SMALL, num_workers=2)
    oracle = sk.oracle_values()
    assert np.array_equal(result.values, oracle)
    assert sk.parity_verdict(result.values, oracle).ok
    assert np.array_equal(result.values, _ref_run("sketch", SMALL, num_workers=2))


def test_wal_dir_flows_to_the_blocks(tmp_path):
    """:447 — the WAL journals the 8-block run; the audit rebuilds it
    bitwise; the final values are a host array."""
    pa, result = _run("pa", SMALL, wal_dir=str(tmp_path))
    assert type(result.values) is np.ndarray and result.values.shape == (pa.capacity,)
    assert result.shard_stats[0]["wal_records"] > 0
