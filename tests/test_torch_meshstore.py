"""The port's mesh store (the whole table as one tensor on the device)
against the JAX package's and against numpy oracles.

Parity (the port on ``device="cpu"``):
  * ``MeshParamStore`` pull/push against a numpy oracle (integer-valued
    float32 deltas: exact whatever the order duplicates are summed in) and
    against the reference's ``MeshParamStore`` on ``jax.devices()[:1]``
    (bitwise: pushes of unique ids, and integer-valued deltas with
    duplicates);
  * WAL recovery and ``verify_against_log``: bitwise;
  * the momentum arm against a numpy oracle: exact on integer inputs with
    mu 0.5;
  * ``ClusterDriver(store_backend="mesh")``: MF under BSP at two workers
    within rtol 1e-4 / atol 1e-6 of the single-process table (the
    reference's bar), at one worker bitwise repeatable and within the
    port's MF tolerance (rtol 1e-5 / atol 1e-6) of the reference's mesh
    run.

Mirrors tests/test_meshstore.py, 35 tests: here are TestLayout (6, the
row block held against the port's single-device ``StoreSpec``),
TestMeshParamStore (9; the ZeRO-1 test checks the one-device byte
arithmetic and the device-tensor test the device the rows stay on),
TestMeshClient (2), TestMeshDriverParity (6: MF, final values, WAL, and
the three that build their drivers through ``workloads/``: PA bitwise
against its streaming oracle, PA at the fusion-sensitive shape, the sketch
integer-exact against the numpy bincount), TestMeshStalenessSemantics (2,
the staleness gauge read off the registry), TestMeshConfigGuards (5) and
TestMeshTelemetry (1, driven by MF).  Left for the benchmark cells (ROADMAP Queue 1):
TestMeshAbLint's four tests of the benchmark's A/B artifact lint.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.cluster import ClusterConfig as RefConfig
from flink_parameter_server_tpu.cluster import ClusterDriver as RefDriver
from flink_parameter_server_tpu.meshstore import MeshParamStore as RefMeshStore
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch.cluster.driver import ClusterConfig, ClusterDriver
from flink_parameter_server_tpu_torch.cluster.partition import (
    ConsistentHashPartitioner,
    RangePartitioner,
    mesh_row_block,
)
from flink_parameter_server_tpu_torch.core.store import ShardedParamStore, StoreSpec
from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
from flink_parameter_server_tpu_torch.data.streams import microbatches
from flink_parameter_server_tpu_torch.meshstore import (
    MeshClient,
    MeshParamStore,
    MisalignedTable,
    StoreLayout,
    aligned_partitioner,
    check_alignment,
    make_store_mesh,
)
from flink_parameter_server_tpu_torch.models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
)
from flink_parameter_server_tpu_torch.telemetry.hotkeys import get_aggregator
from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry
from flink_parameter_server_tpu_torch.training.driver import DriverConfig, StreamingDriver
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor
from flink_parameter_server_tpu_torch.workloads import WorkloadParams

torch.set_num_threads(2)

pytestmark = pytest.mark.meshstore

CPU = "cpu"
# the reference's tests/test_meshstore.py SMALL workload shape
WL_SMALL = WorkloadParams(rounds=6, batch=48, num_users=24, num_items=32, dim=4, seed=3)
BAR = dict(rtol=1e-4, atol=1e-6)
MF_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def _store(capacity, value_shape=(), **kw):
    kw.setdefault("registry", False)
    return MeshParamStore(capacity, value_shape, device=CPU, **kw)


def _int_deltas(rng, shape):
    """Integer-valued fp32: adds are exact, so the scatter's combine
    order cannot blur the oracle comparison."""
    return rng.integers(-8, 9, shape).astype(np.float32)


def _mf(rounds=6, batch=48, nu=64, ni=96, dim=8):
    cols = synthetic_ratings(nu, ni, rounds * batch, seed=3)
    return list(microbatches(cols, batch)), nu, ni, dim


def _logic(nu, dim, cls=OnlineMatrixFactorization):
    return cls(nu, dim, updater=SGDUpdater(0.05), seed=1, device=CPU)


def _mesh_driver(nu, ni, dim, registry=False, driver_cls=ClusterDriver, logic=None, **kw):
    kw.setdefault("num_shards", 2)
    kw.setdefault("num_workers", 1)
    kw.setdefault("staleness_bound", 0)
    return driver_cls(
        logic if logic is not None else _logic(nu, dim), capacity=ni, value_shape=(dim,),
        init_fn=ranged_random_factor(7, (dim,)),
        config=ClusterConfig(store_backend="mesh", **kw), registry=registry, device=CPU,
    )


# ---------------------------------------------------------------------------
# the reference's store, the layout, the knobs the slice leaves out
# ---------------------------------------------------------------------------


def test_store_matches_the_reference_mesh_store(rng):
    ref = RefMeshStore(100, (4,), devices=jax.devices()[:1], registry=False)
    mine = _store(100, (4,))
    for i in range(6):
        if i % 2:  # unique ids, float deltas: bitwise
            ids = rng.choice(100, 40, replace=False)
            deltas = rng.normal(size=(40, 4)).astype(np.float32)
        else:  # duplicates, integer-valued deltas: exact in any order
            ids = rng.integers(0, 100, 64)
            deltas = _int_deltas(rng, (64, 4))
        mask = rng.random(len(ids)) < 0.8
        assert mine.push(ids, deltas, mask) == ref.push(ids, deltas, mask)
        probe = rng.integers(-3, 105, 32)  # out-of-range ids clip on both
        assert mine.pull(probe).numpy().tobytes() == np.asarray(ref.pull(probe)).tobytes()
    assert mine.values().tobytes() == ref.values().tobytes()
    assert mine.stats()["rows_applied"] == ref.stats()["rows_applied"]
    mine.close()
    ref.close()


def test_layout_is_one_device_and_a_mesh_raises():
    """The layout is a device list, one row block an entry (a device may
    repeat: tests/test_torch_meshstore_blocks.py runs 8 blocks); a mesh
    that is not a layout raises."""
    lay = make_store_mesh(device=CPU)
    assert isinstance(lay, StoreLayout) and lay.n_devices == 1
    assert lay.shape == {"shard": 1} and lay.device.type == "cpu"
    assert make_store_mesh([torch.device("cpu")]).device.type == "cpu"
    two = make_store_mesh(["cpu", "cpu"])
    assert two.n_devices == 2 and two.shape == {"shard": 2} and two.devices == (torch.device("cpu"),) * 2
    store = MeshParamStore(16, (), mesh=two, registry=False)
    assert [tuple(b.shape) for b in store.blocks] == [(8,), (8,)] and store.stats()["devices"] == 2
    store.close()
    with pytest.raises(TypeError, match="StoreLayout"):
        MeshParamStore(16, (), mesh=object(), registry=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            MeshParamStore(16, (), registry=False)  # the default is the card


def test_mesh_driver_knobs_that_raise():
    batches, nu, ni, dim = _mf(rounds=1)
    # wire_proto="shm" is accepted and moves nothing: the mesh's workers
    # reach the table through a MeshClient, with no shard wire to carry
    with _mesh_driver(nu, ni, dim, wire_proto="shm") as d:
        shm = d.run(batches).values
        assert all(type(c).__name__ == "MeshClient" for c in d._clients)
    with _mesh_driver(nu, ni, dim) as d:
        assert d.run(batches).values.tobytes() == shm.tobytes()
    # the mesh topology builds its clock through _make_clock too, so
    # adaptive=True gives it the adaptive clock, as the reference's does
    with _mesh_driver(nu, ni, dim, adaptive=True) as d:
        assert type(d.clock).__name__ == "AdaptiveClock"
        d.run(batches)
    # hot_keys is accepted, as the reference's mesh driver accepts it: the
    # mesh has no shard to observe, so no sketch is registered
    agg = get_aggregator()
    before = agg.labels()
    with _mesh_driver(nu, ni, dim, hot_keys=True) as d:
        d.run(batches)
        assert agg.labels() == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ClusterDriver(_logic(nu, dim), capacity=ni, value_shape=(dim,),
                          config=ClusterConfig(store_backend="mesh"), registry=False)


def test_step_gets_the_pulled_rows_as_device_tensors():
    """The no-host-copy contract end to end: what the mesh gather hands
    the step is the store's own device tensor, never a host array."""
    seen = []

    class Recording(OnlineMatrixFactorization):
        def step(self, state, batch, pulled):
            seen.append((type(pulled), pulled.device.type, batch["item"].device.type))
            return super().step(state, batch, pulled)

    batches, nu, ni, dim = _mf(rounds=3)
    with _mesh_driver(nu, ni, dim, logic=_logic(nu, dim, Recording)) as d:
        d.run(batches)
        assert isinstance(d.mesh_store.table, torch.Tensor)
    assert seen == [(torch.Tensor, "cpu", "cpu")] * 3


# ---------------------------------------------------------------------------
# mirrors of tests/test_meshstore.py
# ---------------------------------------------------------------------------


class TestLayout:
    def test_mesh_row_block_matches_store_spec(self):
        for capacity in (8, 97, 256, 1000):
            assert mesh_row_block(capacity, 1) == StoreSpec(capacity, ()).rows_per_shard

    def test_block_aligned_property(self):
        from hypothesis import given, settings, strategies as st

        @settings(max_examples=60, deadline=None)
        @given(capacity=st.integers(1, 4096), num_shards=st.integers(1, 16),
               n_devices=st.integers(1, 16))
        def check(capacity, num_shards, n_devices):
            num_shards = min(num_shards, capacity)
            part = RangePartitioner(capacity, num_shards)
            aligned = part.block_aligned(n_devices)
            block = mesh_row_block(capacity, n_devices)
            assert aligned.aligned_block == block
            assert aligned.rows_per_shard % block == 0
            assert aligned.rows_per_shard >= part.rows_per_shard
            assert (aligned.rows_per_shard * num_shards) % block == 0
            owned = [aligned.owned_ids(s) for s in range(num_shards)]
            allids = np.concatenate(owned)
            assert np.array_equal(np.sort(allids), np.arange(capacity))
            for s, ids in enumerate(owned):
                if len(ids):
                    assert (aligned.shard_of(ids) == s).all()
            check_alignment(aligned, capacity, n_devices)

        check()

    def test_block_aligned_grid_sweep(self):
        for capacity in (1, 7, 8, 9, 100, 255, 256, 1000):
            for num_shards in (1, 2, 3, 5, 8):
                if num_shards > capacity:
                    continue
                for n_devices in (1, 2, 7, 8, 16):
                    part = RangePartitioner(capacity, num_shards)
                    aligned = part.block_aligned(n_devices)
                    assert aligned.rows_per_shard % mesh_row_block(capacity, n_devices) == 0
                    assert aligned.rows_per_shard >= part.rows_per_shard
                    allids = np.concatenate([aligned.owned_ids(s) for s in range(num_shards)])
                    assert np.array_equal(np.sort(allids), np.arange(capacity))
                    check_alignment(aligned, capacity, n_devices)

    def test_check_alignment_rejects_misaligned_range(self):
        part = RangePartitioner(100, 3)
        assert part.rows_per_shard % mesh_row_block(100, 8) != 0
        with pytest.raises(MisalignedTable, match="block_aligned"):
            check_alignment(part, 100, 8)
        check_alignment(part.block_aligned(8), 100, 8)

    def test_check_alignment_rejects_hash_maps(self):
        with pytest.raises(MisalignedTable, match="RangePartitioner"):
            check_alignment(ConsistentHashPartitioner(64, 4), 64, 8)

    def test_aligned_partitioner_helper(self):
        part = aligned_partitioner(100, 3, 8)
        assert part.rows_per_shard % mesh_row_block(100, 8) == 0
        check_alignment(part, 100, 8)


class TestMeshParamStore:
    def test_pull_push_matches_numpy_oracle(self, rng):
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
        store.close()

    def test_pull_returns_device_array_sharded_over_mesh(self):
        store = _store(128, (2,))
        out = store.pull(np.arange(16))
        assert isinstance(out, torch.Tensor) and out.device == store.device
        assert store.table.device == store.device and store.n_devices == 1
        # device ids gather without a host round trip, to the same rows
        again = store.pull(torch.arange(16, device=store.device))
        assert torch.equal(out, again)
        store.close()

    def test_push_without_mask_and_clip(self, rng):
        store = _store(32, ())
        ids = np.array([0, 5, 5, 31])
        deltas = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
        store.push(ids, deltas)
        want = np.zeros(32, np.float32)
        np.add.at(want, ids, deltas)
        assert np.array_equal(store.values(), want)
        store.close()

    def test_wal_recovery_is_bitwise(self, rng, tmp_path):
        wal = str(tmp_path / "wal")
        store = _store(64, (3,), wal_dir=wal)
        for _ in range(4):
            ids = rng.integers(0, 64, 48)
            store.push(torch.from_numpy(ids), torch.from_numpy(rng.normal(0, 1, (48, 3)).astype(np.float32)),
                       torch.from_numpy(rng.random(48) < 0.9))
        live = store.values()
        seq = store._push_seq
        store.close()
        again = _store(64, (3,), wal_dir=wal)
        assert again._push_seq == seq
        assert again.values().tobytes() == live.tobytes()
        again.close()

    def test_verify_against_log(self, rng, tmp_path):
        store = _store(64, (), wal_dir=str(tmp_path / "wal"))
        for _ in range(3):
            store.push(rng.integers(0, 64, 32), rng.normal(0, 1, 32).astype(np.float32))
        assert store.verify_against_log()
        store._apply(np.array([1]), np.array([5.0], np.float32), None)
        assert not store.verify_against_log()
        store.close()

    def test_momentum_with_wal_is_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="momentum"):
            _store(64, (), momentum=0.9, wal_dir=str(tmp_path / "w"))

    def test_zero1_opt_state_is_sharded_not_replicated(self, rng):
        """At one device the device holds the table and the whole
        velocity buffer: bytes_per_device = table + opt state."""
        store = _store(256, (4,), momentum=0.5)
        store.push(rng.integers(0, 256, 64), _int_deltas(rng, (64, 4)))
        s = store.stats()
        assert s["devices"] == 1
        assert s["opt_state_bytes"] == s["table_bytes"]
        assert s["bytes_per_device"] == s["table_bytes"] + s["opt_state_bytes"]
        store.close()
        plain = _store(256, (4,))
        sp = plain.stats()
        assert sp["opt_state_bytes"] == 0 and sp["bytes_per_device"] == sp["table_bytes"]
        plain.close()

    def test_momentum_update_matches_numpy_oracle(self, rng):
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

    def test_misaligned_partitioner_rejected_at_construction(self):
        # one device holds one 104-row block: a 34-row shard straddles it
        with pytest.raises(MisalignedTable):
            _store(100, (), partitioner=RangePartitioner(100, 3))
        with pytest.raises(MisalignedTable):
            _store(100, (), partitioner=ConsistentHashPartitioner(100, 3))
        _store(100, (), partitioner=RangePartitioner(100, 3).block_aligned(1)).close()


class TestMeshClient:
    def test_batch_surface_and_counters(self):
        store = _store(64, ())
        client = MeshClient(store, worker="0")
        assert client.push_batch(np.array([1, 1, 2, 9]), np.array([1.0, 1.0, 2.0, 3.0], np.float32),
                                 np.array([True, True, True, False])) == 3
        assert client.rows_pushed == 3
        got = client.pull_batch(np.array([1, 2, 9])).numpy()
        assert np.array_equal(got, np.array([2.0, 2.0, 0.0], np.float32))
        assert client.shard_stats()[0]["backend"] == "mesh"
        store.close()

    def test_event_api_drain(self):
        store = _store(16, ())
        client = MeshClient(store)
        client.push(3, 2.0)
        client.push(3, torch.tensor(1.0))
        client.pull(3)
        got = {}
        n = client.drain(on_pull_recv=lambda pid, v, c: got.__setitem__(pid, float(v)))
        assert n == 1 and got == {3: 3.0}
        store.close()


def _single_process_table(batches, nu, ni, dim):
    store = ShardedParamStore.create(ni, (dim,), init_fn=ranged_random_factor(7, (dim,)), device=CPU)
    driver = StreamingDriver(_logic(nu, dim), store, config=DriverConfig(dump_model=False))
    return driver.run(iter(batches), collect_outputs=False).store.values().numpy()


def _mesh_workload_driver(wl, **kw):
    from flink_parameter_server_tpu_torch.workloads import build_cluster_driver

    kw.setdefault("num_shards", 2)
    kw.setdefault("num_workers", 1)
    kw.setdefault("staleness_bound", 0)
    return build_cluster_driver(
        wl, config=ClusterConfig(store_backend="mesh", **kw), registry=False
    )


class TestMeshDriverParity:
    def test_pa_bsp_bitwise_vs_streaming_oracle(self):
        """The PA bitwise bar, same envelope the socket backend pins
        (one worker: one fp32 add per id per round on both arms)."""
        from flink_parameter_server_tpu_torch.workloads import create_workload

        pa = create_workload("pa", WL_SMALL, device=CPU)
        oracle = pa.oracle_values()
        with _mesh_workload_driver(pa) as driver:
            result = driver.run(pa.batches(), timeout=120)
        assert np.array_equal(result.values, oracle), (
            "mesh-backend BSP PA table is not bitwise the streaming oracle"
        )
        v = pa.parity_verdict(result.values, oracle)
        assert v.ok and "bitwise" in v.detail
        assert result.shard_stats[0]["backend"] == "mesh"
        assert result.shard_stats[0]["pushes"] > 0

    def test_pa_bitwise_at_the_fusion_sensitive_shape(self):
        from flink_parameter_server_tpu_torch.workloads import create_workload

        p = WorkloadParams(rounds=10, batch=64, num_items=48, seed=0)
        pa = create_workload("pa", p, device=CPU)
        with _mesh_workload_driver(pa) as driver:
            result = driver.run(pa.batches(), timeout=120)
        assert np.array_equal(result.values, pa.oracle_values())

    def test_sketch_integer_exact_two_workers(self):
        """Counts are integers and integer adds commute: two
        interleaving workers through the mesh scatter must still land
        the exact bincount — NO tolerance."""
        from flink_parameter_server_tpu_torch.workloads import create_workload

        sk = create_workload("sketch", WL_SMALL, device=CPU)
        with _mesh_workload_driver(sk, num_workers=2) as driver:
            result = driver.run(sk.batches(), timeout=120)
        oracle = sk.oracle_values()
        assert np.array_equal(result.values, oracle)
        v = sk.parity_verdict(result.values, oracle)
        assert v.ok, v.detail

    def test_mf_bsp_parity_two_workers(self):
        batches, nu, ni, dim = _mf()
        base = _single_process_table(batches, nu, ni, dim)
        with _mesh_driver(nu, ni, dim, num_workers=2) as driver:
            result = driver.run(batches)
        np.testing.assert_allclose(result.values, base, **BAR)
        assert result.clock["staleness"] == 0
        assert result.clock["clocks"] == [len(batches)] * 2

    def test_one_worker_repeatable_and_matches_the_reference(self):
        batches, nu, ni, dim = _mf()
        runs = []
        for _ in range(2):
            with _mesh_driver(nu, ni, dim) as driver:
                runs.append(driver.run(batches).values)
        assert runs[0].tobytes() == runs[1].tobytes()
        logic = ref_mf.OnlineMatrixFactorization(nu, dim, updater=ref_mf.SGDUpdater(0.05), seed=1)
        ref = RefDriver(logic, capacity=ni, value_shape=(dim,), init_fn=ref_init(7, (dim,)),
                        config=RefConfig(store_backend="mesh", num_shards=2), registry=False)
        with ref:
            want = ref.run(batches).values
        np.testing.assert_allclose(runs[0], want, **MF_TOL)

    def test_final_values_is_host_ndarray(self):
        batches, nu, ni, dim = _mf(rounds=2)
        with _mesh_driver(nu, ni, dim) as driver:
            driver.run(batches)
            vals = driver.final_values()
        assert type(vals) is np.ndarray and vals.shape == (ni, dim)

    def test_wal_dir_flows_to_mesh_store(self, tmp_path):
        batches, nu, ni, dim = _mf(rounds=3)
        with _mesh_driver(nu, ni, dim, num_workers=2, wal_dir=str(tmp_path)) as driver:
            r = driver.run(batches)
            assert driver.mesh_store.verify_against_log()
            assert driver.mesh_store.stats()["wal_records"] > 0
        # a store rebuilt over the same journal is the run's table
        again = MeshParamStore(ni, (dim,), init_fn=ranged_random_factor(7, (dim,)),
                               wal_dir=str(tmp_path / "mesh"), registry=False, device=CPU)
        assert again.values().tobytes() == r.values.tobytes()
        again.close()


class TestMeshStalenessSemantics:
    def test_ssp_bound_enforced_and_staleness_scrapeable(self):
        bound = 2
        batches, nu, ni, dim = _mf(rounds=10)
        reg = MetricsRegistry()
        driver = _mesh_driver(nu, ni, dim, registry=reg, num_workers=2, staleness_bound=bound)
        release = threading.Event()

        def hold_worker_0(worker, rnd):
            if worker == 0 and rnd == 1:
                assert release.wait(60), "test hung: release never set"

        result, errors = {}, []

        def run():
            try:
                with driver:
                    result["r"] = driver.run(batches, round_hook=hold_worker_0)
            except BaseException as e:  # pragma: no cover
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
        assert driver.clock.clocks() == [1, 1 + bound + 1]
        assert driver.clock.staleness() == bound + 1
        gauge = [i for i in reg.instruments() if i.name == "cluster_staleness_steps"]
        assert gauge and gauge[0].value == bound + 1
        time.sleep(0.05)
        assert driver.clock.clocks()[1] == 1 + bound + 1
        release.set()
        t.join(timeout=120)
        assert not errors, errors
        assert result["r"].clock["clocks"] == [len(batches)] * 2
        assert result["r"].clock["block_counts"][1] >= 1

    def test_async_mode_never_blocks(self):
        batches, nu, ni, dim = _mf()
        with _mesh_driver(nu, ni, dim, num_workers=2, staleness_bound=None) as driver:
            r = driver.run(batches)
        assert r.clock["block_counts"] == [0, 0]
        assert r.clock["clocks"] == [len(batches)] * 2
        assert np.isfinite(r.values).all()


class TestMeshConfigGuards:
    def test_unknown_backend_is_loud(self):
        batches, nu, ni, dim = _mf(rounds=1)
        with pytest.raises(ValueError, match="store_backend"):
            ClusterDriver(_logic(nu, dim), capacity=ni, value_shape=(dim,),
                          config=ClusterConfig(store_backend="rdma"), registry=False, device=CPU)

    def test_elastic_driver_rejects_mesh(self):
        from flink_parameter_server_tpu_torch.elastic.controller import ElasticClusterDriver
        from flink_parameter_server_tpu_torch.workloads import build_cluster_driver, create_workload

        pa = create_workload("pa", WL_SMALL, device=CPU)
        with pytest.raises(NotImplementedError, match="mesh"):
            build_cluster_driver(
                pa, config=ClusterConfig(store_backend="mesh", num_shards=2),
                driver_cls=ElasticClusterDriver, registry=False,
            )

    def test_shard_procs_rejected(self):
        batches, nu, ni, dim = _mf(rounds=1)
        with pytest.raises(ValueError, match="shard_procs"):
            _mesh_driver(nu, ni, dim, shard_procs=True)

    def test_hot_cache_rejected(self):
        batches, nu, ni, dim = _mf(rounds=1)
        with pytest.raises(ValueError, match="hot_cache"):
            _mesh_driver(nu, ni, dim, hot_cache=True)

    def test_hash_partition_rejected(self):
        batches, nu, ni, dim = _mf(rounds=1)
        with pytest.raises(ValueError, match="range"):
            _mesh_driver(nu, ni, dim, partition="hash")


class TestMeshTelemetry:
    def test_instruments_land_and_lint(self):
        import tools.check_metric_lines as lint

        batches, nu, ni, dim = _mf(rounds=3)
        reg = MetricsRegistry()
        with _mesh_driver(nu, ni, dim, registry=reg) as driver:
            driver.run(batches)
        by_name = {}
        for inst in reg.instruments():
            if inst.labels.get("component") == "meshstore":
                by_name.setdefault(inst.name, []).append(inst)
        for name in ("meshstore_gather_seconds", "meshstore_scatter_seconds",
                     "meshstore_pulls_total", "meshstore_pushes_total",
                     "meshstore_rows_pulled_total", "meshstore_rows_pushed_total",
                     "meshstore_collective_ops_total", "meshstore_table_bytes",
                     "meshstore_device_bytes", "meshstore_opt_state_bytes"):
            assert name in by_name, f"missing {name}"
        kinds = {i.labels["kind"] for i in by_name["meshstore_collective_ops_total"]}
        assert kinds == {"gather", "scatter"}
        # one gather per round plus the final dump; one scatter per round
        assert by_name["meshstore_pushes_total"][0].value == 3
        line = reg.emit()
        assert lint.check_lines([line]) == []
        bad = line.replace('"component": "meshstore"', '"component": "meshstor"')
        problems = lint.check_lines([bad])
        assert problems and "meshstor" in problems[0][1]
