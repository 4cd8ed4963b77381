"""The port's resilience layer: the WAL, chaos plans, supervised restart
and health, mirroring tests/test_resilience.py against the port.

``TestWAL`` (6), ``TestChaos`` (5), ``TestRecoveryE2E`` (6) and
``TestHealth`` (5) are the reference's tests with the port's driver and
CPU tensors; the recovered tables are held bit for bit against the
uninterrupted run.  The reference's ``TestSocketReconnect`` and
``TestServingRestart`` wait for the socket source, the serving stack and
the cluster (ROADMAP Queue 1 #5-#7).  Port-only: torch's device errors
classify as DEVICE, the WAL logs host arrays only, and the flight
recorder names its folder after the torch device type.
"""
import io
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu_torch.resilience import (
    ChaosError,
    FailureClass,
    FaultPlan,
    HealthMonitor,
    RecoveringDriver,
    RecoveryFailed,
    RestartPolicy,
    StallWatchdog,
    UpdateWAL,
    classify_failure,
    corrupt_latest_checkpoint,
)
from flink_parameter_server_tpu_torch.training.driver import (
    DriverConfig,
    StreamingDriver,
    TrainingDiverged,
    _host_batch,
)

torch.set_num_threads(2)

pytestmark = pytest.mark.chaos


def _payload(i):
    return {"x": np.arange(4, dtype=np.int32) + i, "y": np.float32(i) * np.ones(2, np.float32)}


class TestWAL:
    def test_append_replay_round_trip(self, tmp_path):
        wal = UpdateWAL(str(tmp_path / "wal"))
        for i in range(8):
            assert wal.append(i, 1, _payload(i))
        recs = wal.replay(after_step=3)
        assert [r.end_step for r in recs] == [4, 5, 6, 7, 8]
        for r in recs:
            np.testing.assert_array_equal(r.payload["x"], np.arange(4, dtype=np.int32) + r.start_step)
        wal.close()

    def test_idempotent_append_by_step(self, tmp_path):
        wal = UpdateWAL(str(tmp_path / "wal"))
        assert wal.append(0, 1, _payload(0))
        assert not wal.append(0, 1, _payload(99))
        assert wal.records_skipped == 1
        assert wal.append(1, 1, _payload(1))
        wal.close()

    def test_segment_rotation_and_truncate(self, tmp_path):
        d = str(tmp_path / "wal")
        wal = UpdateWAL(d, segment_bytes=256)
        for i in range(10):
            wal.append(i, 1, _payload(i))
        assert wal.segments_rotated >= 2
        n_before = len(os.listdir(d))
        removed = wal.truncate_through(6)
        assert removed >= 1
        assert len(os.listdir(d)) == n_before - removed
        assert {r.end_step for r in wal.replay(after_step=6)} == {7, 8, 9, 10}
        wal.close()

    def test_reopen_recovers_cursor_and_tolerates_torn_tail(self, tmp_path):
        d = str(tmp_path / "wal")
        wal = UpdateWAL(d)
        for i in range(5):
            wal.append(i, 1, _payload(i))
        wal.close()
        seg = sorted(os.listdir(d))[-1]
        with open(os.path.join(d, seg), "r+b") as fh:
            fh.seek(-7, 2)
            fh.write(b"garbage")
        wal2 = UpdateWAL(d)
        assert wal2.last_step_logged == 4
        assert [r.end_step for r in wal2.replay()] == [1, 2, 3, 4]
        assert wal2.append(4, 1, _payload(4))
        assert wal2.last_step_logged == 5
        wal2.close()

    def test_drop_after_discards_poisoned_tail(self, tmp_path):
        wal = UpdateWAL(str(tmp_path / "wal"), segment_bytes=256)
        for i in range(10):
            wal.append(i, 1, _payload(i))
        dropped = wal.drop_after(4)
        assert dropped == 6
        assert wal.last_step_logged == 4
        assert [r.end_step for r in wal.replay()] == [1, 2, 3, 4]
        assert not wal.append(3, 1, _payload(3))
        assert wal.append(4, 1, _payload(4))
        wal.close()

    def test_max_bytes_warns_but_keeps_appending(self, tmp_path):
        wal = UpdateWAL(str(tmp_path / "wal"), max_bytes=64)
        with pytest.warns(RuntimeWarning, match="max_bytes"):
            for i in range(3):
                wal.append(i, 1, _payload(i))
        assert wal.records_appended == 3
        wal.close()


class TestChaos:
    def test_from_seed_deterministic(self):
        a = FaultPlan.from_seed(7, horizon=30)
        b = FaultPlan.from_seed(7, horizon=30)
        assert a.faults == b.faults
        assert FaultPlan.from_seed(8, horizon=30).faults != a.faults

    def test_driver_hook_fires_once(self):
        plan = FaultPlan().crash_at(5)
        hook = plan.driver_hook()
        hook(4, 1, None, None, None)
        with pytest.raises(ChaosError):
            hook(5, 1, None, None, None)
        hook(6, 1, None, None, None)

    def test_source_faults_shared_across_rewraps(self):
        plan = FaultPlan().source_error_at(3)
        it = plan.wrap_source(range(10))
        got = []
        with pytest.raises(ChaosError):
            for x in it:
                got.append(x)
        assert got == [0, 1, 2]
        assert list(plan.wrap_source(range(10))) == list(range(10))

    def test_classify_failure(self):
        assert classify_failure(TrainingDiverged("x", step=3)) is FailureClass.DIVERGED
        assert classify_failure(ConnectionResetError()) is FailureClass.SOURCE
        assert classify_failure(ChaosError("x", "source")) is FailureClass.SOURCE
        assert classify_failure(ChaosError("x", "device")) is FailureClass.DEVICE
        assert classify_failure(KeyError("x")) is FailureClass.UNKNOWN

    def test_backoff_capped_and_jitterable(self):
        pol = RestartPolicy(backoff_base_s=0.1, backoff_cap_s=0.4, jitter=0.0)
        rng = np.random.default_rng(0)
        assert pol.backoff_s(1, rng) == pytest.approx(0.1)
        assert pol.backoff_s(2, rng) == pytest.approx(0.2)
        assert pol.backoff_s(10, rng) == pytest.approx(0.4)
        pol_j = RestartPolicy(backoff_base_s=0.1, backoff_cap_s=0.4, jitter=1.0)
        vals = {pol_j.backoff_s(3, rng) for _ in range(8)}
        assert len(vals) > 1 and all(0 <= v <= 0.4 for v in vals)


def test_torch_device_errors_classify_as_device():
    """The port's counterpart of the reference's XlaRuntimeError rule."""
    assert classify_failure(torch.cuda.OutOfMemoryError("CUDA out of memory.")) is FailureClass.DEVICE
    if hasattr(torch, "AcceleratorError"):
        assert classify_failure(torch.AcceleratorError("CUDA error: an illegal memory access")) is (
            FailureClass.DEVICE)
    assert classify_failure(RuntimeError("CUDA error: device-side assert triggered")) is FailureClass.DEVICE
    assert classify_failure(RuntimeError("shape mismatch")) is FailureClass.UNKNOWN


# ---------------------------------------------------------------------------
# the e2e recovery paths (MF on the port's driver, CPU, seeded)
# ---------------------------------------------------------------------------


def _mf_parts(num_users=48, num_items=128, dim=4):
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization,
        SGDUpdater,
    )
    from flink_parameter_server_tpu_torch.utils.initializers import normal_factor

    logic = OnlineMatrixFactorization(num_users, dim, updater=SGDUpdater(0.01), device="cpu")
    store = ShardedParamStore.create(num_items, (dim,), init_fn=normal_factor(1, (dim,)), device="cpu")
    return logic, store


def _mf_stream(num_users=48, num_items=128, n_batches=16, batch=32, seed=0):
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches

    cols = synthetic_ratings(num_users, num_items, n_batches * batch, seed=seed)
    return lambda: microbatches(cols, batch, epochs=1, shuffle_seed=seed)


_FAST_POLICY = RestartPolicy(max_restarts=3, jitter=0.0, backoff_base_s=0.001)


class TestRecoveryE2E:
    def test_crash_recover_bitwise_equals_uninterrupted(self, tmp_path):
        stream = _mf_stream()
        logic, store = _mf_parts()
        oracle_drv = StreamingDriver(logic, store, config=DriverConfig(dump_model=False))
        oracle = oracle_drv.run(stream(), collect_outputs=False)

        logic2, store2 = _mf_parts()
        drv = StreamingDriver(
            logic2, store2,
            config=DriverConfig(dump_model=False, checkpoint_every=5, checkpoint_dir=str(tmp_path / "ckpt"),
                                wal_dir=str(tmp_path / "wal")),
        )
        drv.add_group_hook(FaultPlan().crash_at(11).driver_hook())
        sink = io.StringIO()
        rec = RecoveringDriver(drv, stream, policy=_FAST_POLICY, metrics_sink=sink)
        res = rec.run(collect_outputs=False)

        assert rec.restarts == 1
        assert drv.step_idx == oracle_drv.step_idx
        assert torch.equal(oracle.store.values(), res.store.values())
        assert torch.equal(oracle.worker_state, res.worker_state)
        event = json.loads(sink.getvalue().splitlines()[0])
        assert event["failure"] == "device"
        assert event["restored_step"] == 10
        assert event["replayed_steps"] >= 1

    def test_source_error_recovers_without_loss(self, tmp_path):
        stream_fn = _mf_stream()
        logic, store = _mf_parts()
        oracle = StreamingDriver(logic, store, config=DriverConfig(dump_model=False)).run(
            stream_fn(), collect_outputs=False)

        logic2, store2 = _mf_parts()
        drv = StreamingDriver(
            logic2, store2,
            config=DriverConfig(dump_model=False, checkpoint_every=4, checkpoint_dir=str(tmp_path / "ckpt"),
                                wal_dir=str(tmp_path / "wal")),
        )
        plan = FaultPlan().source_error_at(9)
        rec = RecoveringDriver(drv, lambda: plan.wrap_source(stream_fn()), policy=_FAST_POLICY)
        res = rec.run(collect_outputs=False)
        assert rec.restarts == 1
        assert rec.events[0]["failure"] == "source"
        assert torch.equal(oracle.store.values(), res.store.values())

    def test_diverged_drops_poison_window_and_survives(self, tmp_path):
        def poisoned_stream():
            for i, b in enumerate(_mf_stream()()):
                if i == 9:
                    b = dict(b)
                    r = b["rating"].copy()
                    r[0] = np.inf
                    b["rating"] = r
                yield b

        logic, store = _mf_parts()
        drv = StreamingDriver(
            logic, store,
            config=DriverConfig(dump_model=False, checkpoint_every=4, nan_check_every=1,
                                checkpoint_dir=str(tmp_path / "ckpt"), wal_dir=str(tmp_path / "wal")),
        )
        rec = RecoveringDriver(drv, poisoned_stream, policy=_FAST_POLICY)
        res = rec.run(collect_outputs=False)
        assert rec.restarts == 1
        assert rec.events[0]["failure"] == "diverged"
        assert rec.steps_dropped >= 1
        assert torch.isfinite(res.store.values()).all()

    def test_restart_budget_exhausts(self, tmp_path):
        logic, store = _mf_parts()
        drv = StreamingDriver(
            logic, store, config=DriverConfig(dump_model=False, checkpoint_dir=str(tmp_path / "ckpt")),
        )

        def always_failing():
            raise ConnectionResetError("producer is gone")
            yield  # pragma: no cover

        rec = RecoveringDriver(
            drv, always_failing, policy=RestartPolicy(max_restarts=2, jitter=0.0, backoff_base_s=0.0),
        )
        with pytest.raises(RecoveryFailed) as ei:
            rec.run()
        assert len(ei.value.events) == 3

    def test_corrupt_checkpoint_falls_back_to_previous(self, tmp_path):
        from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
        from flink_parameter_server_tpu_torch.training import checkpoint as ckpt
        from flink_parameter_server_tpu_torch.utils.initializers import normal_factor

        d = str(tmp_path / "ckpt")
        store = ShardedParamStore.create(32, (4,), init_fn=normal_factor(1, (4,)), device="cpu")
        want = store.values().clone()
        mgr = ckpt.JobCheckpointManager(d)
        mgr.save(1, store)
        mgr.save(2, ShardedParamStore(store.spec, store.table + 1.0))
        mgr.close()
        corrupt_latest_checkpoint(d, seed=0)
        mgr2 = ckpt.JobCheckpointManager(d)
        with pytest.warns(RuntimeWarning, match="falling back"):
            restored = mgr2.restore_latest(store.spec, "cpu")
        assert restored is not None
        st, _state, meta = restored
        assert meta["step"] == 1
        assert torch.equal(st.values(), want)
        mgr2.close()

    def test_wal_truncation_lags_one_checkpoint(self, tmp_path):
        logic, store = _mf_parts()
        drv = StreamingDriver(
            logic, store,
            config=DriverConfig(dump_model=False, checkpoint_every=4, checkpoint_dir=str(tmp_path / "ckpt"),
                                wal_dir=str(tmp_path / "wal")),
        )
        drv.run(_mf_stream()(), collect_outputs=False)
        assert drv.wal.replay(after_step=12)


def test_corrupt_latest_with_wal_stays_lossless(tmp_path):
    """A crash, then the newest checkpoint corrupt: a fresh driver falls
    back one checkpoint and the kept WAL interval replays the difference,
    bitwise equal to the uninterrupted run."""
    stream = _mf_stream()
    logic, store = _mf_parts()
    oracle = StreamingDriver(logic, store, config=DriverConfig(dump_model=False)).run(stream())
    cfg = DriverConfig(dump_model=False, checkpoint_every=4, checkpoint_dir=str(tmp_path / "ckpt"),
                       wal_dir=str(tmp_path / "wal"))
    logic, store = _mf_parts()
    first = StreamingDriver(logic, store, config=cfg)
    first.add_group_hook(FaultPlan().crash_at(10).driver_hook())
    with pytest.raises(ChaosError):
        first.run(stream())
    assert first._ckpt_mgr.all_steps() == [4, 8]
    corrupt_latest_checkpoint(str(tmp_path / "ckpt"), seed=3)
    logic, store = _mf_parts()
    drv = StreamingDriver(logic, store, config=cfg)
    with pytest.warns(RuntimeWarning, match="falling back"):
        assert drv.resume() and drv.step_idx == 4
    replayed = RecoveringDriver(drv, stream)._replay_wal_tail(4)
    assert replayed >= 6  # steps 5..10 at least; the source ran ahead of the crash
    drv._pending_skip = drv.step_idx
    res = drv.run(stream())
    assert torch.equal(oracle.store.values(), res.store.values())
    assert torch.equal(oracle.worker_state, res.worker_state)


def test_wal_logs_host_arrays_only(tmp_path):
    """A batch the source yields as tensors is logged as numpy, so reading
    the log back needs no card."""
    batch = {"user": torch.arange(4), "rating": torch.ones(4), "mask": np.ones(4, bool)}
    host = _host_batch(batch)
    assert all(isinstance(v, np.ndarray) for v in host.values())
    wal = UpdateWAL(str(tmp_path / "wal"))
    wal.append(0, 1, host)
    (rec,) = wal.replay()
    assert "torch" not in pickle.dumps(rec.payload).decode("latin-1")
    np.testing.assert_array_equal(rec.payload["user"], np.arange(4))
    wal.close()


def test_driver_wal_records_replay_as_the_stream(tmp_path):
    stream = _mf_stream(n_batches=6)
    logic, store = _mf_parts()
    drv = StreamingDriver(logic, store, config=DriverConfig(dump_model=False, wal_dir=str(tmp_path / "wal")))
    drv.run(stream())
    recs = drv.wal.replay()
    assert [r.end_step for r in recs] == [1, 2, 3, 4, 5, 6]
    for rec, batch in zip(recs, stream()):
        for k in batch:
            np.testing.assert_array_equal(rec.payload[k], batch[k])


def test_flight_recorder_dumps_under_the_device_type(tmp_path):
    from flink_parameter_server_tpu_torch.telemetry import FlightRecorder

    rec = FlightRecorder(capacity=8)
    expect = "cuda" if torch.cuda.is_available() else "cpu"
    assert os.path.basename(rec._dir()) == expect
    rec = FlightRecorder(capacity=8, results_dir=str(tmp_path))
    rec.note("crash", failure="device")
    path = rec.dump("crash_device")
    doc = json.load(open(path))
    assert doc["reason"] == "crash_device" and doc["events"][0]["kind"] == "crash"


class TestHealth:
    def test_watchdog_fires_on_frozen_component(self):
        mon = HealthMonitor()
        mon.beat("ingest")
        mon.beat("train")
        stalls = []
        sink = io.StringIO()
        wd = StallWatchdog(mon, 0.05, on_stall=lambda c, a: stalls.append(c), sink=sink)
        time.sleep(0.1)
        mon.beat("train")
        events = wd.check_once()
        assert [e["stall"] for e in events] == ["ingest"]
        assert stalls == ["ingest"]
        line = json.loads(sink.getvalue().splitlines()[0])
        assert line["stall"] == "ingest" and line["age_s"] > 0.05

    def test_one_event_per_episode_and_rearm(self):
        mon = HealthMonitor()
        mon.beat("ingest")
        wd = StallWatchdog(mon, 0.04)
        time.sleep(0.08)
        assert wd.check_once()
        assert not wd.check_once()
        mon.beat("ingest")
        assert not wd.check_once()
        time.sleep(0.08)
        assert wd.check_once()

    def test_never_beaten_component_not_stalled(self):
        mon = HealthMonitor()
        mon.beat("train")
        time.sleep(0.06)
        wd = StallWatchdog(mon, 0.03)
        assert [e["stall"] for e in wd.check_once()] == ["train"]
        assert "serving_dispatch" not in {e["stall"] for e in wd.events}

    def test_driver_beats_ingest_and_train(self):
        mon = HealthMonitor()
        logic, store = _mf_parts()
        drv = StreamingDriver(logic, store, config=DriverConfig(dump_model=False), health=mon)
        drv.run(_mf_stream(n_batches=4)(), collect_outputs=False)
        assert mon.beats("ingest") == 4
        assert mon.beats("train") == 4

    def test_watchdog_thread_lifecycle(self):
        mon = HealthMonitor()
        mon.beat("ingest")
        with StallWatchdog(mon, 0.02, poll_s=0.01) as wd:
            time.sleep(0.1)
        assert wd.events and wd.events[0]["stall"] == "ingest"
