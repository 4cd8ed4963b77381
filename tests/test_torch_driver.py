"""The port's StreamingDriver: against the JAX package's, and the
reference's own driver tests run against the port.

Parity: the same seeded numpy stream and the same per-id init go through
the JAX ``StreamingDriver`` (no checkpoint) and the port's, for
``steps_per_call`` 1 and 4 and ``presort`` off and on; the final item
table and user state match at rtol 1e-5 / atol 1e-6 (float32 sums of the
same terms in another order), the tolerance of tests/test_torch_mf.py.

Mirrors: tests/test_driver_determinism.py (all 13 tests; the
event-backend schedule test runs the port's event backend) and tests/test_driver_steps_per_call.py (7 tests; the composed-knobs test
without its 2-shard mesh, since the port is single-device, Queue 1 #9).
Within the port, resume and crash recovery are held bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.core.store import ShardedParamStore as RefStore
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.training import driver as ref_driver
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
from flink_parameter_server_tpu_torch.core.transform import transform, transform_with_model_load
from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
from flink_parameter_server_tpu_torch.data.streams import microbatches
from flink_parameter_server_tpu_torch.models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
    ps_online_mf,
)
from flink_parameter_server_tpu_torch.training.driver import (
    DriverConfig,
    StreamingDriver,
    TrainingDiverged,
    _all_finite,
)
from flink_parameter_server_tpu_torch.utils.initializers import normal_factor, ranged_random_factor

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _driver(tmpdir=None, **cfg_kw):
    logic = OnlineMatrixFactorization(64, 4, updater=SGDUpdater(0.05), device="cpu")
    store = ShardedParamStore.create(96, (4,), init_fn=ranged_random_factor(0, (4,)), device="cpu")
    config = DriverConfig(checkpoint_dir=str(tmpdir) if tmpdir else None, prefetch=2, **cfg_kw)
    return StreamingDriver(logic, store, config=config)


def _stream(n=20, seed=0):
    data = synthetic_ratings(64, 96, n * 128, rank=3, seed=seed)
    return microbatches(data, 128, shuffle_seed=1)


def _vals(d):
    return d.store.values().numpy()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spc", [1, 4])
@pytest.mark.parametrize("presort", [False, True])
def test_driver_matches_jax_driver(spc, presort):
    """The same 20 microbatches of 128 through both drivers (metrics on,
    NaN guard on): the same step count, events, item table and user
    state."""
    kw = dict(metrics_every=5, nan_check_every=5, steps_per_call=spc, presort=presort, prefetch=2)
    ref = ref_driver.StreamingDriver(
        ref_mf.OnlineMatrixFactorization(64, 4, updater=ref_mf.SGDUpdater(0.05)),
        RefStore.create(96, (4,), init_fn=ref_init(0, (4,))),
        config=ref_driver.DriverConfig(**kw),
    )
    want = ref.run(_stream())
    port = StreamingDriver(
        OnlineMatrixFactorization(64, 4, updater=SGDUpdater(0.05), device="cpu"),
        ShardedParamStore.create(96, (4,), init_fn=ranged_random_factor(0, (4,)), device="cpu"),
        config=DriverConfig(**kw),
    )
    got = port.run(_stream())
    assert port.step_idx == ref.step_idx == 20
    assert port.metrics.total_events == ref.metrics.total_events
    np.testing.assert_allclose(got.store.values().numpy(), np.asarray(want.store.values()), **TOL)
    np.testing.assert_allclose(got.worker_state.numpy(), np.asarray(want.worker_state), **TOL)
    np.testing.assert_allclose(got.server_outputs[0][1], np.asarray(want.server_outputs[0][1]), **TOL)


# ---------------------------------------------------------------------------
# tests/test_driver_determinism.py, against the port
# ---------------------------------------------------------------------------


def test_driver_runs_with_metrics(tmp_path):
    d = _driver(metrics_every=5)
    res = d.run(_stream())
    assert d.metrics.total_steps == 20
    snap = d.metrics.snapshot()
    assert snap["updates_per_sec"] > 0 and snap["pull_push_p50_ms"] > 0
    ids, vals = res.server_outputs[0]
    assert vals.shape == (96, 4)


def test_driver_checkpoint_and_resume(tmp_path):
    d1 = _driver(tmp_path, checkpoint_every=10)
    d1.run(_stream())
    assert d1._ckpt_mgr.latest_step() == 20  # final durable save

    d2 = _driver(tmp_path)
    assert d2.resume()
    assert d2.step_idx == 20
    np.testing.assert_array_equal(_vals(d2), _vals(d1))
    assert d2.store.table.device.type == "cpu"  # restored where the store lives
    d2.run(_stream(5, seed=3), fast_forward=False)
    assert d2.step_idx == 25


@pytest.mark.parametrize("presort", [False, True])
def test_driver_resume_does_not_double_apply(tmp_path, presort):
    """Crash-at-step-K resume: re-feeding the same stream fast-forwards past
    the consumed prefix and reproduces the uninterrupted run bit for bit."""
    d_full = _driver(None, presort=presort)
    d_full.run(_stream())
    d_a = _driver(tmp_path, checkpoint_every=10, presort=presort)
    stream = list(_stream())
    d_a.run(iter(stream[:10]))
    d_b = _driver(tmp_path, presort=presort)
    assert d_b.resume() and d_b.step_idx == 10
    d_b.run(iter(stream))
    assert d_b.step_idx == 20
    np.testing.assert_array_equal(_vals(d_b), _vals(d_full))
    np.testing.assert_array_equal(d_b._state.numpy(), d_full._state.numpy())


def test_batched_backend_bitwise_deterministic():
    r1 = ps_online_mf(_stream(), num_users=64, num_items=96, dim=4, collect_outputs=False, device="cpu")
    r2 = ps_online_mf(_stream(), num_users=64, num_items=96, dim=4, collect_outputs=False, device="cpu")
    assert torch.equal(r1.store.values(), r2.store.values())
    assert torch.equal(r1.worker_state, r2.worker_state)


def test_event_backend_waits_for_the_event_api():
    """Mirror of the reference's test_event_backend_schedule_deterministic,
    now that the port has the event backend: the same config and input
    order give the same event schedule, the interleaved (racy) one too."""
    from flink_parameter_server_tpu_torch.core.api import WorkerLogic

    class CountingWorker(WorkerLogic):
        def __init__(self):
            self.pending = {}

        def on_recv(self, data, ps):
            key, inc = data
            self.pending.setdefault(key, []).append(inc)
            ps.pull(key)

        def on_pull_recv(self, param_id, param_value, ps):
            for inc in self.pending.pop(param_id, []):
                ps.push(param_id, inc)
            ps.output((param_id, param_value))

    def run():
        return transform([("k", i) for i in range(30)], CountingWorker, param_init=lambda _k: 0,
                         param_update=lambda c, d: c + d, worker_parallelism=3, input_window=5)

    a, b = run(), run()
    assert a.worker_outputs == b.worker_outputs  # the same stale-read pattern
    assert a.server_outputs == b.server_outputs == [("k", sum(range(30)))]


def test_prefetch_propagates_stream_errors():
    from flink_parameter_server_tpu_torch.data.streams import prefetch

    def broken():
        yield 1
        yield 2
        raise RuntimeError("stream died")

    it = prefetch(broken(), size=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="stream died"):
        next(it)


def test_driver_usable_after_midrun_crash(tmp_path):
    d = _driver(tmp_path, checkpoint_every=5)

    def dying():
        for i, b in enumerate(_stream()):
            if i == 8:
                raise RuntimeError("boom")
            yield b

    with pytest.raises(RuntimeError, match="boom"):
        d.run(dying())
    assert d.step_idx == 5  # reloaded the step-5 checkpoint, as the reference
    assert np.isfinite(_vals(d)).all()
    d.run(_stream(3), fast_forward=False)


def test_nan_guard_detects_and_rolls_back(tmp_path):
    d = _driver(tmp_path, checkpoint_every=5, nan_check_every=1)

    def poisoned():
        for i, b in enumerate(_stream()):
            if i >= 7:
                b = dict(b, rating=b["rating"] * np.nan)
            yield b

    with pytest.raises(TrainingDiverged, match="step 8"):
        d.run(poisoned())
    assert d.step_idx == 5
    assert np.isfinite(_vals(d)).all()


def test_nan_guard_blocks_poisoned_checkpoint(tmp_path):
    d = _driver(tmp_path, checkpoint_every=5, nan_check_every=7)

    def poisoned():
        for i, b in enumerate(_stream()):
            if i == 9:  # global step 10 — a checkpoint step, not a 7-multiple
                b = dict(b, rating=b["rating"] * np.inf)
            yield b

    with pytest.raises(TrainingDiverged, match="step 10"):
        d.run(poisoned())
    assert d.step_idx == 5
    assert d._ckpt_mgr.all_steps() == [5]  # step 10 was never written
    assert np.isfinite(_vals(d)).all()


def test_async_checkpoints_match_sync(tmp_path):
    d_sync = _driver(tmp_path / "sync", checkpoint_every=7)
    d_sync.run(_stream())
    d_async = _driver(tmp_path / "async", checkpoint_every=7, async_checkpoints=True)
    d_async.run(_stream())

    r_sync = _driver(tmp_path / "sync")
    r_async = _driver(tmp_path / "async", async_checkpoints=True)
    assert r_sync.resume() and r_async.resume()
    assert r_sync.step_idx == r_async.step_idx == 20
    np.testing.assert_array_equal(_vals(r_sync), _vals(r_async))
    d2 = _driver(tmp_path / "async", checkpoint_every=5, async_checkpoints=True, nan_check_every=1)

    def poisoned():
        for i, b in enumerate(_stream()):
            if i == 8:
                b = dict(b, rating=b["rating"] * np.nan)
            yield b

    with pytest.raises(TrainingDiverged):
        d2.run(poisoned(), fast_forward=False)
    assert np.isfinite(_vals(d2)).all()


def test_preemption_signal_stops_saves_and_resumes(tmp_path):
    import signal

    d_full = _driver()
    full = d_full.run(_stream())
    _ids, full_vals = full.server_outputs[0]

    d1 = _driver(tmp_path, stop_signals=(signal.SIGUSR1,))

    def interrupting():
        for n, b in enumerate(_stream()):
            if n == 7:
                os.kill(os.getpid(), signal.SIGUSR1)
            yield b

    d1.run(interrupting())
    assert d1._stop_requested
    assert 7 <= d1.step_idx < 20, d1.step_idx
    assert d1._ckpt_mgr.latest_step() == d1.step_idx

    d2 = _driver(tmp_path)
    assert d2.resume()
    assert d2.step_idx == d1.step_idx
    res = d2.run(_stream())
    assert d2.step_idx == 20
    _ids2, vals2 = res.server_outputs[0]
    np.testing.assert_array_equal(vals2, full_vals)


def test_request_stop_programmatic(tmp_path):
    d = _driver(tmp_path)

    def stopping():
        for n, b in enumerate(_stream()):
            if n == 5:
                d.request_stop()
            yield b

    d.run(stopping())
    assert 5 <= d.step_idx < 20
    d2 = _driver()
    d2.run(_stream(n=3))
    assert d2.step_idx == 3


def test_driver_presort_same_final_model():
    data = synthetic_ratings(80, 120, 3_000, rank=4, noise=0.01, seed=8)

    def run(presort):
        logic = OnlineMatrixFactorization(80, 8, updater=SGDUpdater(0.08), seed=0, device="cpu")
        store = ShardedParamStore.create(120, (8,), init_fn=normal_factor(1, (8,)), device="cpu")
        drv = StreamingDriver(logic, store, config=DriverConfig(metrics_every=4, presort=presort))
        res = drv.run(microbatches(data, 256, epochs=2, shuffle_seed=0))
        assert drv.metrics is not None and drv.metrics.total_steps > 0
        return res

    a, b = run(False), run(True)
    np.testing.assert_allclose(a.store.values().numpy(), b.store.values().numpy(), atol=5e-5)


# ---------------------------------------------------------------------------
# tests/test_driver_steps_per_call.py, against the port
# ---------------------------------------------------------------------------


def test_driver_k4_matches_k1():
    d1 = _driver(metrics_every=5, steps_per_call=1)
    d1.run(_stream())
    d4 = _driver(metrics_every=5, steps_per_call=4)
    d4.run(_stream())
    assert d4.step_idx == d1.step_idx == 20
    assert d4.metrics.total_steps == d1.metrics.total_steps == 20
    assert d4.metrics.total_events == d1.metrics.total_events
    assert d4.metrics.snapshot()["updates_per_sec"] > 0
    np.testing.assert_allclose(_vals(d4), _vals(d1), atol=1e-6)


def test_driver_k4_checkpoint_rounds_to_group_boundary(tmp_path):
    d = _driver(tmp_path, checkpoint_every=10, steps_per_call=4)
    d.run(_stream())
    assert d._ckpt_mgr.latest_step() == 20
    steps = d._ckpt_mgr.all_steps()
    assert 12 in steps, steps


@pytest.mark.parametrize("k", [4, 7])
def test_driver_k_resume_matches_uninterrupted(tmp_path, k):
    d_full = _driver(None, steps_per_call=k)
    d_full.run(_stream())
    assert d_full.step_idx == 20

    d_a = _driver(tmp_path, checkpoint_every=4, steps_per_call=k)
    stream = list(_stream())
    d_a.run(iter(stream[:12]))
    d_b = _driver(tmp_path, steps_per_call=k)
    assert d_b.resume()
    assert d_b.step_idx == 12
    d_b.run(iter(stream))
    assert d_b.step_idx == 20
    np.testing.assert_allclose(_vals(d_b), _vals(d_full), atol=1e-6)


def test_driver_k4_async_checkpoints_match_sync(tmp_path):
    d_sync = _driver(tmp_path / "sync", checkpoint_every=8, steps_per_call=4)
    d_sync.run(_stream())
    d_async = _driver(tmp_path / "async", checkpoint_every=8, steps_per_call=4, async_checkpoints=True)
    d_async.run(_stream())
    r_sync = _driver(tmp_path / "sync")
    r_async = _driver(tmp_path / "async")
    assert r_sync.resume() and r_async.resume()
    assert r_sync.step_idx == r_async.step_idx == 20
    np.testing.assert_array_equal(_vals(r_sync), _vals(r_async))


def test_driver_k4_request_stop_drains_and_checkpoints(tmp_path):
    d = _driver(tmp_path, checkpoint_every=100, steps_per_call=4)
    stream = list(_stream())

    def stopping():
        for i, b in enumerate(stream):
            if i == 9:
                d.request_stop()
            yield b
        raise AssertionError("stop was ignored — stream exhausted")

    d.run(stopping())
    assert 0 < d.step_idx < 20
    assert d._ckpt_mgr.latest_step() == d.step_idx
    d2 = _driver(tmp_path, steps_per_call=4)
    assert d2.resume()
    d2.run(iter(stream))
    assert d2.step_idx == 20
    d_full = _driver(None, steps_per_call=4)
    d_full.run(iter(stream))
    np.testing.assert_allclose(_vals(d2), _vals(d_full), atol=1e-6)


def test_all_knobs_composed_converges(tmp_path):
    """Checkpoints + NaN guard + metrics x steps_per_call=16 x presort x
    xla_sorted (table and state) x the packed layout, against the plain
    dense run on the same stream (the reference's test also shards over a
    2-device mesh; the port is single-device)."""
    num_users, num_items, dim = 960, 1682, 16
    data = synthetic_ratings(num_users, num_items, 60_000, rank=6, seed=2)

    def run(scatter, layout, presort, K):
        logic = OnlineMatrixFactorization(
            num_users, dim, updater=SGDUpdater(0.05), device="cpu",
            state_scatter="xla_sorted" if scatter == "xla_sorted" else "xla",
        )
        store = ShardedParamStore.create(num_items, (dim,), init_fn=ranged_random_factor(0, (dim,)),
                                         scatter_impl=scatter, layout=layout, device="cpu")
        cfg = DriverConfig(checkpoint_dir=str(tmp_path / f"{scatter}_{layout}_{K}"), checkpoint_every=20,
                           nan_check_every=10, metrics_every=20, steps_per_call=K, presort=presort)
        d = StreamingDriver(logic, store, config=cfg)
        d.run(microbatches(data, 2048, epochs=2, shuffle_seed=3))
        return d

    d_all = run("xla_sorted", "packed", True, 16)
    d_ref = run("xla", "dense", False, 1)

    def rmse(d):
        uf, itf = d._state.numpy(), d.store.values().numpy()
        pred = np.einsum("ij,ij->i", uf[data["user"]], itf[data["item"]])
        return float(np.sqrt(np.mean((pred - data["rating"]) ** 2)))

    base = float(np.sqrt(np.mean(data["rating"] ** 2)))
    r_all, r_ref = rmse(d_all), rmse(d_ref)
    assert np.isfinite(d_all.store.values().numpy()).all()
    assert r_all < 0.9 * base
    assert abs(r_all - r_ref) < 0.02, (r_all, r_ref)


def test_driver_k4_nan_guard_fires_at_group_boundary(tmp_path):
    d = _driver(tmp_path, checkpoint_every=4, nan_check_every=1, steps_per_call=4)

    def poisoned():
        for i, b in enumerate(_stream()):
            if i >= 7:
                b = dict(b, rating=b["rating"] * np.nan)
            yield b

    with pytest.raises(TrainingDiverged, match="step 8"):
        d.run(poisoned())
    assert d.step_idx == 4
    assert np.isfinite(_vals(d)).all()


# ---------------------------------------------------------------------------
# the port's own envelope details
# ---------------------------------------------------------------------------


def test_all_finite_is_one_reduction():
    ok = _all_finite({"a": torch.ones(3), "n": torch.arange(3)}, torch.zeros(2, 2))
    assert ok.dtype == torch.bool and ok.ndim == 0 and bool(ok)
    assert not bool(_all_finite(torch.ones(3), (torch.tensor([1.0, float("inf")]),)))
    assert bool(_all_finite(torch.arange(4)))  # no float leaf: nothing to check


def test_periodic_checkpoint_is_a_host_copy(tmp_path):
    """The step updates the table in place after the save returns: the
    saved step must hold the table as it was at that step, in sync and
    async mode."""
    for mode in (False, True):
        oracle = _driver()
        stream = list(_stream())
        oracle.run(iter(stream[:10]))
        d = _driver(tmp_path / str(mode), checkpoint_every=10, async_checkpoints=mode)
        d.run(iter(stream))
        from flink_parameter_server_tpu_torch.training import checkpoint as ckpt

        store, state, meta = ckpt.restore(str(tmp_path / str(mode) / "10"), d.store.spec, "cpu")
        assert meta["step"] == 10
        np.testing.assert_array_equal(store.values().numpy(), _vals(oracle))
        np.testing.assert_array_equal(state.numpy(), oracle._state.numpy())


def test_driver_registry_and_health_wiring():
    from flink_parameter_server_tpu_torch.resilience import HealthMonitor
    from flink_parameter_server_tpu_torch.telemetry import MetricsRegistry

    reg, mon = MetricsRegistry(), HealthMonitor()
    logic = OnlineMatrixFactorization(64, 4, updater=SGDUpdater(0.05), device="cpu")
    store = ShardedParamStore.create(96, (4,), init_fn=ranged_random_factor(0, (4,)), device="cpu")
    d = StreamingDriver(logic, store, config=DriverConfig(metrics_every=5), registry=reg, health=mon)
    d.run(_stream(6))
    snap = reg.snapshot()
    assert snap["train_steps_total"][0]["value"] == 6
    assert snap["ingest_batches_total"][0]["value"] == 6
    assert mon.beats("train") == 6


def test_serve_with_returns_a_service_published_at_run_start():
    """``serve_with()`` returns a ServingService; its first snapshot (the
    pre-training table) is published when ``run()`` starts, and the
    close-time publish leaves the final table; a prebuilt service and
    kwargs together raise, as in the reference."""
    from flink_parameter_server_tpu_torch.serving import ServingService

    d = _driver()
    initial = d.store.table.clone()
    service = d.serve_with(publish_every=10**9)
    assert isinstance(service, ServingService) and service.snapshots.latest() is None
    seen = []
    d.add_group_hook(lambda step, n, table, state, outs: seen.append(service.snapshots.latest()))
    try:
        d.run(_stream(3))
        first = seen[0]
        assert (first.version, first.train_step) == (1, 0)
        # no worker state before the first step: the first snapshot has none
        assert torch.equal(first.table, initial) and first.aux is None
        last = service.snapshots.latest()
        assert (last.version, last.train_step) == (2, 3)
        assert torch.equal(last.table, d.store.table) and torch.equal(last.aux, d._state)
    finally:
        service.stop()
    with pytest.raises(ValueError, match="not both"):
        _driver().serve_with(service, publish_every=2)


def test_transform_batched_overload_and_model_load_match_jax():
    """``transform(batches, logic, store)`` is transform_batched, and
    ``transform_with_model_load`` SETs the given rows first (a negative id
    wraps, one past the end is dropped), as the reference's does."""
    from flink_parameter_server_tpu.core.transform import (
        transform_with_model_load as ref_load,
    )

    data = synthetic_ratings(64, 96, 4 * 128, rank=3, seed=5)
    model = [(3, np.full(4, 0.5, np.float32)), (-1, np.full(4, -0.25, np.float32)),
             (500, np.ones(4, np.float32)), (10, np.arange(4, dtype=np.float32))]
    want = ref_load(
        model, microbatches(data, 128),
        ref_mf.OnlineMatrixFactorization(64, 4, updater=ref_mf.SGDUpdater(0.05)),
        RefStore.create(96, (4,), init_fn=ref_init(0, (4,))),
    )
    logic = OnlineMatrixFactorization(64, 4, updater=SGDUpdater(0.05), device="cpu")
    store = ShardedParamStore.create(96, (4,), init_fn=ranged_random_factor(0, (4,)), device="cpu")
    got = transform_with_model_load(model, microbatches(data, 128), logic, store)
    np.testing.assert_allclose(got.store.values().numpy(), np.asarray(want.store.values()), **TOL)
    np.testing.assert_allclose(got.worker_state.numpy(), np.asarray(want.worker_state), **TOL)
    plain = transform(microbatches(data, 128), logic, store)
    assert not np.allclose(plain.store.values().numpy(), got.store.values().numpy())
    assert torch.equal(store.values(), ShardedParamStore.create(
        96, (4,), init_fn=ranged_random_factor(0, (4,)), device="cpu").values())  # caller's copy untouched


@pytest.mark.parametrize("value_shape", [(4,), ()])
def test_model_load_on_a_packed_store_raises_as_the_reference(value_shape):
    """The reference's set lands on the PHYSICAL (rows, 128) table of a
    packed store and raises on the shape mismatch; so does the port."""
    from flink_parameter_server_tpu.core.transform import (
        transform_with_model_load as ref_load,
    )

    model = [(i, np.full(value_shape, i, np.float32)) for i in range(3)]
    ref_store = RefStore.create(40, value_shape, layout="packed")
    with pytest.raises(ValueError):
        ref_load(model, [], ref_mf.OnlineMatrixFactorization(8, 4), ref_store)
    store = ShardedParamStore.create(40, value_shape, layout="packed", device="cpu")
    assert store.spec.layout == "packed"
    with pytest.raises(ValueError, match="broadcasting"):
        transform_with_model_load(model, [], OnlineMatrixFactorization(8, 4, device="cpu"), store)
