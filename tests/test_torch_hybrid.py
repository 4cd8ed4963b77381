"""The port's hybrid backend (``core/hybrid.py``) against the JAX package's.

Unmodified event-API logics run against the port's store on the CPU
(``device="cpu"``; with ``scatter_impl="pallas"`` the push takes the
scatter-add kernel's plain version there).  The same records go through
the reference's ``transform_hybrid`` over its store.  Tolerances: with
``chunk_size=1`` the hybrid table equals the event backend's within atol
1e-5 (the reference's bar); the port's table against the reference's
within atol 1e-5 (float32, the same per-record math and the same chunk
order); integer counts exactly.

Mirrors the four tests of tests/test_hybrid.py; the sharded-store one runs
at one device (no mesh: multi-device stores are ROADMAP Queue 1 #9).
"""
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.core.hybrid import transform_hybrid as ref_transform_hybrid
from flink_parameter_server_tpu.core.store import ShardedParamStore as RefStore
from flink_parameter_server_tpu.models.matrix_factorization import MFWorkerLogic as RefMFWorkerLogic
from flink_parameter_server_tpu.models.matrix_factorization import SGDUpdater as RefSGDUpdater
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu.utils.initializers import zeros as ref_zeros
from flink_parameter_server_tpu_torch import SimplePSLogic, transform, transform_hybrid
from flink_parameter_server_tpu_torch.core.api import WorkerLogic
from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
from flink_parameter_server_tpu_torch.models.matrix_factorization import MFWorkerLogic, SGDUpdater
from flink_parameter_server_tpu_torch.ops import scatter_kernel
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor, zeros

torch.set_num_threads(2)

CPU = "cpu"


def _ratings(n, users, items, seed):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, users)), int(rng.integers(0, items)), float(rng.normal()))
            for _ in range(n)]


def _ref_hybrid_items(ratings, dim, capacity, lr, chunk_size):
    worker = RefMFWorkerLogic(dim=dim, updater=RefSGDUpdater(lr), seed=0)
    store = RefStore.create(capacity, (dim,), init_fn=ref_init(1, (dim,)))
    res = ref_transform_hybrid(list(ratings), worker, store, chunk_size=chunk_size)
    return np.asarray(res.store.values()), res


def test_hybrid_mf_matches_event_backend_math():
    """The unmodified MFWorkerLogic trains against the store; with
    chunk_size=1 the result matches the pure event backend exactly, and
    the reference's hybrid run on the same records."""
    ratings = _ratings(120, 10, 12, seed=0)
    updater = SGDUpdater(0.05)
    item_init = ranged_random_factor(1, (4,))
    w_ev = MFWorkerLogic(dim=4, updater=updater, seed=0, device=CPU)
    res_ev = transform(
        list(ratings), w_ev,
        SimplePSLogic(init=lambda i: item_init(torch.tensor([i]))[0], update=lambda c, d: c + d),
    )
    ev_items = np.zeros((12, 4), np.float32)
    for i, v in res_ev.server_outputs:
        ev_items[i] = np.asarray(v)

    w_hy = MFWorkerLogic(dim=4, updater=updater, seed=0, device=CPU)
    store = ShardedParamStore.create(12, (4,), init_fn=item_init, device=CPU)
    res_hy = transform_hybrid(list(ratings), w_hy, store, chunk_size=1)
    got = res_hy.store.values().numpy()
    np.testing.assert_allclose(got, ev_items, atol=1e-5)
    assert len(res_hy.worker_outputs) == len(res_ev.worker_outputs)
    want, ref_res = _ref_hybrid_items(ratings, 4, 12, 0.05, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose([p for _u, _i, p in res_hy.worker_outputs],
                               [p for _u, _i, p in ref_res.worker_outputs], atol=1e-5)
    # the model dump is the table, on the host
    ids, vals = res_hy.server_outputs[0]
    assert np.array_equal(ids, np.arange(12)) and np.array_equal(vals, got)


def test_hybrid_chunked_converges():
    """Chunked (bounded-staleness) hybrid converges (the reference's
    sharded-store test, at one device), and its first chunks match the
    reference's run over the same records."""
    rng = np.random.default_rng(1)
    P = rng.normal(0, 0.5, (30, 3))
    Q = rng.normal(0, 0.5, (40, 3))
    ratings = []
    for _ in range(3000):
        u, i = int(rng.integers(0, 30)), int(rng.integers(0, 40))
        ratings.append((u, i, float(P[u] @ Q[i] + rng.normal(0, 0.02))))

    worker = MFWorkerLogic(dim=6, updater=SGDUpdater(0.08), seed=0, device=CPU)
    store = ShardedParamStore.create(40, (6,), init_fn=ranged_random_factor(1, (6,)), device=CPU)
    res = transform_hybrid(ratings * 4, worker, store, chunk_size=256)
    item_f = res.store.values().numpy()
    user_f = np.zeros((30, 6), np.float32)
    for u, v in worker.user_vectors.items():
        user_f[u] = v.numpy()
    pred = np.array([user_f[u] @ item_f[i] for u, i, _r in ratings])
    truth = np.array([r for _u, _i, r in ratings])
    rmse = float(np.sqrt(np.mean((pred - truth) ** 2)))
    base = float(np.sqrt(np.mean(truth**2)))
    assert rmse < 0.6 * base, (rmse, base)

    prefix = ratings[:512]
    w2 = MFWorkerLogic(dim=6, updater=SGDUpdater(0.08), seed=0, device=CPU)
    got = transform_hybrid(prefix, w2, ShardedParamStore.create(
        40, (6,), init_fn=ranged_random_factor(1, (6,)), device=CPU), chunk_size=256).store.values().numpy()
    want, _ = _ref_hybrid_items(prefix, 6, 40, 0.08, 256)
    np.testing.assert_allclose(got, want, atol=1e-5)


class CountingWorker(WorkerLogic):
    """Pull the key, add the data value to it, push the delta, emit the
    pulled value — a minimal logic touching every hook."""

    def __init__(self):
        self.pending = {}

    def on_recv(self, data, ps):
        key, inc = data
        self.pending.setdefault(key, []).append(inc)
        ps.pull(key)

    def on_pull_recv(self, param_id, param_value, ps):
        for inc in self.pending.pop(param_id, []):
            ps.push(param_id, inc)
        ps.output((param_id, float(param_value)))


def test_hybrid_multi_worker_partitioning():
    """Counting logic across 3 workers with a key partitioner, on a
    dense and on a ``scatter_impl="pallas"`` store (the CPU takes the
    kernel's plain version and counts no launch): the reference's counts
    and outputs."""
    data = [(k, 1.0) for k in [0, 1, 2, 3] * 25]
    ref = ref_transform_hybrid(data, _RefCountingWorker, RefStore.create(8, (), init_fn=ref_zeros(())),
                               chunk_size=16, worker_parallelism=3,
                               partitioner=lambda rec, n: rec[0] % n)
    for impl in ("xla", "pallas"):
        store = ShardedParamStore.create(8, (), init_fn=zeros(()), scatter_impl=impl, device=CPU)
        scatter_kernel.sorted_scatter_add.launches = 0
        res = transform_hybrid(data, CountingWorker, store, chunk_size=16, worker_parallelism=3,
                               partitioner=lambda rec, n: rec[0] % n)
        assert scatter_kernel.sorted_scatter_add.launches == 0
        vals = res.store.values().numpy()
        np.testing.assert_array_equal(vals[:4], [25, 25, 25, 25])
        np.testing.assert_array_equal(vals, np.asarray(ref.store.values()))
        assert len(res.worker_outputs) == 100
        assert sorted(res.worker_outputs) == sorted((k, float(v)) for k, v in ref.worker_outputs)


def _RefCountingWorker():
    from tests.test_transform_local import CountingWorker as RefCountingWorker

    return RefCountingWorker()


def test_hybrid_rejects_bad_ids():
    class StrKeys(MFWorkerLogic):
        def on_recv(self, d, ps):
            ps.pull("a")  # event backend allows this; hybrid must not

    store = ShardedParamStore.create(4, (4,), device=CPU)
    with pytest.raises(TypeError, match="integer param ids"):
        transform_hybrid([(0, 0, 0.0)], StrKeys(dim=4, device=CPU), store, chunk_size=1)

    class OOB(MFWorkerLogic):
        def on_recv(self, d, ps):
            ps.pull(99)

    with pytest.raises(ValueError, match="out of range"):
        transform_hybrid([(0, 0, 0.0)], OOB(dim=4, device=CPU), store, chunk_size=1)

    class OOBPush(MFWorkerLogic):
        def on_recv(self, d, ps):
            ps.push(-1, np.zeros(4, np.float32))

    with pytest.raises(ValueError, match="out of range"):
        transform_hybrid([(0, 0, 0.0)], OOBPush(dim=4, device=CPU), store, chunk_size=1)
    if not torch.cuda.is_available():  # the store, and so the hybrid run, defaults to the card
        with pytest.raises(RuntimeError, match="cuda"):
            ShardedParamStore.create(4, (4,))
