"""The port's event API: per-record callbacks on the host event backend.

Mirrors tests/test_transform_local.py (all 8 tests) and
tests/test_passive_aggressive.py's test_event_api_single_example_matches_rule,
run on the port alone, with their assertions (outputs compared as sets or
dicts, as the reference's are: the event loop promises no order across
workers).  Two parity runs beside them feed the JAX package's event
backend and the port's the same records and compare every output: the
counting worker with two workers, three servers and an input window of 5
(the same racy schedule, so the same stale reads), exactly; and the
event-API MF worker (``MFWorkerLogic``), whose SGD runs in float32 on
the logic's device, at rtol 1e-5 / atol 1e-7 (float32 dot products taken
by two libraries).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flink_parameter_server_tpu as ref
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.models import passive_aggressive as ref_pa
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch import (
    MFWorkerLogic,
    SGDUpdater,
    SimplePSLogic,
    WorkerLogic,
    add_pull_limiter,
    transform,
    transform_with_model_load,
)
from flink_parameter_server_tpu_torch.core.senders import SenderPolicy
from flink_parameter_server_tpu_torch.data.streams import from_collection
from flink_parameter_server_tpu_torch.models.passive_aggressive import PABinaryWorkerLogic, PARule
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

torch.set_num_threads(2)


class CountingWorker(WorkerLogic):
    """Pull the key, push the record's increment, emit the pulled value."""

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


def _add(c, d):
    return c + d


def test_simple_transform_counts():
    res = transform(from_collection([("a", 1), ("b", 2), ("a", 3)]), CountingWorker,
                    param_init=lambda _k: 0, param_update=_add)
    assert dict(res.server_outputs) == {"a": 4, "b": 2}
    assert len(res.worker_outputs) == 3


def test_multi_worker_multi_server_partitions():
    res = transform(from_collection([(k, 1) for k in "abcdefgh" * 5]), CountingWorker,
                    param_init=lambda _k: 0, param_update=_add, worker_parallelism=4, ps_parallelism=3)
    assert dict(res.server_outputs) == {k: 5 for k in "abcdefgh"}


def test_async_interleaving_races_are_visible():
    res = transform(from_collection([("k", 1)] * 10), CountingWorker, param_init=lambda _k: 0,
                    param_update=_add, worker_parallelism=2, input_window=4)
    assert dict(res.server_outputs) == {"k": 10}
    assert [v for (_k, v) in res.worker_outputs] != sorted(set(range(10)))


def test_custom_server_logic_and_close_dump():
    class MaxPS(SimplePSLogic):
        def __init__(self):
            super().__init__(init=lambda _k: float("-inf"), update=max)

    class PushOnly(WorkerLogic):
        def on_recv(self, data, ps):
            ps.push(data[0], data[1])

        def on_pull_recv(self, *a):
            pass

    res = transform(from_collection([("x", 3.0), ("x", 9.0), ("x", 1.0)]), PushOnly, MaxPS)
    assert dict(res.server_outputs) == {"x": 9.0}


def test_pull_limiter_bounds_in_flight():
    observed = []

    class GreedyWorker(WorkerLogic):
        def on_recv(self, data, ps):
            for k in range(5):
                ps.pull(k)

        def on_pull_recv(self, param_id, value, ps):
            observed.append(param_id)

    limited = []

    def make():
        w = add_pull_limiter(GreedyWorker(), limit=2, registry=False)
        limited.append(w)
        return w

    transform(from_collection([("go", 0)]), make, lambda: SimplePSLogic(lambda _k: 0, _add))
    assert sorted(observed) == [0, 1, 2, 3, 4]
    assert limited[0].limiter.inflight() == 0 and limited[0].limiter.queued() == 0


def test_transform_with_model_load_event_path():
    res = transform_with_model_load([("a", 100), ("b", 200)], from_collection([("a", 1)]), CountingWorker,
                                    lambda: SimplePSLogic(init=lambda _k: 0, update=_add))
    final = dict(res.server_outputs)
    assert final["a"] == 101 and final["b"] == 200
    assert ("a", 100) in res.worker_outputs
    # the param_init / param_update form, and a custom server that takes
    # the model through on_push_recv
    res = transform_with_model_load([("a", 5)], from_collection([("a", 1)]), CountingWorker,
                                    param_init=lambda _k: 0, param_update=_add)
    assert dict(res.server_outputs) == {"a": 6}


def test_combination_senders_batch_and_flush():
    data = [("a", 1), ("b", 2), ("a", 3), ("c", 4), ("a", 5)]
    plain = transform(from_collection(data), CountingWorker, param_init=lambda _k: 0, param_update=_add)
    comb = transform(from_collection(data), CountingWorker, param_init=lambda _k: 0, param_update=_add,
                     client_sender=SenderPolicy(count=3), ps_sender=SenderPolicy(count=2))
    assert dict(comb.server_outputs) == dict(plain.server_outputs)
    assert sorted(k for k, _v in comb.worker_outputs) == sorted(k for k, _v in plain.worker_outputs)
    stale = sum(c != p for (_, c), (_, p) in zip(sorted(comb.worker_outputs), sorted(plain.worker_outputs)))
    assert stale > 0


def test_combination_sender_interval_flush():
    res = transform(from_collection([("x", 1)]), CountingWorker, param_init=lambda _k: 0, param_update=_add,
                    client_sender=SenderPolicy(count=100, interval=1))
    assert dict(res.server_outputs) == {"x": 1}


def test_event_api_single_example_matches_rule():
    """One example through the event API (multi-pull + countdown) applies
    exactly the PA-I update."""

    class Adapter(PABinaryWorkerLogic):
        def on_recv(self, d, ps):
            (ids, vals), label = d
            super().on_recv((ids, vals, label), ps)

    res = transform([(((3, 7), (2.0, 1.0)), 1.0)], Adapter(PARule("PA-I", C=10.0), device="cpu"),
                    SimplePSLogic(init=lambda _k: 0.0, update=_add))
    w = dict(res.server_outputs)
    tau = 1.0 / 5.0  # w = 0: margin 0, loss 1, tau = 1 / ||x||^2
    assert w[3] == pytest.approx(tau * 2.0)
    assert w[7] == pytest.approx(tau * 1.0)
    label, pred, margin = res.worker_outputs[0]
    assert margin == 0.0


# ---------------------------------------------------------------------------
# Parity with the JAX package's event backend.
# ---------------------------------------------------------------------------


def test_racy_schedule_matches_the_reference():
    class RefCounting(ref.WorkerLogic):
        def __init__(self):
            self.pending = {}

        on_recv = CountingWorker.on_recv
        on_pull_recv = CountingWorker.on_pull_recv

    data = [(k, i) for i, k in enumerate("abcab" * 6)]
    kw = dict(param_init=lambda _k: 0, param_update=_add, worker_parallelism=2, ps_parallelism=3, input_window=5,
              client_sender=None)
    want = ref.transform(list(data), RefCounting, **kw)
    got = transform(list(data), CountingWorker, **kw)
    assert got.worker_outputs == want.worker_outputs
    assert got.server_outputs == want.server_outputs


def test_pa_event_worker_matches_the_reference():
    rng = np.random.default_rng(0)
    records = [(tuple(int(i) for i in rng.choice(30, 4, replace=False)),
                tuple(float(v) for v in rng.normal(0, 1, 4).astype(np.float32)), float(rng.choice([-1, 1])))
               for _ in range(40)]
    want = ref.transform(records, lambda: ref_pa.PABinaryWorkerLogic(ref_pa.PARule("PA-II", C=0.5)),
                         param_init=lambda _k: 0.0, param_update=_add, worker_parallelism=2, input_window=3)
    got = transform(records, lambda: PABinaryWorkerLogic(PARule("PA-II", C=0.5), device="cpu"),
                    param_init=lambda _k: 0.0, param_update=_add, worker_parallelism=2, input_window=3)
    assert [k for k, _ in got.server_outputs] == [k for k, _ in want.server_outputs]
    np.testing.assert_allclose([v for _, v in got.server_outputs], [float(v) for _, v in want.server_outputs],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.array(got.worker_outputs, np.float64),
                               np.array([tuple(map(float, o)) for o in want.worker_outputs]), rtol=1e-5, atol=1e-6)


def test_mf_event_worker_matches_the_reference():
    """MFWorkerLogic on the same ratings: predictions, the final item
    vectors and the user vectors agree with the reference's."""
    dim, lr, reg = 8, 0.1, 0.01
    rng = np.random.default_rng(5)
    ratings = [(int(u), int(i), float(r)) for u, i, r in
               zip(rng.integers(0, 12, 300), (rng.zipf(1.3, 300) - 1) % 20, rng.normal(0, 1, 300))]
    ref_items = ref_init(9, (dim,))
    port_items = ranged_random_factor(9, (dim,))
    ref_workers, port_workers = [], []

    def ref_worker():
        ref_workers.append(ref_mf.MFWorkerLogic(dim, ref_mf.SGDUpdater(lr, reg), seed=3))
        return ref_workers[-1]

    def port_worker():
        port_workers.append(MFWorkerLogic(dim, SGDUpdater(lr, reg), seed=3, device="cpu"))
        return port_workers[-1]

    kw = dict(worker_parallelism=2, input_window=4, partitioner=lambda rec, n: rec[0] % n)
    want = ref.transform(ratings, ref_worker, param_init=lambda i: np.asarray(ref_items(jnp.array([i]))[0]),
                         param_update=_add, **kw)
    got = transform(ratings, port_worker, param_init=lambda i: port_items(torch.tensor([i]))[0],
                    param_update=_add, **kw)
    assert [(u, i) for u, i, _ in got.worker_outputs] == [(u, i) for u, i, _ in want.worker_outputs]
    np.testing.assert_allclose([p for *_, p in got.worker_outputs], [p for *_, p in want.worker_outputs],
                               rtol=1e-5, atol=1e-7)
    assert [k for k, _ in got.server_outputs] == [k for k, _ in want.server_outputs]
    np.testing.assert_allclose(np.stack([v.numpy() for _, v in got.server_outputs]),
                               np.stack([np.asarray(v) for _, v in want.server_outputs]), rtol=1e-5, atol=1e-7)
    for pw, rw in zip(port_workers, ref_workers):
        assert sorted(pw.user_vectors) == sorted(rw.user_vectors)
        for u, vec in pw.user_vectors.items():
            np.testing.assert_allclose(vec.numpy(), np.asarray(rw.user_vectors[u]), rtol=1e-5, atol=1e-7)


def test_transform_rejects_a_missing_server():
    with pytest.raises(TypeError, match="param_init"):
        transform([("a", 1)], CountingWorker)
    with pytest.raises(ValueError, match="factory"):
        transform([("a", 1)], CountingWorker(), param_init=lambda _k: 0, param_update=_add, worker_parallelism=2)
