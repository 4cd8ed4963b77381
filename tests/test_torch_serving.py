"""The port's serving plane against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function (on
the CPU, no mesh, as tests/test_serving.py runs it) and through the
port's, on CPU tensors.  Tolerances: ids, versions, train steps and
staleness equal; scores rtol 1e-5 with atol 1e-6, the atol for scores
near zero when a whole catalogue is ranked (the port sums each product in
float64 and rounds once, the reference sums in float32, so a score near
zero differs by a float32 unit of its terms, not of itself); tables after
training rtol 1e-5 / atol 1e-6 (float32 sums of the same terms in another
order, the tolerance of tests/test_torch_driver.py).

Mirrors: the 19 single-device tests of tests/test_serving.py (the
ps-sharded one waits for the mesh, ROADMAP Queue 1 #9), the top-K tests of
tests/test_matrix_factorization.py and tests/test_round3_fixes.py; then a
slice-level test (the same stream through both drivers' ``serve_with``)
and a test of tie order and the ``-inf`` / -1 conventions.  TCP servers
bind port 0 on 127.0.0.1.
"""
import socket as pysocket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu import serving as ref_serving
from flink_parameter_server_tpu.core.store import ShardedParamStore as RefStore
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.models import topk_recommender as ref_topk
from flink_parameter_server_tpu.ops import topk as ref_ops_topk
from flink_parameter_server_tpu.serving.server import tcp_request as ref_tcp_request
from flink_parameter_server_tpu.training import driver as ref_driver
from flink_parameter_server_tpu.utils.initializers import normal_factor as ref_normal
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
from flink_parameter_server_tpu_torch.data.streams import microbatches
from flink_parameter_server_tpu_torch.models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
)
from flink_parameter_server_tpu_torch.models.topk_recommender import make_mf_topk_step, query_topk
from flink_parameter_server_tpu_torch.ops.topk import dense_topk
from flink_parameter_server_tpu_torch.serving import (
    NoSnapshotError,
    QueryEngine,
    QueueFull,
    RequestBatcher,
    ServingMetrics,
    ServingServer,
    ServingService,
    SnapshotManager,
)
from flink_parameter_server_tpu_torch.serving.server import parse_response, tcp_request
from flink_parameter_server_tpu_torch.training.driver import DriverConfig, StreamingDriver
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

torch.set_num_threads(2)

SCORES = dict(rtol=1e-5, atol=1e-6)
TABLES = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy: port steps update in place


def _same_topk(got_scores, got_ids, want_scores, want_ids):
    np.testing.assert_array_equal(np.asarray(got_ids), np.asarray(want_ids))
    np.testing.assert_allclose(np.asarray(got_scores), np.asarray(want_scores), **SCORES)


def _same_answer(got, want):
    """A port TopKResult / LookupResult against the reference's."""
    assert (got.version, got.train_step, got.staleness) == (
        want.version, want.train_step, want.staleness)
    if hasattr(want, "item_ids"):
        _same_topk(got.scores, got.item_ids, want.scores, want.item_ids)
    else:
        np.testing.assert_allclose(got.values, want.values, **SCORES)


# ---------------------------------------------------------------------------
# snapshot.py
# ---------------------------------------------------------------------------


def test_snapshot_isolation_and_publish_cadence():
    """Reads from a published snapshot are bit-identical across pushes;
    republish happens only at the cadence."""
    store = ShardedParamStore.create(32, (4,), init_fn=ranged_random_factor(0, (4,)), device="cpu")
    mgr = SnapshotManager(store.spec, publish_every=3)
    snap1 = mgr.publish(store.table, step=0)
    frozen = snap1.table.clone()

    pushed = store.push(torch.tensor([1, 2, 3]), torch.ones(3, 4))
    assert not torch.allclose(pushed.table, frozen)  # live moved
    assert torch.equal(mgr.latest().table, frozen)  # the snapshot did not

    # below the cadence: no republish, but staleness ticks
    assert mgr.maybe_publish(pushed.table, step=2) is None
    assert mgr.latest().version == 1
    assert mgr.staleness() == 2

    # at the cadence: new version, new table
    snap2 = mgr.maybe_publish(pushed.table, step=3)
    assert snap2 is not None and snap2.version == 2
    assert torch.equal(mgr.latest().table, pushed.table)
    assert mgr.staleness() == 0


def test_snapshot_copy_survives_in_place_updates():
    """The published table and aux are copies: the train step updates the
    live tensors in place (the reference's test donates the source buffer,
    the port's analogue writes into it)."""
    store = ShardedParamStore.create(16, (2,), init_fn=ranged_random_factor(0, (2,)), device="cpu")
    state = torch.ones(5, 2)
    mgr = SnapshotManager(store.spec)
    mgr.publish(store.table, step=0, aux=state)
    frozen, frozen_aux = store.table.clone(), state.clone()

    store.table.mul_(2.0)
    state.add_(1.0)
    assert torch.equal(mgr.latest().table, frozen)
    assert torch.equal(mgr.latest().aux, frozen_aux)


# ---------------------------------------------------------------------------
# batcher.py
# ---------------------------------------------------------------------------


def test_batcher_flushes_immediately_when_full():
    b = RequestBatcher(max_batch=4, max_delay_ms=10_000, max_queue=64)
    for i in range(4):
        b.submit(i)
    t0 = time.monotonic()
    batch = b.next_batch(timeout=1)
    assert time.monotonic() - t0 < 1.0  # no deadline wait on a full batch
    assert [p.payload for p in batch] == [0, 1, 2, 3]


def test_batcher_deadline_flush_for_partial_batch():
    b = RequestBatcher(max_batch=64, max_delay_ms=50, max_queue=64)
    b.submit("a")
    b.submit("b")
    t0 = time.monotonic()
    batch = b.next_batch(timeout=5)
    assert [p.payload for p in batch] == ["a", "b"]
    assert time.monotonic() - t0 < 2.0  # flushed by deadline, not by a full batch


def test_batcher_rejects_not_blocks_on_overload():
    b = RequestBatcher(max_batch=4, max_delay_ms=1_000, max_queue=3)
    for i in range(3):
        b.submit(i)
    t0 = time.monotonic()
    with pytest.raises(QueueFull):
        b.submit(99)
    assert time.monotonic() - t0 < 0.5  # reject is immediate, never a block
    assert b.rejected == 1 and b.submitted == 3 and b.depth == 3


def test_batcher_buckets_and_close():
    b = RequestBatcher(max_batch=16, max_delay_ms=1)
    assert b.buckets == (1, 2, 4, 8, 16)
    assert [b.bucket_for(n) for n in (1, 3, 16)] == [1, 4, 16]
    fut = b.submit("x")
    b.close()
    with pytest.raises(RuntimeError):
        fut.result(timeout=1)
    with pytest.raises(RuntimeError):
        b.submit("y")
    assert b.next_batch(timeout=0.1) is None


# ---------------------------------------------------------------------------
# engine.py — against the reference's engine and a numpy oracle
# ---------------------------------------------------------------------------


def _np_topk_oracle(table, queries, k, exclude=None):
    """(B, k) exact MIPS top-k ids by brute force."""
    scores = queries @ table.T
    if exclude is not None:
        for b in range(scores.shape[0]):
            for e in exclude[b]:
                if e >= 0:
                    scores[b, e] = -np.inf
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(scores, order, axis=1)


def _published_engines(num_items, dim, num_users, seed=0):
    """(port engine, reference engine, table, user vectors) over the same
    seeded numpy tables, each published once at step 0."""
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (num_items, dim)).astype(np.float32)
    uv = rng.normal(0, 1, (num_users, dim)).astype(np.float32)
    store = ShardedParamStore.from_values(_t(table), device="cpu")
    mgr = SnapshotManager(store.spec)
    mgr.publish(store.table, step=0, aux=_t(uv))
    ref_store = RefStore.from_values(jnp.asarray(table))
    ref_mgr = ref_serving.SnapshotManager(ref_store.spec)
    ref_mgr.publish(ref_store.table, step=0, aux=jnp.asarray(uv))
    return QueryEngine(mgr), ref_serving.QueryEngine(ref_mgr), table, uv


def test_topk_matches_reference_and_numpy_oracle():
    engine, ref_engine, table, uv = _published_engines(257, 16, 40)  # odd row count
    users = np.array([0, 7, 39, 7], np.int32)
    res = engine.top_k(users, k=9)
    _same_answer(res, ref_engine.top_k(users, k=9))
    exp_ids, exp_scores = _np_topk_oracle(table, uv[users], 9)
    _same_topk(res.scores, res.item_ids, exp_scores, exp_ids)
    assert res.version == 1 and res.staleness == 0


def test_topk_exclusion_mask_parity():
    engine, ref_engine, table, uv = _published_engines(128, 8, 10, seed=3)
    users = np.array([1, 2, 3], np.int32)
    # exclude each user's unexcluded top-3, one row partly padded with -1
    base_ids, _ = _np_topk_oracle(table, uv[users], 3)
    exclude = base_ids.astype(np.int32).copy()
    exclude[2, 1:] = -1
    res = engine.top_k(users, k=5, exclude=exclude)
    _same_answer(res, ref_engine.top_k(users, k=5, exclude=exclude))
    exp_ids, exp_scores = _np_topk_oracle(table, uv[users], 5, exclude)
    _same_topk(res.scores, res.item_ids, exp_scores, exp_ids)
    for b in range(3):
        banned = {int(e) for e in exclude[b] if e >= 0}
        assert banned.isdisjoint(set(int(i) for i in res.item_ids[b]))


def test_lookup_and_score_read_the_snapshot():
    engine, ref_engine, table, uv = _published_engines(64, 4, 6, seed=7)
    ids = np.array([0, 5, 63], np.int32)
    got = engine.lookup(ids)
    _same_answer(got, ref_engine.lookup(ids))
    np.testing.assert_allclose(got.values, table[ids], rtol=1e-6)
    sc = engine.score(np.array([1, 2]), np.array([10, 20]))
    _same_answer(sc, ref_engine.score(np.array([1, 2]), np.array([10, 20])))
    np.testing.assert_allclose(sc.values, np.sum(uv[[1, 2]] * table[[10, 20]], axis=-1), rtol=1e-5)


def test_engine_before_first_publish_is_loud():
    store = ShardedParamStore.create(8, (2,), device="cpu")
    engine = QueryEngine(SnapshotManager(store.spec))
    with pytest.raises(NoSnapshotError):
        engine.lookup([0])


# ---------------------------------------------------------------------------
# end-to-end: train-while-serve through StreamingDriver.serve_with
# ---------------------------------------------------------------------------


def _mf_driver(num_users, num_items, dim, seed=0, **cfg):
    logic = OnlineMatrixFactorization(num_users, dim, updater=SGDUpdater(0.05), device="cpu")
    store = ShardedParamStore.create(
        num_items, (dim,), init_fn=ranged_random_factor(seed + 1, (dim,)), device="cpu"
    )
    return StreamingDriver(logic, store, config=DriverConfig(dump_model=False, **cfg))


def test_serve_with_answers_topk_mid_training():
    num_users, num_items, dim = 120, 200, 8
    driver = _mf_driver(num_users, num_items, dim)
    service = driver.serve_with(publish_every=2, max_batch=16, max_delay_ms=1.0)
    client = service.client()
    data = synthetic_ratings(num_users, num_items, 60_000, rank=4, seed=0)
    batches = list(microbatches(data, 512, epochs=2, shuffle_seed=0))

    results = []
    t = threading.Thread(target=lambda: results.append(driver.run(batches, collect_outputs=False)))
    t.start()
    try:
        # version 2 = first mid-training publish (carries worker state)
        assert service.wait_for_snapshot(60, min_version=2)
        mid = client.top_k(3, k=5, exclude=[0, 1])
        assert mid.version >= 2 and mid.staleness >= 0
        assert len(set(int(i) for i in mid.item_ids)) == 5
        assert all(0 <= i < num_items for i in mid.item_ids)
        assert 0 not in mid.item_ids and 1 not in mid.item_ids
    finally:
        t.join(timeout=300)
    assert not t.is_alive() and results, "driver.run raised in the training thread"

    # post-run queries answer from the FINAL table: equal to query_topk on
    # the trained store + worker state
    final = client.top_k(7, k=6)
    exp_scores, exp_ids = query_topk(driver.store, results[0].worker_state, torch.tensor([7]), 6)
    np.testing.assert_array_equal(final.item_ids, exp_ids[0].numpy())
    np.testing.assert_array_equal(final.scores, exp_scores[0].numpy())
    assert final.staleness == 0
    service.stop()


def test_serve_with_snapshot_frozen_between_publishes():
    """With an effectively-infinite publish cadence, every mid-training
    read is bit-identical to the initial table although the trainer keeps
    pushing in place."""
    num_users, num_items, dim = 60, 80, 4
    driver = _mf_driver(num_users, num_items, dim, seed=2)
    initial = driver.store.values().clone()
    service = driver.serve_with(publish_every=10**9, max_batch=8, max_delay_ms=1.0)
    client = service.client()
    data = synthetic_ratings(num_users, num_items, 30_000, rank=4, seed=2)
    batches = list(microbatches(data, 256, epochs=1, shuffle_seed=0))

    def throttled():
        # pace the stream so the reader below provably overlaps training
        for b in batches:
            time.sleep(0.005)
            yield b

    probe = np.array([0, 13, 79], np.int32)
    reads = []
    done = threading.Event()

    def trainer():
        try:
            driver.run(throttled(), collect_outputs=False)
        finally:
            done.set()

    t = threading.Thread(target=trainer)
    t.start()
    try:
        while not done.is_set():
            reads.append(client.lookup(probe))
    finally:
        t.join(timeout=300)
    assert not t.is_alive() and reads, "no reads completed while training"
    mid_reads = [r for r in reads if r.version == 1]
    assert mid_reads, "every read raced past the final publish"
    for r in mid_reads:
        np.testing.assert_array_equal(r.values, initial[probe].numpy())
    # training DID move the table (the reads were frozen, not the model)
    assert not torch.allclose(driver.store.values(), initial)
    # ... and the close-time force publish exposed the final table
    final = client.lookup(probe)
    np.testing.assert_array_equal(final.values, driver.store.values()[probe].numpy())
    service.stop()


def test_service_rejects_when_overloaded_without_dispatch():
    """Bounded admission: with no dispatch thread draining, the queue fills
    and the next submit REJECTS immediately (never blocks)."""
    store = ShardedParamStore.create(16, (2,), device="cpu")
    service = ServingService.for_spec(store.spec, max_queue=4, max_batch=4, max_delay_ms=1.0)
    for i in range(4):
        service.submit_topk(i, k=1)
    t0 = time.monotonic()
    with pytest.raises(QueueFull):
        service.submit_topk(99, k=1)
    assert time.monotonic() - t0 < 0.5
    assert service.metrics.total_rejected == 1
    service.batcher.close()


# ---------------------------------------------------------------------------
# server.py — TCP line-protocol round trips, the port's server beside the
# reference's on the same tables
# ---------------------------------------------------------------------------


@pytest.fixture()
def tcp_servers():
    engine, ref_engine, table, uv = _published_engines(96, 8, 20, seed=11)
    servers = []
    for svc_cls, srv_cls, eng, batcher_cls in (
        (ServingService, ServingServer, engine, RequestBatcher),
        (ref_serving.ServingService, ref_serving.ServingServer, ref_engine, ref_serving.RequestBatcher),
    ):
        service = svc_cls(eng, batcher_cls(max_batch=16, max_delay_ms=1.0, max_queue=64))
        servers.append((srv_cls(service).start(), service))
    yield servers[0][0], servers[1][0], table, uv
    for server, service in servers:
        server.stop()
        service.stop()


def _both(servers, line):
    port, ref = servers[:2]
    return tcp_request(port.host, port.port, line), ref_tcp_request(ref.host, ref.port, line)


def _same_response(got, want):
    assert got["ok"] == want["ok"]
    for key in ("version", "train_step", "staleness", "item_ids"):
        assert got.get(key) == want.get(key), key
    for key in ("scores", "values"):
        if key in want:
            np.testing.assert_allclose(np.array(got[key]), np.array(want[key]), rtol=1e-5)


def test_tcp_topk_round_trip(tcp_servers):
    resp, ref = _both(tcp_servers, "topk 4 5")
    assert resp["ok"]
    _same_response(resp, ref)
    table, uv = tcp_servers[2:]
    exp_ids, exp_scores = _np_topk_oracle(table, uv[[4]], 5)
    assert resp["item_ids"] == exp_ids[0].tolist()
    np.testing.assert_allclose(resp["scores"], exp_scores[0], rtol=1e-4)
    assert resp["version"] == 1 and resp["staleness"] == 0


def test_tcp_topk_with_exclusions(tcp_servers):
    port = tcp_servers[0]
    base = tcp_request(port.host, port.port, "topk 2 3")
    banned = ",".join(str(i) for i in base["item_ids"])
    resp, ref = _both(tcp_servers, f"topk 2 3 {banned}")
    assert resp["ok"]
    _same_response(resp, ref)
    assert set(resp["item_ids"]).isdisjoint(set(base["item_ids"]))


def test_tcp_pull_round_trip(tcp_servers):
    resp, ref = _both(tcp_servers, "pull 0,17,95")
    assert resp["ok"]
    _same_response(resp, ref)
    np.testing.assert_allclose(np.array(resp["values"], np.float32), tcp_servers[2][[0, 17, 95]], rtol=1e-4)


def test_tcp_pipelined_requests_one_connection(tcp_servers):
    """N requests down one connection come back as N ordered responses
    (the line protocol's per-connection FIFO contract)."""
    server = tcp_servers[0]
    with pysocket.create_connection((server.host, server.port), timeout=30) as s:
        s.sendall(b"topk 1 3\ntopk 2 3\npull 5\n")
        buf = b""
        while buf.count(b"\n") < 3:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    lines = buf.decode().strip().split("\n")
    assert len(lines) == 3
    r1, r2, r3 = (parse_response(ln) for ln in lines)
    assert r1["ok"] and r2["ok"] and r3["ok"]
    assert "item_ids" in r1 and "item_ids" in r2 and "values" in r3
    np.testing.assert_allclose(np.array(r3["values"][0], np.float32), tcp_servers[2][5], rtol=1e-4)


def test_tcp_malformed_requests_answer_err(tcp_servers):
    for line in ("bogus 1 2", "topk 1", "topk 1 0", "pull"):
        resp, ref = _both(tcp_servers, line)
        assert not resp["ok"] and resp == ref


# ---------------------------------------------------------------------------
# metrics.py
# ---------------------------------------------------------------------------


def test_serving_metrics_snapshot_shape():
    m = ServingMetrics()
    m.record_batch(3, 4, [0.001, 0.002, 0.004])
    m.record_reject()
    m.queue_depth_fn = lambda: 2
    m.staleness_fn = lambda: 5
    snap = m.snapshot()
    assert snap["serving_requests"] == 3
    assert snap["serving_rejected"] == 1
    assert snap["batch_fill"] == 0.75
    assert snap["queue_depth"] == 2
    assert snap["snapshot_staleness_steps"] == 5
    assert snap["serving_p99_ms"] >= snap["serving_p50_ms"] > 0
    assert "serving_qps" in m.emit()


# ---------------------------------------------------------------------------
# models/topk_recommender.py and ops/topk.py
# ---------------------------------------------------------------------------


def test_query_topk_exclusions_exceeding_catalogue():
    """k + |exclude| > catalogue: excluded and missing candidates come back
    as id -1 / -inf."""
    vals = np.eye(6, 4, dtype=np.float32)  # 6 items, dim 4
    users = np.ones((2, 4), np.float32)
    exclude = np.tile(np.array([[0, 1, 2, 3, 4]], np.int32), (2, 1))  # ban 5 of 6
    uids = np.array([0, 1], np.int32)
    scores, ids = query_topk(ShardedParamStore.from_values(_t(vals), device="cpu"), _t(users), _t(uids), k=4,
                             exclude=_t(exclude))
    assert tuple(ids.shape) == (2, 4)
    assert int(ids[0, 0]) == 5  # the only unbanned item wins
    assert bool((ids[0, 1:] == -1).all())  # rest padded
    want = ref_topk.query_topk(RefStore.from_values(jnp.asarray(vals)), jnp.asarray(users), jnp.asarray(uids),
                               k=4, exclude=jnp.asarray(exclude))
    _same_topk(scores, ids, want[0], want[1])


def _mf_batch(rng, b, num_users, num_items, query_users):
    return {
        "user": rng.integers(0, num_users, b).astype(np.int32),
        "item": rng.integers(0, num_items, b).astype(np.int32),
        "rating": rng.normal(0, 1, b).astype(np.float32),
        "mask": np.ones(b, bool),
        "query_user": np.asarray(query_users, np.int32),
    }


def _topk_steps(ref_store, dim, num_users, batch, k, lr):
    """make_mf_topk_step through both packages from the same table, user
    state and batch: (port (table, state, out), reference's)."""
    ref_logic = ref_mf.OnlineMatrixFactorization(num_users, dim, updater=ref_mf.SGDUpdater(lr))
    state = ref_logic.init_state(jax.random.PRNGKey(0))
    want = jax.jit(ref_topk.make_mf_topk_step(ref_logic, ref_store.spec, k=k))(
        ref_store.table, state, {n: jnp.asarray(v) for n, v in batch.items()})
    store = ShardedParamStore.from_values(_t(np.asarray(ref_store.values())), layout=ref_store.spec.layout,
                                          device="cpu")
    logic = OnlineMatrixFactorization(num_users, dim, updater=SGDUpdater(lr), device="cpu")
    step = make_mf_topk_step(logic, store.spec, k=k)
    got = step(store.table.clone(), _t(np.asarray(state)), {n: _t(v) for n, v in batch.items()})
    return store, got, want


def test_make_mf_topk_step_interleaved_queries():
    """The train+serve step answers in-stream queries against the pre-push
    table with post-update user vectors; tables and answers match the
    reference's jitted step."""
    ref_store = RefStore.create(48, (4,), init_fn=ref_init(1, (4,)))
    batch = _mf_batch(np.random.default_rng(0), 64, 32, 48, [0, 5, 9])
    store, (table2, state2, out), (w_table, w_state, w_out) = _topk_steps(ref_store, 4, 32, batch, 5, 0.05)
    assert tuple(out["topk_ids"].shape) == (3, 5)
    q = state2[torch.from_numpy(batch["query_user"]).long()]
    pre_scores, pre_ids = dense_topk(store.table, q, 5, valid_rows=48)
    assert torch.equal(out["topk_ids"], pre_ids) and torch.equal(out["topk_scores"], pre_scores)
    assert not torch.equal(table2, store.table)  # and the push did land after
    _same_topk(out["topk_scores"], out["topk_ids"], w_out["topk_scores"], w_out["topk_ids"])
    np.testing.assert_allclose(table2.numpy(), np.asarray(w_table), **TABLES)
    np.testing.assert_allclose(state2.numpy(), np.asarray(w_state), **TABLES)


def test_query_topk_on_packed_store():
    """Serving sees LOGICAL rows: packed results equal dense, with and
    without exclusions, and equal the reference's packed store."""
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(100, 64)).astype(np.float32)
    users = rng.normal(size=(16, 64)).astype(np.float32)
    uids = np.arange(8, dtype=np.int32)
    dense = ShardedParamStore.from_values(_t(vals), device="cpu")
    packed = ShardedParamStore.from_values(_t(vals), layout="packed", device="cpu")
    assert packed.spec.pack == 2  # really packed
    sd, idd = query_topk(dense, _t(users), _t(uids), k=5)
    sp, idp = query_topk(packed, _t(users), _t(uids), k=5)
    assert torch.equal(idd, idp)
    np.testing.assert_allclose(sd.numpy(), sp.numpy(), **SCORES)
    excl = idd[:, :2].to(torch.int32)
    sd2, idd2 = query_topk(dense, _t(users), _t(uids), k=5, exclude=excl)
    sp2, idp2 = query_topk(packed, _t(users), _t(uids), k=5, exclude=excl)
    assert torch.equal(idd2, idp2)
    ref = RefStore.from_values(jnp.asarray(vals), layout="packed")
    want = ref_topk.query_topk(ref, jnp.asarray(users), jnp.asarray(uids), k=5,
                               exclude=jnp.asarray(excl.numpy()))
    _same_topk(sp2, idp2, want[0], want[1])


@pytest.mark.parametrize("width", [100, 64, 17])
def test_query_topk_packed_any_width(width):
    """Packed stores serve top-k at every width class: pack == 1
    lane-padded (100), pack > 1 (64, 17)."""
    ref_packed = RefStore.create(50, (width,), init_fn=ref_normal(0, (width,)), layout="packed")
    vals = np.asarray(ref_packed.values())
    packed = ShardedParamStore.from_values(_t(vals), layout="packed", device="cpu")
    dense = ShardedParamStore.from_values(_t(vals), device="cpu")
    q_users = np.random.default_rng(0).normal(size=(4, width)).astype(np.float32)
    uids = np.arange(4, dtype=np.int32)
    s_packed, i_packed = query_topk(packed, _t(q_users), _t(uids), k=5)
    s_dense, i_dense = query_topk(dense, _t(q_users), _t(uids), k=5)
    _same_topk(s_packed, i_packed, s_dense, i_dense)
    want = ref_topk.query_topk(ref_packed, jnp.asarray(q_users), jnp.asarray(uids), k=5)
    _same_topk(s_packed, i_packed, want[0], want[1])


def test_mf_topk_step_packed_pack1_width():
    """The train+serve step on a pack == 1 packed store (width 100, rows
    lane-padded to 128)."""
    width, cap, users, b = 100, 40, 8, 16
    ref_store = RefStore.create(cap, (width,), init_fn=ref_normal(0, (width,)), layout="packed")
    batch = _mf_batch(np.random.default_rng(1), b, users, cap, np.arange(4))
    _, (table, state, out), (w_table, w_state, w_out) = _topk_steps(ref_store, width, users, batch, 3, 0.01)
    assert tuple(out["topk_ids"].shape) == (4, 3)
    assert bool(torch.isfinite(out["topk_scores"]).all())
    _same_topk(out["topk_scores"], out["topk_ids"], w_out["topk_scores"], w_out["topk_ids"])
    np.testing.assert_allclose(table.numpy(), np.asarray(w_table), **TABLES)


def test_topk_ties_keep_the_reference_order_and_padding():
    """All-equal rows: equal scores come lowest index first, as lax.top_k
    returns them.  dense_topk keeps the row ids of rows masked past
    ``valid_rows`` and pads with -1 only past the table; query_topk with
    exclusions turns every -inf lane into id -1."""
    table = np.ones((12, 4), np.float32)
    q = np.random.default_rng(4).normal(size=(3, 4)).astype(np.float32)
    got = dense_topk(_t(table), _t(q), 15, valid_rows=9)
    want = ref_ops_topk.dense_topk(jnp.asarray(table), jnp.asarray(q), 15, valid_rows=9)
    _same_topk(*got, *want)
    assert got[1][0].tolist() == list(range(12)) + [-1] * 3
    assert torch.isneginf(got[0][:, 9:]).all() and torch.isfinite(got[0][:, :9]).all()

    # a store of capacity 9 is padded to 16 rows: 9 real, then padding
    store = ShardedParamStore.from_values(_t(table[:9]), device="cpu")
    ref = RefStore.from_values(jnp.asarray(table[:9]))
    uids = np.array([0, 1, 2], np.int32)
    got = query_topk(store, _t(q), _t(uids), 12)
    _same_topk(*got, *ref_topk.query_topk(ref, jnp.asarray(q), jnp.asarray(uids), 12))
    assert got[1][0].tolist() == list(range(12))  # rows 9-11 are padding, -inf
    exclude = np.array([[0, 3, -1], [8, 7, 6], [1, 1, 1]], np.int32)
    got = query_topk(store, _t(q), _t(uids), 10, exclude=_t(exclude))
    want = ref_topk.query_topk(ref, jnp.asarray(q), jnp.asarray(uids), 10, exclude=jnp.asarray(exclude))
    _same_topk(*got, *want)
    assert got[1].tolist() == [[1, 2, 4, 5, 6, 7, 8, -1, -1, -1], [0, 1, 2, 3, 4, 5, -1, -1, -1, -1],
                               [0, 2, 3, 4, 5, 6, 7, 8, -1, -1]]


# ---------------------------------------------------------------------------
# the slice: the same stream through both drivers' serve_with
# ---------------------------------------------------------------------------


def test_serve_with_matches_the_reference_driver():
    """The same 24 microbatches through the JAX StreamingDriver.serve_with
    and the port's (K1's plain version on the CPU): the final top-K
    answers, with and without exclusions, their versions and staleness,
    and the lookups match."""
    num_users, num_items, dim = 64, 96, 8
    data = synthetic_ratings(num_users, num_items, 24 * 128, rank=3, seed=9)
    batches = list(microbatches(data, 128, shuffle_seed=1))
    kw = dict(publish_every=4, max_batch=16, max_delay_ms=1.0)

    ref = ref_driver.StreamingDriver(
        ref_mf.OnlineMatrixFactorization(num_users, dim, updater=ref_mf.SGDUpdater(0.05)),
        RefStore.create(num_items, (dim,), init_fn=ref_init(1, (dim,))),
        config=ref_driver.DriverConfig(dump_model=False),
    )
    logic = OnlineMatrixFactorization(num_users, dim, updater=SGDUpdater(0.05), device="cpu")
    store = ShardedParamStore.create(num_items, (dim,), init_fn=ranged_random_factor(1, (dim,)),
                                     scatter_impl="pallas", device="cpu")
    port = StreamingDriver(logic, store, config=DriverConfig(dump_model=False))
    services = [d.serve_with(**kw) for d in (port, ref)]
    for d in (port, ref):
        d.run(batches, collect_outputs=False)
    try:
        assert [s.snapshots.latest().version for s in services] == [8, 8]  # 1 + 6 + the close-time one
        np.testing.assert_allclose(port.store.values().numpy(), np.asarray(ref.store.values()), **TABLES)
        (client, ref_client) = (s.client() for s in services)
        for user, exclude in ((3, ()), (17, (5, 6, 7)), (63, tuple(range(0, 96, 3)))):
            _same_answer(client.top_k(user, k=7, exclude=exclude), ref_client.top_k(user, k=7, exclude=exclude))
        _same_answer(client.lookup([0, 50, 95]), ref_client.lookup([0, 50, 95]))
    finally:
        for s in services:
            s.stop()


def test_sharded_topk_waits_for_the_mesh_item():
    from flink_parameter_server_tpu_torch.ops.topk import sharded_topk

    for mesh in (object(), None):
        with pytest.raises(NotImplementedError, match="Queue 1 #9"):
            sharded_topk(torch.ones(4, 2), torch.ones(1, 2), 2, mesh=mesh)
