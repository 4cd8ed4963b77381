"""The port's workload runtime (``workloads/``) against the JAX package's.

Tolerances, all on the CPU (the port with ``device="cpu"``):
  * every workload's ``batches()`` bitwise the reference's on the same
    ``WorkloadParams``;
  * the sketch: oracle and cluster tables exactly equal to the reference's
    (whole-number float32 counts);
  * PA: the port's BSP cluster bitwise its own streaming oracle (the bar the
    reference holds its own to); the port's oracle within rtol 1e-5 /
    atol 1e-6 of the reference's, since the on-device combine sums a
    round's duplicate features in torch's order and the reference's in
    XLA's;
  * MF: the port's 2-shard cluster table within rtol 1e-4 / atol 1e-6 of
    the reference's (the reference's cluster bar).

Mirrors tests/test_workloads.py's TestRegistry (4), TestParity (5),
TestPushSemantics (4) and TestServing (2): 15 of its 22 tests.  TestChaos
is mirrored in tests/test_torch_workloads.py (on the port's nemesis
runner); TestSoakArms, TestPsctl and TestTooling wait for ``loadgen/``'s
soak and the tooling (ROADMAP Queue 1 #7h).
"""
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.cluster.driver import ClusterConfig as RefConfig
from flink_parameter_server_tpu.workloads import WorkloadParams as RefParams
from flink_parameter_server_tpu.workloads import build_cluster_driver as ref_build
from flink_parameter_server_tpu.workloads import create_workload as ref_create
from flink_parameter_server_tpu_torch.cluster.driver import ClusterConfig
from flink_parameter_server_tpu_torch.core.transform import to_device, to_host
from flink_parameter_server_tpu_torch.workloads import (
    DenseCombineLogic,
    WorkloadParams,
    WorkloadServingClient,
    build_cluster_driver,
    create_workload,
    run_streaming,
    serve_workload,
    workload_names,
    workload_table,
)

torch.set_num_threads(2)

pytestmark = pytest.mark.workloads

CPU = "cpu"
BAR = dict(rtol=1e-4, atol=1e-6)  # the reference's cluster parity bar
PA_TOL = dict(rtol=1e-5, atol=1e-6)  # port vs reference float32 sums

SMALL = WorkloadParams(
    rounds=6, batch=48, num_users=24, num_items=32, dim=4, seed=3
)
REF_SMALL = RefParams(
    rounds=6, batch=48, num_users=24, num_items=32, dim=4, seed=3
)


def _wl(name, params=SMALL):
    return create_workload(name, params, device=CPU)


def _same_stream(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_builtin_names(self):
        assert {"mf", "pa", "sketch"} <= set(workload_names())

    def test_unknown_name_is_loud(self):
        with pytest.raises(KeyError, match="unknown workload"):
            create_workload("word2vec", device=CPU)

    def test_describe_contract(self):
        pa = _wl("pa")
        d = pa.describe()
        assert d["push_semantics"] == "delta"
        assert d["parity"] == "bitwise"
        assert d["serving_verbs"] == ["predict"]
        sk = _wl("sketch")
        d = sk.describe()
        assert d["push_semantics"] == "increment"
        assert d["parity"] == "exact_int"
        assert set(d["serving_verbs"]) == {"query", "topk"}
        # and each descriptor is the reference's
        for name in ("mf", "pa", "sketch"):
            assert _wl(name).describe() == ref_create(name, REF_SMALL).describe()

    def test_mf_workload_matches_legacy_stream(self):
        """The registry-packaged MF stream is the seed-3 synthetic
        ratings, microbatched — and bit for bit the reference's."""
        from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
        from flink_parameter_server_tpu_torch.data.streams import microbatches

        mf = _wl("mf")
        got = mf.batches()
        cols = synthetic_ratings(
            SMALL.num_users, SMALL.num_items, SMALL.rounds * SMALL.batch, seed=3,
        )
        _same_stream(got, list(microbatches(cols, SMALL.batch)))
        _same_stream(got, ref_create("mf", REF_SMALL).batches())


@pytest.mark.parametrize("name", ["mf", "pa", "sketch"])
def test_streams_match_the_reference(name):
    _same_stream(_wl(name).batches(), ref_create(name, REF_SMALL).batches())


def test_workloads_default_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            create_workload("pa", SMALL)


def test_run_streaming_is_the_oracle():
    assert np.array_equal(run_streaming("pa", params=SMALL, device=CPU),
                          _wl("pa").oracle_values())


# ---------------------------------------------------------------------------
# parity: PA bitwise, sketch integer-exact, MF at the cluster bar
# ---------------------------------------------------------------------------


def _pa_cluster(pa, **cfg):
    driver = build_cluster_driver(
        pa,
        config=ClusterConfig(num_shards=2, num_workers=1, staleness_bound=0, **cfg),
        registry=False,
    )
    with driver:
        return driver.run(pa.batches(), timeout=120)


class TestParity:
    def test_pa_cluster_bitwise_vs_streaming_oracle(self):
        pa = _wl("pa")
        oracle = pa.oracle_values()
        result = _pa_cluster(pa)
        assert np.array_equal(result.values, oracle), (
            "BSP cluster PA table is not bitwise the streaming oracle"
        )
        v = pa.parity_verdict(result.values, oracle)
        assert v.ok and "bitwise" in v.detail
        # the port's oracle against the reference's
        np.testing.assert_allclose(oracle, ref_create("pa", REF_SMALL).oracle_values(),
                                   **PA_TOL)

    def test_pa_oracle_anchored_to_streaming_driver(self):
        """The sequential streaming oracle against the literal
        StreamingDriver run (its table adds on the device, the oracle on
        the host): pinned allclose tight."""
        pa = _wl("pa")
        np.testing.assert_allclose(
            pa.oracle_values(), pa.streaming_driver_values(),
            rtol=1e-5, atol=1e-6,
        )

    def test_pa_bitwise_holds_at_the_fusion_sensitive_shape(self):
        """The shape where the reference's fused program diverges by ulps
        from its standalone step (rounds=10, batch=64, F=48, seed=0): the
        cluster must still be bitwise its oracle."""
        p = WorkloadParams(rounds=10, batch=64, num_items=48, seed=0)
        pa = _wl("pa", p)
        oracle = pa.oracle_values()
        result = _pa_cluster(pa)
        assert np.array_equal(result.values, oracle)
        ref = ref_create("pa", RefParams(rounds=10, batch=64, num_items=48, seed=0))
        np.testing.assert_allclose(oracle, ref.oracle_values(), **PA_TOL)

    def test_sketch_integer_exact_two_workers_q8_requested(self):
        """Two interleaving workers + a REQUESTED q8 codec: counts
        must still be integer-exact because increment semantics
        bypass quantization (and integer adds commute)."""
        sk = _wl("sketch")
        oracle = sk.oracle_values()
        ref = ref_create("sketch", REF_SMALL)
        assert np.array_equal(oracle, ref.oracle_values())
        driver = build_cluster_driver(
            sk,
            config=ClusterConfig(
                num_shards=2, num_workers=2, staleness_bound=0,
                wire_format="q8",
            ),
            registry=False,
        )
        with driver:
            # the carve-out must have stripped the compressor from
            # every worker client
            assert all(
                c._compressor is None and c.wire_format == "b64"
                for c in driver._clients
            )
            result = driver.run(sk.batches(), timeout=120)
        v = sk.parity_verdict(result.values, oracle)
        assert v.ok, v.detail
        assert np.array_equal(result.values, oracle)
        ref_driver = ref_build(
            ref, config=RefConfig(num_shards=2, num_workers=2, staleness_bound=0,
                                  wire_format="q8"),
            registry=False,
        )
        with ref_driver:
            assert np.array_equal(result.values, ref_driver.run(ref.batches()).values)

    def test_dense_combine_preserves_masked_sums(self):
        """DenseCombineLogic unit: the dense per-round push equals the
        masked lane sums of the inner logic's request (numpy oracle) and
        the reference's combine, and untouched ids stay unmasked."""
        import jax

        pa = _wl("pa")
        logic = pa.make_logic()
        assert isinstance(logic, DenseCombineLogic)
        batch = pa.batches()[0]
        db = to_device(batch, torch.device(CPU))
        ids = to_host(logic.keys(db))
        pulled = np.zeros(ids.shape, np.float32)
        _state, req, _out = logic.step((), db, torch.from_numpy(pulled))
        dense = to_host(req.deltas)
        touched = to_host(req.mask)
        # inner-step oracle
        _, ireq, _ = logic.inner.step((), db, torch.from_numpy(pulled))
        m = to_host(ireq.mask).reshape(-1)
        flat_ids = to_host(ireq.ids).reshape(-1)[m]
        flat_d = to_host(ireq.deltas).reshape(-1)[m]
        want = np.zeros(pa.capacity, np.float64)
        np.add.at(want, flat_ids, flat_d.astype(np.float64))
        np.testing.assert_allclose(
            dense[touched], want[touched], rtol=1e-5, atol=1e-6
        )
        assert not touched[~np.isin(np.arange(pa.capacity), flat_ids)].any()
        # the reference's combine on the same batch
        ref_logic = ref_create("pa", REF_SMALL).make_logic()
        _, rreq, _ = jax.jit(ref_logic.step)((), batch, pulled)
        assert np.array_equal(touched, np.asarray(rreq.mask))
        np.testing.assert_allclose(dense, np.asarray(rreq.deltas), **PA_TOL)
        assert np.array_equal(to_host(req.ids), np.asarray(rreq.ids))


def test_mf_cluster_matches_the_reference():
    """MF's oracle (the static 2-shard hash BSP cluster) against the
    reference's, at the reference's cluster bar."""
    mf = _wl("mf")
    got = mf.oracle_values()
    want = ref_create("mf", REF_SMALL).oracle_values()
    np.testing.assert_allclose(got, want, **BAR)
    v = mf.parity_verdict(got, want)
    assert v.ok, v.detail


# ---------------------------------------------------------------------------
# the push-semantics seam + error feedback
# ---------------------------------------------------------------------------


class TestPushSemantics:
    def _probe(self, name, **cfg):
        driver = build_cluster_driver(
            _wl(name),
            config=ClusterConfig(num_shards=1, num_workers=1, staleness_bound=2,
                                 wire_format="q8", **cfg),
            registry=False,
        )
        with driver:
            client = driver._make_client(worker="probe")
            try:
                return client.wire_format, client._compressor
            finally:
                client.close()

    def test_increment_downgrade_in_make_client(self):
        fmt, comp = self._probe("sketch")
        assert fmt == "b64" and comp is None

    def test_delta_workload_keeps_q8_under_ssp(self):
        fmt, comp = self._probe("pa")
        assert fmt == "q8" and comp is not None

    def test_error_feedback_is_pa_compatible(self):
        """The compression plane's ≤1-granule-per-id delivered-sum
        property holds on PA-shaped SCALAR rows."""
        from flink_parameter_server_tpu_torch.compression.quantizers import (
            DeltaCompressor,
        )

        rng = np.random.default_rng(0)
        F = 32
        comp = DeltaCompressor("q8")
        delivered = np.zeros(F, np.float64)
        exact = np.zeros(F, np.float64)
        granule = np.zeros(F, np.float64)
        ids = np.arange(F, dtype=np.int64)
        for _ in range(40):
            deltas = (
                rng.standard_normal(F).astype(np.float32)
                * (rng.random(F) < 0.4)
            )
            dq, q, scales = comp.compress(ids, deltas)
            assert q is not None and scales is not None
            delivered += np.asarray(dq, np.float64).reshape(F)
            exact += deltas.astype(np.float64)
            granule = np.maximum(
                granule, np.asarray(scales, np.float64).reshape(F)
            )
        err = np.abs(delivered - exact)
        assert (err <= granule + 1e-6).all(), (
            f"error feedback broke on scalar rows: "
            f"max err {err.max():.3e} vs granule {granule.max():.3e}"
        )

    def test_pa_q8_cluster_tracks_oracle_within_granules(self):
        """A PA cluster run with the q8 push codec, async, stays within
        error-feedback distance of the exact fp32 oracle."""
        pa = _wl("pa")
        oracle = pa.oracle_values()
        driver = build_cluster_driver(
            pa,
            config=ClusterConfig(
                num_shards=2, num_workers=1, staleness_bound=None,
                wire_format="q8",
            ),
            registry=False,
        )
        with driver:
            result = driver.run(pa.batches(), timeout=120)
        assert np.abs(result.values - oracle).max() < 0.05


# ---------------------------------------------------------------------------
# serving verbs over live TCP
# ---------------------------------------------------------------------------


class TestServing:
    def test_sketch_query_topk_tcp(self):
        from flink_parameter_server_tpu_torch.telemetry.registry import MetricsRegistry

        reg = MetricsRegistry()
        sk = _wl("sketch")
        driver = build_cluster_driver(
            sk,
            config=ClusterConfig(num_shards=2, num_workers=1, staleness_bound=0),
            registry=reg,
        )
        with driver:
            table = driver.run(sk.batches(), timeout=120).values
            client = driver._make_client(worker="serve")
            server = serve_workload(sk, client, registry=reg)
            try:
                sc = WorkloadServingClient(server.host, server.port)
                tokens = sk._tokens()
                true = np.bincount(tokens, minlength=sk.vocab)
                keys = [int(np.argmax(true)), 0]
                est = sc.query(keys)
                # count-min never underestimates; the answer is the
                # numpy estimate over the same table
                for k, e in zip(keys, est):
                    assert e >= int(true[k])
                numpy_est = table[sk.cells_np(np.arange(sk.vocab))].min(axis=1)
                assert est == [int(numpy_est[k]) for k in keys]
                top = sc.topk(3)
                assert len(top) == 3
                assert top[0][0] == int(np.argmax(true))
                assert top[0][1] >= int(true.max())
                # ranked as lax.top_k ranks: descending, ties lowest id first
                order = sorted(range(sk.vocab), key=lambda i: (-numpy_est[i], i))[:3]
                assert top == [(i, int(numpy_est[i])) for i in order]
                info = sc.info()
                assert info["name"] == "sketch"
                with pytest.raises(RuntimeError, match="bad-request"):
                    sc.query([])
                with pytest.raises(RuntimeError, match="bad-request"):
                    sc.predict([[(0, 1.0)]])
                rates = workload_table(reg)
                assert rates["sketch"]["queries_total"] >= 2
                assert rates["sketch"]["topk_total"] == 1
                assert rates["sketch"]["serving_errors_total"] == 2
                assert rates["sketch"]["queries_observed"] >= 3
            finally:
                server.stop()
                client.close()

    def test_pa_predict_margins_match_table(self):
        pa = _wl("pa")
        driver = build_cluster_driver(
            pa,
            config=ClusterConfig(num_shards=2, num_workers=1, staleness_bound=0),
            registry=False,
        )
        with driver:
            result = driver.run(pa.batches(), timeout=120)
            w = result.values
            client = driver._make_client(worker="serve")
            server = serve_workload(pa, client, registry=False)
            try:
                sc = WorkloadServingClient(server.host, server.port)
                ex = [[(0, 1.5), (3, -0.5)], [(7, 2.0)]]
                margins = sc.predict(ex)
                want = [1.5 * w[0] - 0.5 * w[3], 2.0 * w[7]]
                np.testing.assert_allclose(margins, want, rtol=1e-4, atol=1e-5)
            finally:
                server.stop()
                client.close()
