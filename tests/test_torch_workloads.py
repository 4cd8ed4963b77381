"""The other batched workloads against the JAX package: passive-aggressive
(binary, multiclass), the count-min / Bloom / tug-of-war sketches, word2vec
SGNS and the factorization machine.

Parity: the same seeded numpy batches and the same initial table (the
reference's, crossed with ``interop.store_from_numpy``) go through the
reference's logic and store and the port's, on the CPU.  The reference's
``scatter_impl="pallas"`` runs its Pallas kernel in interpret mode, the
port's the kernel's plain version (K1's ``run_sum_write_plain``).
Tolerances:
  * one ``step`` (pulled rows -> deltas, push ids and mask, outputs):
    float32 at rtol 1e-5 / atol 1e-6; sketch deltas and ids exact;
  * four ``transform_batched`` steps under every ``scatter_impl`` x
    ``layout``: sketch tables, their outputs and ``estimate_f2`` exact
    (whole-number float32 counts); PA, SGNS and FM tables at rtol 1e-5 with
    atol 1e-5 of the largest |value|, since the two packages sum duplicate
    deltas in another order.  The packed arms cover both of the
    reference's packed routes: pack <= 16 (SGNS) goes through the kernel's
    in-row ``sub_k``, pack > 16 (scalars, PA's 4-class rows, the FM row
    here) through physical rows; the port takes ``sub_k`` for every pack.

Mirrors: tests/test_passive_aggressive.py (3 here, the event-API test in
tests/test_torch_event_api.py; the sharded test waits for ROADMAP Queue 1
#9), tests/test_sketches.py (6 of 7; the sharded test waits for #9),
tests/test_word2vec_fm.py (all 6) and tests/test_workloads.py's TestChaos
(the sketch's increments through a mid-frame RST and a kill -> promote,
integer-exact, on the port's nemesis runner with ``device="cpu"``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.core.store import ShardedParamStore as RefStore
from flink_parameter_server_tpu.core.transform import transform_batched as ref_transform
from flink_parameter_server_tpu.models import factorization_machine as ref_fm
from flink_parameter_server_tpu.models import passive_aggressive as ref_pa
from flink_parameter_server_tpu.models import sketches as ref_sk
from flink_parameter_server_tpu.models import word2vec as ref_w2v
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch.core.transform import transform_batched
from flink_parameter_server_tpu_torch.data.streams import sparse_feature_batches
from flink_parameter_server_tpu_torch.data.text import (
    cooccurrence_pairs,
    skipgram_batches,
    synthetic_corpus,
)
from flink_parameter_server_tpu_torch.interop import spec_from_reference, store_from_numpy
from flink_parameter_server_tpu_torch.models import factorization_machine as fm
from flink_parameter_server_tpu_torch.models import passive_aggressive as pa
from flink_parameter_server_tpu_torch.models import sketches as sk
from flink_parameter_server_tpu_torch.models import word2vec as w2v
from flink_parameter_server_tpu_torch.models.factorization_machine import FMConfig, train_fm
from flink_parameter_server_tpu_torch.models.passive_aggressive import (
    PARule,
    transform_binary,
    transform_multiclass,
)
from flink_parameter_server_tpu_torch.models.sketches import (
    BloomCooccurrence,
    CountMinConfig,
    CountMinSketch,
    TugOfWarConfig,
    TugOfWarSketch,
    decay,
)
from flink_parameter_server_tpu_torch.models.word2vec import IN, sample_negatives, train_skipgram

torch.set_num_threads(2)

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
IMPLS = ["xla", "xla_sorted", "pallas"]
LAYOUTS = ["dense", "packed"]
SKETCHES = ("count_min", "bloom", "tug_of_war")


# ---------------------------------------------------------------------------
# The workloads at a small size: logics, initial reference store, batches.
# ---------------------------------------------------------------------------


def _sparse(rng, B, K, F, labels):
    return {
        "ids": ((rng.zipf(1.3, (B, K)) - 1) % F).astype(np.int32),
        "values": rng.normal(0, 1, (B, K)).astype(np.float32),
        "feat_mask": rng.random((B, K)) > 0.2,
        "label": labels,
        "mask": rng.random(B) > 0.1,
    }


def _workload(name, rng, **store_kw):
    """(reference logic, port logic, reference store, batch maker)."""
    if name in ("pa", "pa_multi"):
        F, C = 50, 4
        shape = () if name == "pa" else (C,)
        store = RefStore.create(F, shape, init_fn=ref_init(2, shape, low=-0.5, high=0.5), **store_kw)
        if name == "pa":
            logics = ref_pa.PassiveAggressiveBinary(ref_pa.PARule("PA-II", C=0.5)), pa.PassiveAggressiveBinary(
                pa.PARule("PA-II", C=0.5))
            make = lambda: _sparse(rng, 32, 4, F, rng.choice([-1.0, 1.0], 32).astype(np.float32))  # noqa: E731
        else:
            logics = ref_pa.PassiveAggressiveMulticlass(C), pa.PassiveAggressiveMulticlass(C)
            make = lambda: _sparse(rng, 32, 4, F, rng.integers(0, C, 32).astype(np.int32))  # noqa: E731
        return logics + (store, make)
    if name in ("count_min", "bloom"):
        cfg = (dict(width=64, depth=3, seed=5))
        ref_cls, cls = ((ref_sk.CountMinSketch, sk.CountMinSketch) if name == "count_min"
                        else (ref_sk.BloomCooccurrence, sk.BloomCooccurrence))
        ref_logic = ref_cls(ref_sk.CountMinConfig(**cfg))
        store = ref_logic.make_store(**store_kw)

        def make():
            keys = ((rng.zipf(1.3, 48) - 1) % 200).astype(np.int32)
            batch = {"mask": rng.random(48) > 0.1}
            if name == "count_min":
                batch["key"] = keys
            else:
                batch["word_a"] = keys
                batch["word_b"] = ((rng.zipf(1.3, 48) - 1) % 200).astype(np.int32)
            return batch

        return ref_logic, cls(sk.CountMinConfig(**cfg)), store, make
    if name == "tug_of_war":
        ref_logic = ref_sk.TugOfWarSketch(ref_sk.TugOfWarConfig(groups=4, per_group=8, seed=3))
        logic = sk.TugOfWarSketch(sk.TugOfWarConfig(groups=4, per_group=8, seed=3))
        make = lambda: {"key": ((rng.zipf(1.3, 40) - 1) % 100).astype(np.int32),  # noqa: E731
                        "mask": rng.random(40) > 0.1}
        return ref_logic, logic, ref_logic.make_store(**store_kw), make
    if name == "sgns":
        V, N = 60, 3
        store = ref_w2v.make_store(V, 16, seed=4, **store_kw)

        def make():
            return {
                "center": ((rng.zipf(1.3, 24) - 1) % V).astype(np.int32),
                "context": ((rng.zipf(1.3, 24) - 1) % V).astype(np.int32),
                "negatives": rng.integers(0, V, (24, N)).astype(np.int32),
                "mask": rng.random(24) > 0.1,
            }

        return ref_w2v.SkipGramNS(0.3), w2v.SkipGramNS(0.3), store, make
    if name == "fm":
        F = 70
        ref_cfg = ref_fm.FMConfig(num_features=F, dim=4, learning_rate=0.2, l2=0.01)
        cfg = fm.FMConfig(num_features=F, dim=4, learning_rate=0.2, l2=0.01)
        store = ref_fm.make_store(ref_cfg, seed=6, init_stddev=0.3, **store_kw)
        make = lambda: _sparse(rng, 24, 5, F, rng.choice([-1.0, 1.0], 24).astype(np.float32))  # noqa: E731
        return ref_fm.FactorizationMachine(ref_cfg), fm.FactorizationMachine(cfg), store, make
    raise ValueError(name)


WORKLOADS = ["pa", "pa_multi", "count_min", "bloom", "tug_of_war", "sgns", "fm"]


def _port_store(ref_store):
    return store_from_numpy(spec_from_reference(ref_store.spec), np.asarray(ref_store.table), device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _close(got, want, exact, rel_atol=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    elif rel_atol:
        atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    else:
        np.testing.assert_allclose(got, want, **STEP_TOL)


# ---------------------------------------------------------------------------
# One step, and four steps through transform_batched.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", WORKLOADS + ["sgns_dedup", "fm_squared"])
def test_step_matches_reference(name):
    rng = np.random.default_rng(11)
    base = {"sgns_dedup": "sgns", "fm_squared": "fm"}.get(name, name)
    ref_logic, logic, ref_store, make = _workload(base, rng)
    if name == "sgns_dedup":
        ref_logic = ref_w2v.SkipGramNS(0.3, dedup_scale=True, vocab_size=60)
        logic = w2v.SkipGramNS(0.3, dedup_scale=True, vocab_size=60)
    if name == "fm_squared":
        ref_logic = ref_fm.FactorizationMachine(ref_fm.FMConfig(num_features=70, dim=4, loss="squared", l2=0.01))
        logic = fm.FactorizationMachine(fm.FMConfig(num_features=70, dim=4, loss="squared", l2=0.01))
        make_base = make
        make = lambda: dict(make_base(), label=rng.normal(0, 1, 24).astype(np.float32))  # noqa: E731
    batch = make()
    ids = np.asarray(ref_logic.keys({k: jnp.asarray(v) for k, v in batch.items()}))
    np.testing.assert_array_equal(logic.keys(_torch_batch(batch)).numpy(), ids)
    pulled = np.array(ref_store.pull(jnp.asarray(ids)))
    if name not in SKETCHES:  # a live model, not the zero init
        pulled = pulled + rng.normal(0, 0.3, pulled.shape).astype(np.float32)
    _, ref_req, ref_out = ref_logic.step(ref_logic.init_state(None), {k: jnp.asarray(v) for k, v in batch.items()},
                                         jnp.asarray(pulled))
    _, req, out = logic.step(logic.init_state(None), _torch_batch(batch), torch.from_numpy(pulled))
    exact = name in SKETCHES
    np.testing.assert_array_equal(req.ids.numpy(), np.asarray(ref_req.ids))
    _close(req.deltas.numpy(), ref_req.deltas, exact)
    if ref_req.mask is None:
        assert req.mask is None
    else:
        np.testing.assert_array_equal(req.mask.numpy(), np.asarray(ref_req.mask))
    assert sorted(out) == sorted(ref_out)
    for key in ref_out:
        _close(out[key].numpy(), ref_out[key], exact or key == "prediction" and name == "pa_multi")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", WORKLOADS)
def test_four_steps_match_reference(name, impl, layout):
    rng = np.random.default_rng(3)
    ref_logic, logic, ref_store, make = _workload(name, rng, scatter_impl=impl, layout=layout)
    batches = [make() for _ in range(4)]
    store = _port_store(ref_store)
    assert store.spec.scatter_impl == impl and store.spec.layout == layout
    want = ref_transform(iter(batches), ref_logic, ref_store, dump_model=False)
    got = transform_batched(iter(batches), logic, store, dump_model=False)
    exact = name in SKETCHES
    _close(got.store.table.numpy(), want.store.table, exact, rel_atol=True)
    for o, ro in zip(got.worker_outputs, want.worker_outputs):
        for key in ro:
            if key != "prediction":  # the sign / argmax of a margin that agrees to rtol
                _close(o[key].numpy(), ro[key], exact, rel_atol=True)
    if name == "tug_of_war":
        assert float(logic.estimate_f2(got.store)) == float(ref_logic.estimate_f2(want.store))


def test_store_from_numpy_crosses_sgns_and_packed_fm_tables():
    """The (V, 2, d) SGNS table and the lane-packed FM table cross from the
    reference element for element, and the port's own init agrees: SGNS's
    uniform init bitwise, the FM's normal init to float32 rounding
    (torch's erfinv is not XLA's)."""
    ref_sgns = ref_w2v.make_store(37, 8, seed=2)
    got = _port_store(ref_sgns)
    assert got.table.shape == (40, 2, 8)
    np.testing.assert_array_equal(got.values().numpy(), np.asarray(ref_sgns.values()))
    np.testing.assert_array_equal(w2v.make_store(37, 8, seed=2, device="cpu").table.numpy(),
                                  np.asarray(ref_sgns.table))
    ref_cfg = ref_fm.FMConfig(num_features=50, dim=16)
    ref_store = ref_fm.make_store(ref_cfg, seed=1, layout="packed")
    got = _port_store(ref_store)
    assert got.spec.pack == 7 and got.table.shape == tuple(ref_store.table.shape)
    np.testing.assert_array_equal(got.values().numpy(), np.asarray(ref_store.values()))
    own = fm.make_store(fm.FMConfig(num_features=50, dim=16), seed=1, layout="packed", device="cpu")
    np.testing.assert_allclose(own.table.numpy(), np.asarray(ref_store.table), rtol=1e-5, atol=1e-9)


def test_estimate_f2_takes_the_mean_of_the_middle_pair():
    sketch = TugOfWarSketch(TugOfWarConfig(groups=4, per_group=1))
    store = sketch.make_store(device="cpu")
    store.table[:4] = torch.tensor([1.0, 3.0, 2.0, 4.0])  # means 1, 9, 4, 16
    assert float(sketch.estimate_f2(store)) == 6.5
    odd = TugOfWarSketch(TugOfWarConfig(groups=3, per_group=1))
    store = odd.make_store(device="cpu")
    store.table[:3] = torch.tensor([1.0, 3.0, 2.0])
    assert float(odd.estimate_f2(store)) == 4.0


def test_decay_does_not_alias_the_callers_table():
    sketch = CountMinSketch(CountMinConfig(width=16, depth=2))
    store = sketch.make_store(device="cpu")
    store.table += 2.0
    decayed = decay(store, 0.5)
    store.table += 1.0  # a later in-place step on the caller's store
    assert torch.equal(decayed.values(), torch.ones(32))


# ---------------------------------------------------------------------------
# Mirrors of tests/test_passive_aggressive.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def separable():
    rng = np.random.default_rng(1)
    w_true = rng.normal(0, 1, 20)
    X = rng.normal(0, 1, (600, 20)).astype(np.float32)
    X[rng.random(X.shape) < 0.5] = 0.0
    y = np.sign(X @ w_true + 1e-9)
    return X, y


def test_pa_binary_converges(separable):
    X, y = separable
    res = transform_binary(sparse_feature_batches(X, y, 64, epochs=3), num_features=20,
                           rule=PARule("PA-I", C=1.0), collect_outputs=False, device="cpu")
    w = res.store.values().numpy()
    assert np.mean(np.sign(X @ w) == y) > 0.93


def test_pa_rule_variants():
    t = lambda rule: float(rule.tau(torch.tensor(2.0), torch.tensor(4.0)))  # noqa: E731
    assert t(PARule("PA", C=0.5)) == 0.5
    assert t(PARule("PA-I", C=0.1)) == pytest.approx(0.1)
    assert t(PARule("PA-II", C=1.0)) == pytest.approx(2.0 / 4.5)
    with pytest.raises(ValueError, match="unknown PA variant"):
        PARule("PA-III").tau(torch.tensor(1.0), torch.tensor(1.0))


def test_pa_multiclass_converges():
    rng = np.random.default_rng(2)
    C, F = 4, 12
    W = rng.normal(0, 1, (F, C))
    X = rng.normal(0, 1, (800, F)).astype(np.float32)
    y = np.argmax(X @ W, axis=1)
    res = transform_multiclass(sparse_feature_batches(X, y, 64, epochs=4), num_features=F, num_classes=C,
                               rule=PARule("PA-I", C=1.0), collect_outputs=False, device="cpu")
    w = res.store.values().numpy()
    assert np.mean(np.argmax(X @ w, axis=1) == y) > 0.85


# ---------------------------------------------------------------------------
# Mirrors of tests/test_sketches.py
# ---------------------------------------------------------------------------


def _key_batches(keys, batch=512):
    for s in range(0, len(keys), batch):
        chunk = keys[s: s + batch]
        pad = batch - len(chunk)
        yield {"key": np.concatenate([chunk, np.zeros(pad, np.int32)]),
               "mask": np.concatenate([np.ones(len(chunk), bool), np.zeros(pad, bool)])}


def _sketch_run(sketch, batches):
    return transform_batched(batches, sketch, sketch.make_store(device="cpu"), collect_outputs=False)


def test_count_min_estimates_counts():
    rng = np.random.default_rng(0)
    keys = ((rng.zipf(1.5, 20_000) - 1) % 1000).astype(np.int32)
    sketch = CountMinSketch(CountMinConfig(width=2048, depth=4, seed=0))
    res = _sketch_run(sketch, _key_batches(keys))
    true = np.bincount(keys, minlength=1000)
    hot = np.argsort(true)[-20:]
    est = sketch.query(res.store, torch.from_numpy(hot.astype(np.int32))).numpy()
    assert (est >= true[hot] - 1e-6).all()
    assert (est <= true[hot] + 20_000 * 4 / 2048).all()


def test_bloom_cooccurrence_similarity():
    vocab = 100
    tokens = synthetic_corpus(vocab, 40_000, num_topics=4, topic_stickiness=0.995, seed=2)
    pair_sketch = BloomCooccurrence(CountMinConfig(width=1 << 14, depth=4, seed=2))
    pairs = transform_batched(cooccurrence_pairs(tokens, window=2), pair_sketch,
                              pair_sketch.make_store(device="cpu"), collect_outputs=False)
    word_sketch = CountMinSketch(CountMinConfig(width=4096, depth=4, seed=3))
    words = _sketch_run(word_sketch, _key_batches(tokens))
    wpt = vocab // 4
    a = torch.tensor([0, wpt, 2 * wpt])
    same = pair_sketch.similarity(pairs.store, words.store, word_sketch, a, torch.tensor([1, wpt + 1, 2 * wpt + 1]))
    cross = pair_sketch.similarity(pairs.store, words.store, word_sketch, a, torch.tensor([wpt, 2 * wpt, 3 * wpt]))
    assert float(same.mean()) > float(cross.mean()) * 2, (same, cross)


def test_tug_of_war_f2():
    rng = np.random.default_rng(4)
    keys = ((rng.zipf(1.4, 30_000) - 1) % 2000).astype(np.int32)
    sketch = TugOfWarSketch(TugOfWarConfig(groups=8, per_group=32, seed=4))
    res = _sketch_run(sketch, _key_batches(keys))
    counts = np.bincount(keys, minlength=2000).astype(np.float64)
    true_f2 = float((counts**2).sum())
    est = float(sketch.estimate_f2(res.store))
    assert 0.5 * true_f2 < est < 2.0 * true_f2, (est, true_f2)


def test_decay_halves_counters():
    sketch = CountMinSketch(CountMinConfig(width=64, depth=2))
    res = _sketch_run(sketch, _key_batches(np.arange(10, dtype=np.int32)))
    decayed = decay(res.store, 0.5)
    np.testing.assert_allclose(decayed.values().numpy(), res.store.values().numpy() * 0.5)


def test_count_min_heavy_hitters():
    rng = np.random.default_rng(5)
    keys = ((rng.zipf(1.5, 15_000) - 1) % 500).astype(np.int32)
    sketch = CountMinSketch(CountMinConfig(width=4096, depth=4, seed=5))
    res = _sketch_run(sketch, _key_batches(keys))
    true = np.bincount(keys, minlength=500)
    est, ids = sketch.top_k(res.store, torch.arange(500), k=5)
    assert set(ids.tolist()) == set(np.argsort(true)[-5:].tolist())


def test_heavy_hitters_pads_to_k():
    sketch = CountMinSketch(CountMinConfig(width=64, depth=2, seed=6))
    res = _sketch_run(sketch, _key_batches(np.zeros(600, np.int32)))
    est, ids = sketch.top_k(res.store, torch.arange(2), k=5)
    assert ids.shape == (5,) and est.shape == (5,)
    assert (ids[2:] == -1).all()
    # and the same answer as the reference's, padding included
    ref_sketch = ref_sk.CountMinSketch(ref_sk.CountMinConfig(width=64, depth=2, seed=6))
    ref_res = ref_transform(_key_batches(np.zeros(600, np.int32)), ref_sketch, ref_sketch.make_store(),
                            collect_outputs=False)
    ref_est, ref_ids = ref_sketch.top_k(ref_res.store, jnp.arange(2), k=5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(est.numpy(), np.asarray(ref_est))


# ---------------------------------------------------------------------------
# Mirrors of tests/test_word2vec_fm.py
# ---------------------------------------------------------------------------


def test_sgns_loss_decreases():
    vocab = 300
    tokens = synthetic_corpus(vocab, 20_000, num_topics=6, seed=0)
    losses = []
    res = train_skipgram(skipgram_batches(tokens, vocab, batch_size=512, epochs=2, seed=0), vocab_size=vocab,
                         dim=16, learning_rate=0.05, on_step=lambda i, out: losses.append(float(out["loss"].mean())),
                         collect_outputs=False, device="cpu")
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])
    assert tuple(res.store.values().shape) == (vocab, 2, 16)


def test_sgns_topical_structure():
    vocab, topics = 200, 4
    tokens = synthetic_corpus(vocab, 60_000, num_topics=topics, topic_stickiness=0.995, seed=1)
    res = train_skipgram(skipgram_batches(tokens, vocab, batch_size=512, window=3, epochs=3, seed=1),
                         vocab_size=vocab, dim=16, learning_rate=0.05, collect_outputs=False, device="cpu")
    emb = res.store.values().numpy()[:, IN]
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    wpt = vocab // topics
    same = [float(emb[t * wpt] @ emb[t * wpt + 1]) for t in range(topics)]
    diff = [float(emb[t * wpt] @ emb[((t + 1) % topics) * wpt]) for t in range(topics)]
    assert np.mean(same) > np.mean(diff) + 0.2, (same, diff)


def test_sample_negatives_follows_cdf():
    probs = np.array([0.5, 0.25, 0.125, 0.125])
    cdf = torch.from_numpy(np.cumsum(probs)).to(torch.float32)
    s = sample_negatives(torch.Generator().manual_seed(0), cdf, (20_000,))
    assert s.dtype == torch.int32
    np.testing.assert_allclose(np.bincount(s.numpy(), minlength=4) / 20_000, probs, atol=0.02)
    # the left side of the search, as jnp.searchsorted: a draw equal to a
    # cdf value maps to that value's index
    edge = torch.searchsorted(cdf, torch.tensor([0.5, 0.75]))
    np.testing.assert_array_equal(edge.numpy(), np.asarray(jnp.searchsorted(jnp.asarray(cdf.numpy()),
                                                                            jnp.asarray([0.5, 0.75]))))


def _fm_batches(rng, n, num_feats, k, w, V, batch=256):
    for _ in range(0, n, batch):
        ids = rng.integers(0, num_feats, (batch, k)).astype(np.int32)
        vv = V[ids]
        s = vv.sum(1)
        inter = 0.5 * ((s * s).sum(1) - (vv * vv).sum((1, 2)))
        y = np.sign(w[ids].sum(1) + inter + 1e-9)
        yield {"ids": ids, "values": np.ones((batch, k), np.float32), "feat_mask": np.ones((batch, k), bool),
               "label": y.astype(np.float32), "mask": np.ones(batch, bool)}


def test_fm_learns_synthetic_interactions():
    rng = np.random.default_rng(3)
    F, k = 60, 5
    w_true = rng.normal(0, 1, F)
    V_true = rng.normal(0, 0.5, (F, 4))
    res = train_fm(_fm_batches(rng, 6 * 2048, F, k, w_true, V_true),
                   FMConfig(num_features=F, dim=4, learning_rate=0.05), collect_outputs=False, device="cpu")
    eval_batch = next(_fm_batches(np.random.default_rng(3), 2048, F, k, w_true, V_true))
    model = res.store.values().numpy()
    w, V = model[:, 0], model[:, 1:]
    ids = eval_batch["ids"]
    inter = np.array([0.5 * ((V[i].sum(0) @ V[i].sum(0)) - (V[i] * V[i]).sum()) for i in ids])
    assert np.mean(np.sign(w[ids].sum(1) + inter) == eval_batch["label"]) > 0.75


def test_fm_squared_loss_gradient_check():
    """The FM step's deltas against torch.autograd of the same objective
    (squared loss, lr 1: delta = -grad)."""
    logic = fm.FactorizationMachine(FMConfig(num_features=10, dim=3, learning_rate=1.0, loss="squared"))
    rng = np.random.default_rng(0)
    pulled = torch.from_numpy(rng.normal(0, 0.5, (2, 4, 4)).astype(np.float32))
    batch = {"ids": torch.from_numpy(rng.integers(0, 10, (2, 4)).astype(np.int32)),
             "values": torch.from_numpy(rng.normal(0, 1, (2, 4)).astype(np.float32)),
             "feat_mask": torch.ones((2, 4), dtype=torch.bool), "label": torch.tensor([0.3, -0.7]),
             "mask": torch.ones(2, dtype=torch.bool)}

    def objective(p):
        x = batch["values"]
        xv = x[..., None] * p[..., 1:]
        s = xv.sum(1)
        inter = 0.5 * ((s * s).sum(-1) - (xv * xv).sum((1, 2)))
        return (0.5 * ((p[..., 0] * x).sum(-1) + inter - batch["label"]) ** 2).sum()

    p = pulled.clone().requires_grad_()
    (grad,) = torch.autograd.grad(objective(p), p)
    _, req, _ = logic.step((), batch, pulled)
    np.testing.assert_allclose(req.deltas.numpy(), -grad.numpy(), rtol=2e-4, atol=2e-5)


def test_sgns_dedup_scale_stabilizes_high_lr():
    vocab = 300
    tokens = synthetic_corpus(vocab, 20_000, num_topics=6, seed=0)
    losses = []
    transform_batched(skipgram_batches(tokens, vocab, batch_size=512, epochs=2, seed=0),
                      w2v.SkipGramNS(1.0, dedup_scale=True, vocab_size=vocab), w2v.make_store(vocab, 16, seed=0,
                                                                                             device="cpu"),
                      on_step=lambda i, o: losses.append(float(o["loss"].mean())), collect_outputs=False,
                      dump_model=False)
    assert max(losses) < 10.0, max(losses)
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5])


# ---------------------------------------------------------------------------
# chaos: sketch increments under mid-frame RST + kill->promote replay
# integer-exact
# ---------------------------------------------------------------------------


class TestChaos:
    def test_sketch_rst_kill_promote_integer_exact(self, tmp_path):
        from flink_parameter_server_tpu_torch.nemesis.runner import (
            run_scenario,
        )
        from flink_parameter_server_tpu_torch.nemesis.scenarios import (
            NemesisOp,
            Scenario,
        )

        s = Scenario(
            "sketch_rst_promote_direct",
            (
                NemesisOp(2, "truncate_next", shard=0, mode="c2s",
                          keep_frac=0.4, cut="payload"),
                NemesisOp(4, "kill_shard", shard=0),
                NemesisOp(4, "promote_shard", shard=0),
            ),
            seed=207,
            rounds=8,
            batch=64,
            num_items=48,
            replicated=True,
            workload="sketch",
            wire_format="q8",
        )
        report = run_scenario(s, wal_root=str(tmp_path), device="cpu")
        bad = [v for v in report.verdicts if not v.ok]
        assert report.ok, bad
        parity = next(
            v for v in report.verdicts
            if v.name == "final_table_parity"
        )
        assert "integer-exact" in parity.detail
        assert "mismatched_cells=0" in parity.detail
