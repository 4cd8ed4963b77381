"""The port's parameter server on a 2 x 2 mesh vs the JAX package's sharded functions.

Mirrors the mesh tests of tests/test_store.py (5), test_pallas_scatter.py
(:79, :96), test_sorted_scatter.py (:72, :137, :197),
test_round2_fixes.py (:136), test_serving.py (:196),
test_passive_aggressive.py (:100), test_sketches.py (:51) and
test_parallel_extras.py (:17, :24, :31), plus the names of
test_public_api.py (:30, :88, :105), and the interop of a sharded store.
The MF steps on the same mesh are in ``test_torch_parallel_mf.py``.

The port runs in four spawned gloo ranks on the CPU
(``tests/_torch_mesh_child.py``, one spawn for the whole battery, with a
wall-clock limit), each rank holding its block of every table; the
reference runs here on four of the conftest's virtual devices at the same
mesh shape.  The same numpy inputs (written by the ranks) go to both.
Tolerances, stated per test: init, pulls and sketch tables are bitwise;
float pushes and MF tables at the mirrored JAX test's own rtol / atol.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_child import run_battery

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jmesh():
    from flink_parameter_server_tpu.parallel.mesh import make_mesh

    return make_mesh(2, 2, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def grid(tmp_path_factory, jmesh):
    """The battery's results: ``{case: [rank 0 .. 3 outputs]}``."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.utils.initializers import ranged_random_factor

    out = tmp_path_factory.mktemp("grid")
    # a sharded reference store for the interop case, as numpy
    ref = ShardedParamStore.create(50, (4,), init_fn=ranged_random_factor(11, (4,)), mesh=jmesh)
    ref = ref.push(jnp.array([0, 7, 7, 49, 33]), jnp.ones((5, 4)))
    np.savez(out / "inputs.npz", interop_table=np.asarray(ref.table),
             interop_capacity=np.int64(50), interop_value_shape=np.array([4]),
             interop_values=np.asarray(ref.values()),
             interop_pulled=np.asarray(ref.pull(jnp.array([0, 33, 49, 7]))))
    res = run_battery("grid", out, timeout=150)
    res["_inputs"] = dict(np.load(out / "inputs.npz"))
    return res


def _case(grid, name):
    """Every rank's outputs of one case; fails with the rank's traceback."""
    per_rank = grid.get(name)
    assert per_rank is not None, f"case {name} wrote nothing:\n{grid['_log'][-4000:]}"
    for r, res in enumerate(per_rank):
        assert isinstance(res, dict), f"case {name}, rank {r}:\n{res}"
    return per_rank


def _same_on_every_rank(per_rank, *keys):
    for key in keys:
        for r, res in enumerate(per_rank[1:], 1):
            np.testing.assert_array_equal(res[key], per_rank[0][key], err_msg=f"{key} rank {r}")


# --- tests/test_store.py ---------------------------------------------------


def test_sharded_store_matches_single_device(grid, jmesh):
    """Init bitwise (per-id); a push rtol 1e-6 (the reference's bar) and
    bitwise the port's single-device push here; pulls bitwise."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.utils.initializers import ranged_random_factor

    rs = _case(grid, "store_matches_single")
    _same_on_every_rank(rs, "init", "pushed", "pulled")
    r = rs[0]
    ref = ShardedParamStore.create(64, (8,), init_fn=ranged_random_factor(3, (8,)), mesh=jmesh)
    np.testing.assert_array_equal(r["init"], np.asarray(ref.values()))
    np.testing.assert_array_equal(r["init"], r["init_single"])
    ids = jnp.asarray(r["ids"])
    a = ref.push(ids, jnp.ones((5, 8)))
    np.testing.assert_allclose(r["pushed"], np.asarray(a.values()), rtol=1e-6)
    np.testing.assert_array_equal(r["pushed"], r["pushed_single"])
    np.testing.assert_array_equal(r["pulled"], r["pulled_single"])
    np.testing.assert_allclose(r["pulled"], np.asarray(a.pull(ids)), rtol=1e-6)
    # each rank holds only its ps block: 32 of the 64 rows
    for res in rs:
        assert res["block"].shape == (32, 8)


def test_from_values_model_load(grid):
    """Exact: the values and a pull come back as given."""
    for r in _case(grid, "from_values"):
        np.testing.assert_array_equal(r["values"], np.arange(20.0).reshape(10, 2))
        np.testing.assert_array_equal(r["pulled"], [[14.0, 15.0]])


def test_shard_pull_matches_take(grid, jmesh):
    """Bitwise: each rank's lanes (its dp block) against ``take`` and the
    reference's ``shard_pull`` on the same mesh shape."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.parallel.collectives import shard_pull

    table = jnp.arange(64 * 4, dtype=jnp.float32).reshape(64, 4)
    rs = _case(grid, "shard_pull")
    ids = rs[0]["ids"]
    want = np.asarray(shard_pull(ShardedParamStore.from_values(table, mesh=jmesh).table,
                                 jnp.asarray(ids), mesh=jmesh))
    for r in rs:
        d = int(r["dp_index"])
        np.testing.assert_array_equal(r["got"], want[d:d + 1])
        np.testing.assert_array_equal(r["got"][0], np.asarray(table)[ids[d]])


def test_shard_push_matches_scatter_add(grid, jmesh):
    """Exact (sums of ones): the dp slices all-gathered, each ps rank's rows
    added; against the reference's ``shard_push_add`` and a loop."""
    from flink_parameter_server_tpu.parallel.collectives import shard_push_add

    rs = _case(grid, "shard_push")
    _same_on_every_rank(rs, "got")
    r = rs[0]
    want = np.zeros((64, 4))
    for i, m in zip(r["ids"].reshape(-1), r["mask"].reshape(-1)):
        if m:
            want[i] += 1.0
    np.testing.assert_array_equal(r["got"], want)
    ref = shard_push_add(jnp.zeros((64, 4)), jnp.asarray(r["ids"]), jnp.ones((2, 3, 4)),
                         jnp.asarray(r["mask"]), mesh=jmesh)
    np.testing.assert_array_equal(r["got"], np.asarray(ref))


def test_generic_update_fn_sharded(grid, jmesh):
    """The custom-update path on the mesh == single device, atol 1e-6 (the
    reference's bar), and == the reference's sharded store."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.utils.initializers import zeros

    def ema(current, combined):
        return 0.5 * current + 0.5 * combined

    ref = ShardedParamStore.create(12, (2,), init_fn=zeros((2,)), update=ema, mesh=jmesh)
    ref = ref.push(jnp.array([0, 3, 0]), jnp.ones((3, 2)) * 4.0).push(jnp.array([3]), jnp.zeros((1, 2)))
    rs = _case(grid, "generic_update")
    _same_on_every_rank(rs, "sharded")
    np.testing.assert_allclose(rs[0]["sharded"], rs[0]["single"], atol=1e-6)
    np.testing.assert_allclose(rs[0]["sharded"], np.asarray(ref.values()), atol=1e-6)


# --- tests/test_pallas_scatter.py ------------------------------------------


def test_shard_push_pallas_impl_matches_xla(grid, jmesh):
    """K1 on each ps block (its plain version here) == the xla arm, and
    == the reference's Pallas arm (interpret mode), rtol 1e-5 atol 1e-5."""
    from flink_parameter_server_tpu.parallel.collectives import shard_push_add

    rs = _case(grid, "shard_push_pallas")
    _same_on_every_rank(rs, "pallas", "xla")
    r = rs[0]
    np.testing.assert_allclose(r["pallas"], r["xla"], rtol=1e-5, atol=1e-5)
    ref = shard_push_add(jnp.zeros((64, 4)), jnp.asarray(r["ids"]), jnp.asarray(r["deltas"]),
                         jnp.asarray(r["mask"]), mesh=jmesh, impl="pallas")
    np.testing.assert_allclose(r["pallas"], np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_store_pallas_impl_sharded_mesh(grid, jmesh):
    """``scatter_impl="pallas"`` on a sharded store == xla, rtol 1e-5 atol
    1e-5 (the reference's bar), the table staying one block a rank."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.utils.initializers import zeros

    rs = _case(grid, "store_pallas_sharded")
    _same_on_every_rank(rs, "pallas", "xla")
    r = rs[0]
    np.testing.assert_allclose(r["pallas"], r["xla"], rtol=1e-5, atol=1e-5)
    ref = ShardedParamStore.create(40, (4,), init_fn=zeros((4,)), mesh=jmesh, scatter_impl="pallas")
    ref = ref.push(jnp.asarray(r["ids"]), jnp.asarray(r["deltas"]))
    np.testing.assert_allclose(r["pallas"], np.asarray(ref.values()), rtol=1e-5, atol=1e-5)
    assert tuple(r["pallas_block_shape"]) == (int(r["block_rows"]), 4)
    assert int(r["block_rows"]) * 2 == ref.table.shape[0]


# --- tests/test_sorted_scatter.py, test_round2_fixes.py --------------------


def test_store_push_parity_sharded(grid, jmesh):
    """xla_sorted == xla on the mesh and == the reference's, rtol 1e-5
    atol 1e-5 (the reference's bar)."""
    from flink_parameter_server_tpu.core import store as store_mod
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.utils.initializers import normal_factor

    rs = _case(grid, "sorted_parity")
    _same_on_every_rank(rs, "xla", "xla_sorted")
    r = rs[0]
    np.testing.assert_allclose(r["xla"], r["xla_sorted"], rtol=1e-5, atol=1e-5)
    ref = ShardedParamStore.create(256, (16,), init_fn=normal_factor(0, (16,)),
                                   scatter_impl="xla_sorted", mesh=jmesh)
    t = store_mod.push(ref.spec, ref.table, jnp.asarray(r["ids"]), jnp.asarray(r["deltas"]))
    np.testing.assert_allclose(r["xla_sorted"], np.asarray(t)[:256], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla_sorted", "pallas"])
def test_sharded_push_of_an_odd_batch_takes_no_fallback(grid, jmesh, impl):
    """The reference warns and falls back to its XLA scatter when a batch
    does not divide by dp; the port's store push takes global lanes, so
    nothing falls back: no warning, the fallback counter stays 0, the
    pallas arm's K1 runs, and the table is the reference's (rtol 1e-6)."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.utils.initializers import normal_factor, ranged_random_factor

    rs = _case(grid, f"no_fallback_{impl}")
    _same_on_every_rank(rs, "after")
    init = normal_factor(0, (2,)) if impl == "xla_sorted" else ranged_random_factor(1, (2,))
    ref = ShardedParamStore.create(16, (2,), init_fn=init, scatter_impl=impl, mesh=jmesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(ref.push(jnp.array([1, 2, 3]), jnp.ones((3, 2))).values())
    for r in rs:
        assert int(r["warnings"]) == 0 and int(r["fallbacks"]) == 0
        assert int(r["k1_calls"]) == (1 if impl == "pallas" else 0)
        # (normal_factor init is rtol 1e-5 across the packages, test_torch_init)
        np.testing.assert_allclose(r["before"], np.asarray(ref.values()), rtol=1e-5)
        np.testing.assert_allclose(r["after"], want, rtol=1e-6)


def test_topk_exact_dense_matches_sharded(grid, jmesh):
    """The dense and the ps-sharded ranking agree bitwise in the port (ids
    and scores), and with the reference's sharded ranking: ids exact,
    scores atol 1e-5 (the reference's bar)."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.models.topk_recommender import query_topk

    rs = _case(grid, "topk_dense_vs_sharded")
    _same_on_every_rank(rs, "i_sh", "s_sh")
    r = rs[0]
    np.testing.assert_array_equal(r["i_ex"], r["i_sh"])
    np.testing.assert_array_equal(r["s_ex"], r["s_sh"])
    sharded = ShardedParamStore.from_values(jnp.asarray(r["vals"]), mesh=jmesh)
    s_ref, i_ref = query_topk(sharded, jnp.asarray(r["vecs"]), jnp.arange(8, dtype=jnp.int32), 10)
    np.testing.assert_array_equal(r["i_sh"], np.asarray(i_ref))
    np.testing.assert_allclose(r["s_sh"], np.asarray(s_ref), atol=1e-5)


def test_topk_sharded_store_parity(grid):
    """Serving on a sharded snapshot: the numpy oracle's ids exactly,
    scores rtol 1e-5 (the reference's bar); a lookup bitwise."""
    rs = _case(grid, "serving_topk")
    _same_on_every_rank(rs, "ids", "scores", "lookup")
    r = rs[0]
    scores = r["uv"][:8] @ r["table"].T
    exp_ids = np.argsort(-scores, axis=1, kind="stable")[:, :7]
    np.testing.assert_array_equal(r["ids"], exp_ids)
    np.testing.assert_allclose(r["scores"], np.take_along_axis(scores, exp_ids, 1), rtol=1e-5)
    np.testing.assert_array_equal(r["lookup"], r["table"][[0, 100, 255]])


# --- tests/test_passive_aggressive.py, test_sketches.py --------------------


def test_pa_sharded_matches_single(grid, jmesh):
    """PA on the mesh == one device and == the reference's sharded run,
    atol 1e-5 (the reference's bar)."""
    from flink_parameter_server_tpu.data.streams import sparse_feature_batches
    from flink_parameter_server_tpu.models.passive_aggressive import transform_binary

    rs = _case(grid, "pa_sharded")
    _same_on_every_rank(rs, "sharded")
    r = rs[0]
    np.testing.assert_allclose(r["sharded"], r["single"], atol=1e-5)
    ref = transform_binary(sparse_feature_batches(r["X"], r["y"], 64, epochs=1), num_features=20,
                           mesh=jmesh, collect_outputs=False)
    np.testing.assert_allclose(r["sharded"], np.asarray(ref.store.values()), atol=1e-5)


def test_count_min_sharded_matches(grid, jmesh):
    """Integer sketch tables: exact, against one device and the reference."""
    from flink_parameter_server_tpu.core.transform import transform_batched
    from flink_parameter_server_tpu.models.sketches import CountMinConfig, CountMinSketch

    rs = _case(grid, "count_min_sharded")
    _same_on_every_rank(rs, "sharded")
    r = rs[0]
    np.testing.assert_array_equal(r["sharded"], r["single"])
    keys = r["keys"]
    batches = [{"key": np.concatenate([keys[s:s + 512], np.zeros(512 - len(keys[s:s + 512]), np.int32)]),
                "mask": np.arange(512) < len(keys[s:s + 512])} for s in range(0, len(keys), 512)]
    sketch = CountMinSketch(CountMinConfig(width=1024, depth=4, seed=1))
    ref = transform_batched(batches, sketch, sketch.make_store(mesh=jmesh), collect_outputs=False)
    np.testing.assert_array_equal(r["sharded"], np.asarray(ref.store.values()))


# --- tests/test_parallel_extras.py ------------------------------------------


def test_multihost_mesh_layout(grid):
    """``make_multihost_mesh(ps=2)`` over four ranks is 2 x 2, ``ps=4`` is
    1 x 4; with two ranks a host, ``ps=4`` would cross hosts and raises;
    each process loads its quarter of a global batch."""
    for rank, r in enumerate(_case(grid, "multihost")):
        assert (int(r["dp"]), int(r["ps"])) == (2, 2)
        assert (int(r["whole_dp"]), int(r["whole_ps"])) == (1, 4)
        assert "must divide the ranks per host" in str(r["refused"])
        assert list(r["slice"]) == [16 * rank, 16 * (rank + 1)]
        assert int(r["initialized"]) == 1 and int(r["rank"]) == rank


def test_multihost_single_process_noop():
    from flink_parameter_server_tpu_torch.parallel.multihost import (
        initialize, process_local_batch_slice)

    assert not torch.distributed.is_initialized()
    assert initialize() is False  # no launcher environment: a no-op
    assert not torch.distributed.is_initialized()
    assert process_local_batch_slice(64) == slice(0, 64)


def test_partitioned_microbatches_aligns_blocks():
    """The port's partitioned stream: every dp block's users in its
    partition, nothing dropped, the same batches as the reference's."""
    from flink_parameter_server_tpu.data.streams import partitioned_microbatches as ref_pm
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import partitioned_microbatches

    data = synthetic_ratings(100, 60, 5000, seed=0)
    dp, batch = 4, 64
    per = batch // dp
    total = 0
    got = list(partitioned_microbatches(data, batch, dp, key="user", capacity=100, shuffle_seed=0))
    want = list(ref_pm(data, batch, dp, key="user", capacity=100, shuffle_seed=0))
    assert len(got) == len(want)
    for b, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(w[k]))
        for p in range(dp):
            users = b["user"][p * per:(p + 1) * per][b["mask"][p * per:(p + 1) * per]]
            assert (users * dp // 100 == p).all()
        total += int(b["mask"].sum())
    assert total == 5000


# --- interop and the public names -------------------------------------------


def test_interop_carries_a_sharded_reference_store(grid):
    """The reference's 2 x 2 sharded table crosses as numpy: each rank
    keeps its ps block of it; values and pulls bitwise the reference's."""
    z = grid["_inputs"]
    rs = _case(grid, "interop")
    _same_on_every_rank(rs, "values", "pulled")
    assert [tuple(r["shape"]) for r in rs] == [z["interop_table"].shape] * 4
    for d in range(2):  # ranks (d, 0) and (d, 1) hold the two ps blocks
        np.testing.assert_array_equal(
            np.concatenate([rs[2 * d]["block"], rs[2 * d + 1]["block"]]), z["interop_table"])
    np.testing.assert_array_equal(rs[0]["values"], z["interop_values"])
    np.testing.assert_array_equal(rs[0]["pulled"], z["interop_pulled"])


def test_public_names():
    """The names tests/test_public_api.py pins for the sharded plane."""
    import importlib

    for mod, names in {
        "parallel.collectives": ["shard_pull", "shard_push_add"],
        "parallel.multihost": ["initialize", "make_multihost_mesh", "process_local_batch_slice"],
        "parallel.mesh": ["make_mesh", "single_device_mesh", "DP_AXIS", "PS_AXIS"],
        "models.matrix_factorization": ["SGDUpdater", "OnlineMatrixFactorization", "MFWorkerLogic",
                                        "ps_online_mf", "make_locality_mf_step"],
        "ops.topk": ["dense_topk", "sharded_topk"],
        "ops.mf_kernel": ["fused_mf_sgd_sharded"],
    }.items():
        m = importlib.import_module(f"flink_parameter_server_tpu_torch.{mod}")
        for name in names:
            assert callable(getattr(m, name)) or isinstance(getattr(m, name), str), (mod, name)
            assert name in m.__all__, (mod, name)
